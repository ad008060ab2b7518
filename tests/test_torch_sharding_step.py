"""The port's train step over a model axis: four gloo ranks as a (data 2,
model 2) mesh, params and optimizer state as DTensors, against
``repro``'s train-step algebra.

The module fixture saves ``repro``'s params and a batch
(``tests/test_torch_distributed.py``'s tiny config) and spawns four CPU
ranks once; each lays the state out by ``state_shardings`` under the
case's rules, takes one step of every case from the same state, and
writes every updated param gathered to its full tensor.  The oracle is
``test_torch_distributed.py``'s, over two groups: ``repro``'s
``loss_fn`` gradient of each group's rows, ``effective_weights``,
``combine_pair`` over the clusters, then ``repro``'s optimizer.  Bound:
``1e-4 * max(scale, 1)``.  Cases: ``tolfl_ring`` and ``tolfl_psum``
without a failure and with a head failure under the replicated-data
rules, ``tolfl_psum`` under ``FSDP_RULES`` (with Adam and a clip that
bites, so the clip's norm must count every shard once), GQA configs
whose q heads are sharded while their kv heads are replicated (one kv
head; 3 kv heads under 6 q heads, a rank's heads spanning groups), and an
MoE config (4 experts over the model axis, top-2, a shared expert) on
the ring (each group's gradient its own rows', aux loss included) and on
the FSDP psum (``repro``'s global-batch step: the rows weighted by their
group's effective weight, the aux loss over every row); and the FSDP
psum at bf16 params, against the port's own step at a model axis of 1.
"""
import dataclasses
import functools
import json
import os
import subprocess
import sys
import textwrap

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch_threads  # noqa: F401  (one torch thread a worker)
from test_torch_distributed import _free_port, _params_npz

from repro.configs import OptimizerConfig as ROptimizerConfig
from repro.configs.base import AttentionConfig, ModelConfig, MoEConfig
from repro.core import aggregation as ragg
from repro.core.failure import effective_weights as r_effective_weights
from repro.core.topology import Topology as RTopology
from repro.models import transformer as RT
from repro.optim.optimizers import apply_updates, make_optimizer

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CFG = ModelConfig(name="tiny", num_layers=2, d_model=64, d_ff=128,
                  vocab_size=256,
                  attention=AttentionConfig(num_heads=4, num_kv_heads=2,
                                            head_dim=16),
                  remat="none", dtype="float32")
#: heads 4, kv heads 1: over model 2 the q heads are sharded and the one
#: kv head is not
GQA = dataclasses.replace(CFG, attention=AttentionConfig(
    num_heads=4, num_kv_heads=1, head_dim=16))
#: heads 6 of 2 a group over 3 kv heads: over model 2 a rank's 3 q heads
#: span two groups (rank 1 holds heads 3-5: kv heads 1, 2, 2), so it
#: picks its kv heads one a q head
GQA6 = dataclasses.replace(CFG, attention=AttentionConfig(
    num_heads=6, num_kv_heads=3, head_dim=16))
MOE = dataclasses.replace(CFG, moe=MoEConfig(
    num_experts=4, num_experts_per_tok=2, capacity_factor=1.0,
    shared_expert=True))
CONFIGS = {"base": CFG, "gqa": GQA, "gqa6": GQA6, "moe": MOE}
SGD = {"name": "sgd", "lr": 0.1, "schedule": "constant", "warmup_steps": 0,
       "grad_clip": 0.0}
#: Adam with an eps that keeps its first step Lipschitz in the gradient
#: (at eps 1e-8 it is the gradient's sign, which rounding flips where a
#: gradient is near 0), and a clip that bites
ADAM = {"name": "adam", "lr": 0.01, "schedule": "constant",
        "warmup_steps": 0, "grad_clip": 0.05, "eps": 1e-3}
B, S, G = 8, 16, 2
ALIVE = {"none": [1., 1.], "head": [0., 1.]}
#: (name, schedule, alive, rules mode, config, optimizer)
CASES = ([(f"{s}_{a}", s, a, "replicated_data", "base", "sgd")
          for s in ("tolfl_ring", "tolfl_psum") for a in ALIVE]
         + [(f"fsdp_psum_{a}", "tolfl_psum", a, "fsdp", "base", "adam")
            for a in ALIVE]
         + [("gqa_ring_none", "tolfl_ring", "none", "replicated_data", "gqa",
             "sgd"),
            ("gqa_fsdp_psum_head", "tolfl_psum", "head", "fsdp", "gqa",
             "sgd"),
            ("gqa6_ring_none", "tolfl_ring", "none", "replicated_data",
             "gqa6", "sgd"),
            ("moe_ring_head", "tolfl_ring", "head", "replicated_data", "moe",
             "sgd"),
            ("moe_fsdp_psum_none", "tolfl_psum", "none", "fsdp", "moe",
             "sgd"),
            ("bf16_fsdp_psum_none", "tolfl_psum", "none", "fsdp", "bf16",
             "adam")])
#: the bf16 case's config: the base one at bf16 params, its params the
#: base ones rounded to bf16 (held to the port's step at a model axis of
#: 1, not to repro's oracle)
BF16 = {"attention": dataclasses.asdict(CFG.attention),
        "moe": dataclasses.asdict(CFG.moe), "param_dtype": "bfloat16",
        "params": "base"}

RANK_SCRIPT = textwrap.dedent("""
    import json, os, sys
    import numpy as np
    import torch
    torch.set_num_threads(1)
    from repro_torch.configs.base import (AttentionConfig, ModelConfig,
                                          MoEConfig, OptimizerConfig,
                                          TolFLConfig)
    from repro_torch.core import distributed as D
    from repro_torch.data.pipeline import shard_batch
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import params as P
    from repro_torch.optim.optimizers import make_optimizer
    from repro_torch.sharding import logical as L

    work = sys.argv[1]
    spec = json.load(open(os.path.join(work, "spec.json")))
    mesh = make_host_mesh(data=2, model=2, device="cpu")
    data = np.load(os.path.join(work, "data.npz"))

    def load(prefix):
        return P.from_numpy_tree(P.tree_from_items(
            (tuple(k[len(prefix) + 1:].split("/")), data[k])
            for k in data.files if k.startswith(prefix + "/")), "cpu")
    host = {"tokens": data["tokens"], "labels": data["labels"]}
    out = {}
    for name, schedule, alive, mode, which, opt in spec["cases"]:
        c = spec["configs"][which]
        cfg = ModelConfig(name="tiny", num_layers=2, d_model=64, d_ff=128,
                          vocab_size=256, remat="none", dtype="float32",
                          attention=AttentionConfig(**c["attention"]),
                          moe=MoEConfig(**c["moe"]),
                          param_dtype=c.get("param_dtype", "float32"))
        ocfg = OptimizerConfig(**spec["opts"][opt])
        rules = L.rules_for(mode)
        params = P.cast_tree(load(c.get("params", which)),
                             getattr(torch, cfg.param_dtype))
        with L.activate_mesh(mesh, rules):
            state = D.shard_tree(
                {"params": params, "opt": make_optimizer(ocfg).init(params),
                 "step": torch.zeros((), dtype=torch.int32)},
                D.state_shardings(mesh, cfg, ocfg, rules))
            step = D.make_train_step(
                cfg, TolFLConfig(num_clusters=2, schedule=schedule), ocfg,
                mesh)
            new, metrics = step(state, shard_batch(host, mesh),
                                torch.tensor(spec["alive"][alive]))
        leaves = P.tree_items(new["params"])
        out[name] = np.concatenate([x.full_tensor().detach().float().numpy()
                                    .ravel() for _, x in leaves])
        trees = [new["params"]] + [getattr(new["opt"], k) for k in
                                   ("mu", "nu") if hasattr(new["opt"], k)]
        out[name + "/dtypes"] = np.asarray(json.dumps(sorted({
            str(x.to_local().dtype) for t in trees
            for _, x in P.tree_items(t)})))
        out[name + "/placements"] = np.asarray(json.dumps(
            {"/".join(p): str(x.placements) for p, x in leaves}))
        out[name + "/loss"] = np.asarray(float(metrics["loss"]))
    np.savez(os.path.join(work, f"rank{mesh.rank}.npz"), **out)
""")


def _batch():
    rng = np.random.default_rng(0)
    return (rng.integers(0, 256, (B, S)).astype(np.int32),
            rng.integers(0, 256, (B, S)).astype(np.int32))


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    work = tmp_path_factory.mktemp("gloo_model_axis")
    params = {w: RT.init_params(jax.random.PRNGKey(3), c)[0]
              for w, c in CONFIGS.items()}
    tokens, labels = _batch()
    np.savez(work / "data.npz", tokens=tokens, labels=labels,
             **{k: v for w in CONFIGS
                for k, v in _params_npz(f"{w}/", params[w]).items()})
    spec = {"cases": CASES, "alive": ALIVE, "opts": {"sgd": SGD,
                                                     "adam": ADAM},
            "configs": dict({w: {"attention": dataclasses.asdict(c.attention),
                                 "moe": dataclasses.asdict(c.moe)}
                             for w, c in CONFIGS.items()}, bf16=BF16)}
    (work / "spec.json").write_text(json.dumps(spec))
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"),
               MASTER_ADDR="localhost", MASTER_PORT=str(_free_port()),
               WORLD_SIZE="4", OMP_NUM_THREADS="1")
    procs = [subprocess.Popen(
        [sys.executable, "-c", RANK_SCRIPT, str(work)],
        env=dict(env, RANK=str(r), LOCAL_RANK=str(r)),
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for r in range(4)]
    try:
        errs = [p.communicate(timeout=240)[1] for p in procs]
    finally:
        for p in procs:
            p.kill()
    for p, err in zip(procs, errs):
        assert p.returncode == 0, err[-4000:]
    return {"params": params, "tokens": tokens, "labels": labels,
            "ranks": [dict(np.load(work / f"rank{r}.npz"))
                      for r in range(4)]}


def _flat(tree) -> np.ndarray:
    return np.concatenate([np.asarray(x, np.float32).ravel()
                           for x in jax.tree.leaves(tree)])


@functools.lru_cache(maxsize=None)
def _grad_fn(which, masked):
    """repro's loss_fn gradient for a config, jitted once: of (params,
    tokens, labels) or, ``masked``, also of a row mask."""
    cfg = CONFIGS[which]
    if masked:
        return jax.jit(jax.grad(lambda p, t, l, m: RT.loss_fn(
            p, cfg, {"tokens": t, "labels": l, "mask": m})[0]))
    return jax.jit(jax.grad(
        lambda p, t, l: RT.loss_fn(p, cfg, {"tokens": t, "labels": l})[0]))


def _oracle(world, which, alive, opt, schedule="tolfl_ring"):
    """repro's algebra over two groups of four rows: each group's
    gradient, the per-cluster weighted mean, combine_pair over the heads,
    has_update, then repro's optimizer.  For an MoE config under
    tolfl_psum, repro's psum step: one gradient of the global batch's
    loss, each row weighted by its group's effective weight (the aux
    loss then takes every row)."""
    cfg, params = CONFIGS[which], world["params"][which]
    o = make_optimizer(ROptimizerConfig(**(SGD if opt == "sgd" else ADAM)))
    if schedule == "tolfl_psum" and cfg.moe.num_experts:
        w = r_effective_weights(jnp.asarray(ALIVE[alive]), RTopology(G, 2))
        mask = jnp.broadcast_to(jnp.repeat(w, B // G)[:, None], (B, S))
        g = _grad_fn(which, True)(params, world["tokens"], world["labels"],
                                  mask)
        upd, _ = o.update(g, o.init(params), params)
        return _flat(apply_updates(params, upd))
    rows = B // G
    grads = [_grad_fn(which, False)(
        params, world["tokens"][g * rows:(g + 1) * rows],
        world["labels"][g * rows:(g + 1) * rows]) for g in range(G)]
    topo = RTopology(G, 2)
    ns = r_effective_weights(jnp.asarray(ALIVE[alive]), topo) * (rows * S)
    carry = None
    for members in topo.clusters:
        den = sum(ns[i] for i in members)
        r = [ns[i] / jnp.maximum(den, 1e-30) for i in members]
        g_c = jax.tree.map(lambda *gs: sum(ri * gi for ri, gi in zip(r, gs)),
                           *[grads[i] for i in members])
        carry = (den, g_c) if carry is None else ragg.combine_pair(
            carry[0], carry[1], den, g_c)
    n_tot, g = carry
    g = jax.tree.map(lambda x: x * (n_tot > 0), g)
    upd, _ = o.update(g, o.init(params), params)
    return _flat(apply_updates(params, upd))


def _close(a, b):
    scale = float(np.max(np.abs(b)))
    err = float(np.max(np.abs(a - b)))
    assert err < 1e-4 * max(scale, 1.0), (err, scale)


@pytest.mark.parametrize("name,schedule,alive,mode,which,opt",
                         [c for c in CASES if c[4] != "bf16"])
def test_model_axis_step_equals_repro_oracle(world, name, schedule, alive,
                                             mode, which, opt):
    _close(world["ranks"][0][name], _oracle(world, which, alive, opt,
                                            schedule))


@pytest.mark.parametrize("name", [c[0] for c in CASES])
def test_model_ranks_of_a_group_hold_the_same_params(world, name):
    """Ranks 0, 1 (group 0) and 2, 3 (group 1) differ only in their model
    index: gathered, their params are the same; and after the final
    all-reduce every group's are too."""
    ranks = world["ranks"]
    for r in ranks[1:]:
        np.testing.assert_array_equal(r[name], ranks[0][name])


def test_layouts_follow_the_rules(world):
    """Under the replicated-data rules the q kernel (layers, embed,
    heads) is sharded over model alone; under FSDP over data on embed
    too; the GQA config's k kernel (16 columns) over model."""
    lay = {c[0]: json.loads(str(world["ranks"][0][c[0] + "/placements"]))
           for c in CASES}
    q = "units/l0/mix/q/w"
    assert lay["tolfl_ring_none"][q] == "(Replicate(), Shard(dim=2))"
    assert lay["fsdp_psum_none"][q] == "(Shard(dim=1), Shard(dim=2))"
    assert lay["gqa_ring_none"]["units/l0/mix/k/w"] == \
        "(Replicate(), Shard(dim=2))"


def test_failure_changes_the_update(world):
    out = world["ranks"][0]
    assert np.max(np.abs(out["tolfl_ring_none"]
                         - out["tolfl_ring_head"])) > 1e-8


def _ulp(x):
    """One bf16 ulp of each |x|."""
    m = np.maximum(np.abs(x), np.float32(2.0 ** -126))
    return np.exp2(np.floor(np.log2(m)) - 7).astype(np.float32)


def test_bf16_fsdp_step_equals_model_axis_one(world):
    """The FSDP psum step at bf16 params (data 2, model 2: storage sharded
    over data and model, gathered in bf16 for compute) against the port's
    psum step at a model axis of 1 on one rank over the whole batch, from
    the same bf16 params: params and Adam's moments stay bf16 DTensors,
    and each element's update is within one ulp of its param + 2e-2 of
    its leaf's largest update (bf16 sums over two ranks and two model
    shards against one rank's; measured 1 ulp + 0.82%), most elements
    moving."""
    import torch
    from repro_torch.configs.base import OptimizerConfig, TolFLConfig
    from repro_torch.core import distributed as D
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import params as P
    from repro_torch.configs.base import (AttentionConfig as TA,
                                          ModelConfig as TM)
    out = world["ranks"][0]
    assert json.loads(str(out["bf16_fsdp_psum_none/dtypes"])) == [
        "torch.bfloat16"]
    cfg = TM(name="tiny", num_layers=2, d_model=64, d_ff=128,
             vocab_size=256, remat="none", dtype="float32",
             param_dtype="bfloat16", attention=TA(**BF16["attention"]))
    ocfg = OptimizerConfig(**ADAM)
    params = P.cast_tree(P.from_numpy_tree(jax.tree.map(
        np.asarray, world["params"]["base"]), "cpu"), torch.bfloat16)
    step = D.make_train_step(cfg, TolFLConfig(num_clusters=1,
                                              schedule="tolfl_psum"),
                             ocfg, make_host_mesh(device="cpu"))
    new, _ = step({"params": params, "opt": D.make_optimizer(ocfg).init(
        params), "step": torch.zeros((), dtype=torch.int32)},
        {"tokens": torch.from_numpy(world["tokens"]).long(),
         "labels": torch.from_numpy(world["labels"]).long()},
        torch.ones(1))
    p0 = np.concatenate([x.float().numpy().ravel()
                         for _, x in P.tree_items(params)])
    got = out["bf16_fsdp_psum_none"]
    assert float(np.mean(got != p0)) > 0.5
    off = 0
    for (path, x), (_, w) in zip(P.tree_items(params),
                                 P.tree_items(new["params"])):
        w = w.float().numpy().ravel()
        g = got[off:off + w.size]
        p = p0[off:off + w.size]
        off += w.size
        scale = float(np.max(np.abs(w - p)))
        excess = np.abs((g - p) - (w - p)) - _ulp(w)
        assert float(np.max(excess)) <= 2e-2 * scale, (path, scale)
