"""The port's mesh engine (``repro_torch.core.distributed``) on four gloo
ranks, against ``repro``'s train-step algebra.

``repro``'s own mesh engine cannot be the oracle (it raises under this
jax), so the oracle is built from the pieces of it that run outside a
mesh: ``repro``'s ``loss_fn`` gradients of each group's rows,
``effective_weights``, ``combine_pair`` over the clusters and heads, and
its SGD update.  The module fixture saves ``repro``'s params and a batch
(``tests/test_distributed.py``'s tiny config) and spawns four CPU ranks
once, each running one step of every case from the same state; every
case's updated params come back as numpy.  Bounds: ring == psum and both
== the oracle within ``1e-4 * max(scale, 1)`` (``test_distributed.py``'s
bound: the schedules differ by rounding, not by algebra); the perf
levers as ``tests/test_grad_comm.py`` bounds them.

A second fixture runs the same config with an MoE layer (4 experts,
top-2, capacity 1, without and with a shared expert, and with it under
remat="full") on four ranks.
``tolfl_psum`` is held to ``repro``'s psum step written out: ``loss_fn``
and ``jax.grad`` over the whole global batch (at microbatches m > 1 over
each global block, weighted by its mask mass), whose aux loss takes the
load-balance means over every row, dead groups' rows included; the ring
to the per-group oracle, each group's aux its own rows'.
"""
import dataclasses
import functools
import json
import os
import socket
import subprocess
import sys
import textwrap

import jax
import jax.numpy as jnp
import numpy as np
import pytest

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
OCFG = ROptimizerConfig(name="sgd", lr=0.1, schedule="constant",
                        warmup_steps=0, grad_clip=0.0)
B, S, G = 8, 16, 4
ALIVE = {"none": [1., 1., 1., 1.], "client": [1., 0., 1., 1.],
         "head": [0., 1., 1., 1.]}
#: (name, schedule, alive, TolFLConfig extras)
CASES = ([(f"{s}_{a}", s, a, {}) for s in ("tolfl_ring", "tolfl_psum")
          for a in ALIVE]
         + [("ring_bf16", "tolfl_ring", "none",
             {"grad_sync_dtype": "bfloat16"}),
            ("ring_mb2", "tolfl_ring", "none", {"microbatches": 2}),
            ("psum_mb2", "tolfl_psum", "none", {"microbatches": 2}),
            ("psum_mb4", "tolfl_psum", "none", {"microbatches": 4}),
            ("psum_cast", "tolfl_psum", "none",
             {"param_cast_dtype": "bfloat16"}),
            ("ring_e2", "tolfl_ring", "none", {"local_epochs": 2}),
            ("ring_e2_head", "tolfl_ring", "head", {"local_epochs": 2})])

#: the MoE fixture's configs: MoEConfig fields by name, and "remat" where
#: the config is not remat="none" ("moe_remat" trains through the
#: checkpointed unit, as Llama-4 Scout and Maverick do)
MOE = {"moe": {"num_experts": 4, "num_experts_per_tok": 2,
               "capacity_factor": 1.0},
       "moe_shared": {"num_experts": 4, "num_experts_per_tok": 2,
                      "capacity_factor": 1.0, "shared_expert": True},
       "moe_remat": {"num_experts": 4, "num_experts_per_tok": 2,
                     "capacity_factor": 1.0, "shared_expert": True,
                     "remat": "full"}}
#: the configs that also run mb 8 and the ring
MOE_ALL = ("moe", "moe_shared")
#: (name, schedule, alive, TolFLConfig extras, config): mb 8 puts two
#: one-row blocks on each rank
MOE_CASES = ([(f"{c}_psum_{a}_mb{m}", "tolfl_psum", a, {"microbatches": m}, c)
              for c in MOE for a in ALIVE for m in (1, 2)]
             + [(f"{c}_psum_none_mb8", "tolfl_psum", "none",
                 {"microbatches": 8}, c) for c in MOE_ALL]
             + [(f"{c}_ring_{a}", "tolfl_ring", a, {}, c)
                for c in MOE_ALL for a in ALIVE])

RANK_SCRIPT = textwrap.dedent("""
    import json, os, sys
    import numpy as np
    import torch
    torch.set_num_threads(1)
    from repro_torch.configs.base import (AttentionConfig, ModelConfig,
                                          MoEConfig, OptimizerConfig,
                                          TolFLConfig)
    from repro_torch.core import distributed as D
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import params as P
    from repro_torch.optim.optimizers import make_optimizer

    work = sys.argv[1]
    spec = json.load(open(os.path.join(work, "spec.json")))
    mesh = make_host_mesh(data=4, model=1, device="cpu")

    def model(moe):
        moe = dict(moe or {})
        remat = moe.pop("remat", "none")
        return ModelConfig(name="tiny", num_layers=2, d_model=64, d_ff=128,
                           vocab_size=256,
                           attention=AttentionConfig(num_heads=4,
                                                     num_kv_heads=2,
                                                     head_dim=16),
                           remat=remat, dtype="float32",
                           **({"moe": MoEConfig(**moe)} if moe else {}))
    ocfg = OptimizerConfig(name="sgd", lr=0.1, schedule="constant",
                           warmup_steps=0, grad_clip=0.0)
    data = np.load(os.path.join(work, "data.npz"))

    def load(prefix):
        return P.from_numpy_tree(P.tree_from_items(
            (tuple(k[len(prefix):].split("/")), data[k])
            for k in data.files if k.startswith(prefix)), "cpu")
    rows = slice(mesh.group * 2, mesh.group * 2 + 2)
    batch = {"tokens": torch.from_numpy(data["tokens"][rows]).long(),
             "labels": torch.from_numpy(data["labels"][rows]).long()}
    out = {}
    for name, schedule, alive, extra, *which in spec["cases"]:
        cfg = model(spec["moe"][which[0]] if which else None)
        params = load(f"{which[0]}/" if which else "p/")
        tolfl = TolFLConfig(num_clusters=2, schedule=schedule, **extra)
        step = D.make_train_step(cfg, tolfl, ocfg, mesh)
        state = {"params": params,
                 "opt": make_optimizer(ocfg).init(params),
                 "step": torch.zeros((), dtype=torch.int32)}
        new, metrics = step(state, batch,
                            torch.tensor(spec["alive"][alive]))
        out[name] = np.concatenate([x.detach().numpy().ravel() for _, x in
                                    P.tree_items(new["params"])])
        out[name + "/loss"] = np.asarray(float(metrics["loss"]))
        if "moe_aux" in metrics:
            out[name + "/moe_aux"] = np.asarray(float(metrics["moe_aux"]))
    np.savez(os.path.join(work, f"rank{mesh.rank}.npz"), **out)
""")


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _flat(tree) -> np.ndarray:
    return np.concatenate([np.asarray(x, np.float32).ravel()
                           for x in jax.tree.leaves(tree)])


def _params_npz(prefix, params):
    return {prefix + "/".join(k.key for k in path): np.asarray(x)
            for path, x in jax.tree_util.tree_flatten_with_path(params)[0]}


def _batch():
    rng = np.random.default_rng(0)
    tokens = rng.integers(0, 256, (B, S)).astype(np.int32)
    labels = rng.integers(0, 256, (B, S)).astype(np.int32)
    return tokens, labels


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    work = tmp_path_factory.mktemp("gloo")
    params, _ = RT.init_params(jax.random.PRNGKey(0), CFG)
    tokens, labels = _batch()
    np.savez(work / "data.npz", tokens=tokens, labels=labels,
             **_params_npz("p/", params))
    ranks = _run_ranks(work, {"cases": CASES, "alive": ALIVE})
    return {"params": params, "tokens": tokens, "labels": labels,
            "ranks": ranks, "out": ranks[0]}


def _moe_cfg(which):
    moe = dict(MOE[which])
    remat = moe.pop("remat", CFG.remat)
    return dataclasses.replace(CFG, remat=remat, moe=MoEConfig(**moe))


@pytest.fixture(scope="module")
def moe_world(tmp_path_factory):
    work = tmp_path_factory.mktemp("gloo_moe")
    params = {c: RT.init_params(jax.random.PRNGKey(1), _moe_cfg(c))[0]
              for c in MOE}
    tokens, labels = _batch()
    np.savez(work / "data.npz", tokens=tokens, labels=labels,
             **{k: v for c in MOE for k, v in
                _params_npz(f"{c}/", params[c]).items()})
    ranks = _run_ranks(work, {"cases": MOE_CASES, "alive": ALIVE,
                              "moe": MOE})
    return {"params": params, "tokens": tokens, "labels": labels,
            "ranks": ranks, "out": ranks[0]}


def _run_ranks(work, spec, script=RANK_SCRIPT):
    """Four gloo ranks of ``script`` over ``spec``'s cases; each rank's
    outputs."""
    (work / "spec.json").write_text(json.dumps(spec))
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"),
               MASTER_ADDR="localhost", MASTER_PORT=str(_free_port()),
               WORLD_SIZE="4", OMP_NUM_THREADS="1")
    procs = [subprocess.Popen(
        [sys.executable, "-c", script, str(work)],
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
    return [dict(np.load(work / f"rank{r}.npz")) for r in range(4)]


def _group_grads(params, tokens, labels, local_epochs=1, cfg=CFG,
                 ocfg=OCFG):
    """Each group's gradient of its own rows (repro's loss_fn), as the
    ring computes it: with local_epochs > 1 the (p - p_end) / lr
    pseudo-gradient of that many SGD steps, in float32 (repro's ring
    widens p - p_end of a bf16 leaf before the division)."""
    vg = jax.jit(jax.value_and_grad(
        lambda p, t, l: RT.loss_fn(p, cfg, {"tokens": t, "labels": l})[0]))
    out = []
    for g in range(G):
        t, l = tokens[2 * g:2 * g + 2], labels[2 * g:2 * g + 2]
        p = params
        for _ in range(local_epochs):
            _, gr = vg(p, t, l)
            p = jax.tree.map(lambda a, b: a - ocfg.lr * b.astype(a.dtype),
                             p, gr)
        out.append(jax.tree.map(
            lambda a, b: (a - b).astype(jnp.float32) / ocfg.lr, params, p)
                   if local_epochs > 1 else vg(params, t, l)[1])
    return out


def _oracle(world, alive, local_epochs=1, cfg=CFG, params=None, ocfg=OCFG):
    """repro's algebra: per-cluster weighted mean, the chain's
    combine_pair over the two cluster heads, has_update, SGD."""
    params = world["params"] if params is None else params
    grads = _group_grads(params, world["tokens"], world["labels"],
                         local_epochs, cfg, ocfg)
    topo = RTopology(G, 2)
    w = r_effective_weights(jnp.asarray(alive), topo)
    ns = w * (2 * S)
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
    opt = make_optimizer(ocfg)
    upd, _ = opt.update(g, opt.init(params), params)
    return _flat(apply_updates(params, upd))


def _close(a, b):
    scale = float(np.max(np.abs(b)))
    err = float(np.max(np.abs(a - b)))
    assert err < 1e-4 * max(scale, 1.0), (err, scale)


@pytest.mark.parametrize("alive", list(ALIVE))
def test_ring_equals_psum(world, alive):
    out = world["out"]
    _close(out[f"tolfl_ring_{alive}"], out[f"tolfl_psum_{alive}"])


@pytest.mark.parametrize("schedule", ["tolfl_ring", "tolfl_psum"])
@pytest.mark.parametrize("alive", list(ALIVE))
def test_schedule_equals_repro_oracle(world, schedule, alive):
    _close(world["out"][f"{schedule}_{alive}"],
           _oracle(world, ALIVE[alive]))


def test_ranks_agree(world):
    """Every rank ends the step with the same params, bit for bit."""
    for r in world["ranks"][1:]:
        for name, _, _, _ in CASES:
            np.testing.assert_array_equal(r[name], world["out"][name])


def test_head_failure_weights():
    """The port's effective_weights: a dead head zeroes its cluster."""
    import torch
    from repro_torch.core.failure import effective_weights
    from repro_torch.core.topology import Topology
    w = effective_weights(torch.tensor([0., 1., 1., 1.]), Topology(4, 2))
    assert w.tolist() == [0.0, 0.0, 1.0, 1.0]
    ref = r_effective_weights(jnp.asarray([0., 1., 1., 1.]), RTopology(4, 2))
    assert np.asarray(ref).tolist() == w.tolist()


def test_failure_changes_update(world):
    out = world["out"]
    assert np.max(np.abs(out["tolfl_ring_none"]
                         - out["tolfl_ring_head"])) > 1e-8


def _rel(a, b):
    return float(np.max(np.abs(a - b)) / (np.max(np.abs(b)) + 1e-12))


def test_bf16_grad_sync_close(world):
    """bf16 carried point to point over gloo: within a few bf16 rounding
    steps of the f32 sync (test_grad_comm.py's bound)."""
    out = world["out"]
    assert _rel(out["ring_bf16"], out["tolfl_ring_none"]) < 0.05
    assert not np.array_equal(out["ring_bf16"], out["tolfl_ring_none"])


@pytest.mark.parametrize("case,base", [("ring_mb2", "tolfl_ring_none"),
                                       ("psum_mb2", "tolfl_psum_none"),
                                       ("psum_mb4", "tolfl_psum_none")])
def test_microbatch_accumulation_matches(world, case, base):
    assert _rel(world["out"][case], world["out"][base]) < 1e-4


def test_param_cast_close(world):
    out = world["out"]
    assert _rel(out["psum_cast"], out["tolfl_psum_none"]) < 0.05


@pytest.mark.parametrize("case,alive", [("ring_e2", "none"),
                                        ("ring_e2_head", "head")])
def test_local_epochs_pseudo_gradient(world, case, alive):
    """local_epochs = 2: the (p - p_end) / lr pseudo-gradient of two local
    SGD steps, aggregated as a gradient."""
    _close(world["out"][case], _oracle(world, ALIVE[alive], local_epochs=2))


# ---------------------------------------------------------------------------
# MoE: the aux loss of a batch spread over ranks
# ---------------------------------------------------------------------------
@functools.lru_cache(maxsize=None)
def _moe_value_and_grad(which):
    cfg = _moe_cfg(which)
    return jax.jit(jax.value_and_grad(
        lambda p, t, l, m: RT.loss_fn(p, cfg, {"tokens": t, "labels": l,
                                               "mask": m}), has_aux=True))


_PSUM_ORACLE = {}


def _psum_oracle(moe_world, which, alive, mb):
    """repro's make_psum_train_step written out: the global batch's rows
    carry their group's effective weight as the mask; loss_fn and
    jax.grad over the whole batch (mb 1) or over each global block,
    weighted by its mask mass (mb > 1); SGD.  Returns (params after,
    loss, the reported moe_aux: the last block's)."""
    if (which, alive, mb) in _PSUM_ORACLE:
        return _PSUM_ORACLE[which, alive, mb]
    params = moe_world["params"][which]
    w = r_effective_weights(jnp.asarray(ALIVE[alive]), RTopology(G, 2))
    mask = jnp.broadcast_to(jnp.repeat(w, B // G)[:, None], (B, S))
    vg = _moe_value_and_grad(which)
    rows = B // mb
    g_sum, l_sum, w_sum, aux = None, 0.0, 0.0, None
    for i in range(mb):
        blk = slice(i * rows, (i + 1) * rows)
        (lv, mets), g = vg(params, jnp.asarray(moe_world["tokens"][blk]),
                           jnp.asarray(moe_world["labels"][blk]), mask[blk])
        wi = jnp.sum(mask[blk]) if mb > 1 else 1.0
        g = jax.tree.map(lambda x: x * wi, g)
        g_sum = g if g_sum is None else jax.tree.map(jnp.add, g_sum, g)
        l_sum, w_sum, aux = l_sum + lv * wi, w_sum + wi, mets["moe_aux"]
    g = jax.tree.map(lambda x: x / jnp.maximum(w_sum, 1e-30), g_sum)
    opt = make_optimizer(OCFG)
    upd, _ = opt.update(g, opt.init(params), params)
    _PSUM_ORACLE[which, alive, mb] = (
        _flat(apply_updates(params, upd)),
        float(l_sum / jnp.maximum(w_sum, 1e-30)), float(aux))
    return _PSUM_ORACLE[which, alive, mb]


MOE_PSUM = [(c, a, m) for c in MOE for a in ALIVE for m in (1, 2)] + [
    (c, "none", 8) for c in MOE_ALL]


@pytest.mark.parametrize("which,alive,mb", MOE_PSUM)
def test_moe_psum_equals_repro_global_batch(moe_world, which, alive, mb):
    """tolfl_psum on an MoE config over four ranks: the updated params and
    the loss are repro's global-batch step's (aux over every row of the
    batch or block), under every alive mask and microbatch count."""
    want, loss, _ = _psum_oracle(moe_world, which, alive, mb)
    name = f"{which}_psum_{alive}_mb{mb}"
    _close(moe_world["out"][name], want)
    np.testing.assert_allclose(moe_world["out"][name + "/loss"], loss,
                               rtol=1e-5)


@pytest.mark.parametrize("which,alive,mb", MOE_PSUM)
def test_moe_psum_reports_the_global_aux(moe_world, which, alive, mb):
    """The reported moe_aux is repro's: the global batch's, or the last
    global block's at mb > 1; no rank's own."""
    _, _, aux = _psum_oracle(moe_world, which, alive, mb)
    assert aux > 0
    for r in moe_world["ranks"]:
        np.testing.assert_allclose(r[f"{which}_psum_{alive}_mb{mb}/moe_aux"],
                                   aux, rtol=1e-5)


@pytest.mark.parametrize("which", MOE_ALL)
@pytest.mark.parametrize("alive", list(ALIVE))
def test_moe_ring_equals_per_group_oracle(moe_world, which, alive):
    """The ring on an MoE config: each group's gradient takes its own
    rows' aux loss, as repro's ring does, so the per-group oracle holds."""
    _close(moe_world["out"][f"{which}_ring_{alive}"],
           _oracle(moe_world, ALIVE[alive], cfg=_moe_cfg(which),
                   params=moe_world["params"][which]))


def test_moe_ranks_agree(moe_world):
    """Every rank ends each MoE step with the same params, bit for bit."""
    for r in moe_world["ranks"][1:]:
        for name, *_ in MOE_CASES:
            np.testing.assert_array_equal(r[name], moe_world["out"][name])
