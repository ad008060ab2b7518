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
"""
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
from repro.configs.base import AttentionConfig, ModelConfig
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

RANK_SCRIPT = textwrap.dedent("""
    import json, os, sys
    import numpy as np
    import torch
    torch.set_num_threads(1)
    from repro_torch.configs.base import (AttentionConfig, ModelConfig,
                                          OptimizerConfig, TolFLConfig)
    from repro_torch.core import distributed as D
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import params as P
    from repro_torch.optim.optimizers import make_optimizer

    work = sys.argv[1]
    spec = json.load(open(os.path.join(work, "spec.json")))
    mesh = make_host_mesh(data=4, model=1, device="cpu")
    cfg = ModelConfig(name="tiny", num_layers=2, d_model=64, d_ff=128,
                      vocab_size=256,
                      attention=AttentionConfig(num_heads=4, num_kv_heads=2,
                                                head_dim=16),
                      remat="none", dtype="float32")
    ocfg = OptimizerConfig(name="sgd", lr=0.1, schedule="constant",
                           warmup_steps=0, grad_clip=0.0)
    data = np.load(os.path.join(work, "data.npz"))
    flat = {k: data[k] for k in data.files if k.startswith("p/")}
    params = P.from_numpy_tree(
        P.tree_from_items((tuple(k[2:].split("/")), v)
                          for k, v in flat.items()), "cpu")
    rows = slice(mesh.group * 2, mesh.group * 2 + 2)
    batch = {"tokens": torch.from_numpy(data["tokens"][rows]).long(),
             "labels": torch.from_numpy(data["labels"][rows]).long()}
    out = {}
    for name, schedule, alive, extra in spec["cases"]:
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
    np.savez(os.path.join(work, f"rank{mesh.rank}.npz"), **out)
""")


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _flat(tree) -> np.ndarray:
    return np.concatenate([np.asarray(x, np.float32).ravel()
                           for x in jax.tree.leaves(tree)])


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    work = tmp_path_factory.mktemp("gloo")
    params, _ = RT.init_params(jax.random.PRNGKey(0), CFG)
    rng = np.random.default_rng(0)
    tokens = rng.integers(0, 256, (B, S)).astype(np.int32)
    labels = rng.integers(0, 256, (B, S)).astype(np.int32)
    flat = {"p/" + "/".join(k.key for k in path): np.asarray(x)
            for path, x in jax.tree_util.tree_flatten_with_path(params)[0]}
    np.savez(work / "data.npz", tokens=tokens, labels=labels, **flat)
    (work / "spec.json").write_text(json.dumps(
        {"cases": CASES, "alive": ALIVE}))
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
    ranks = [dict(np.load(work / f"rank{r}.npz")) for r in range(4)]
    return {"params": params, "tokens": tokens, "labels": labels,
            "ranks": ranks, "out": ranks[0]}


def _group_grads(params, tokens, labels, local_epochs=1):
    """Each group's gradient of its own rows (repro's loss_fn), as the
    ring computes it: with local_epochs > 1 the (p - p_end) / lr
    pseudo-gradient of that many SGD steps."""
    vg = jax.jit(jax.value_and_grad(
        lambda p, t, l: RT.loss_fn(p, CFG, {"tokens": t, "labels": l})[0]))
    out = []
    for g in range(G):
        t, l = tokens[2 * g:2 * g + 2], labels[2 * g:2 * g + 2]
        p = params
        for _ in range(local_epochs):
            _, gr = vg(p, t, l)
            p = jax.tree.map(lambda a, b: a - OCFG.lr * b, p, gr)
        out.append(jax.tree.map(lambda a, b: (a - b) / OCFG.lr, params, p)
                   if local_epochs > 1 else vg(params, t, l)[1])
    return out


def _oracle(world, alive, local_epochs=1):
    """repro's algebra: per-cluster weighted mean, the chain's
    combine_pair over the two cluster heads, has_update, SGD."""
    params = world["params"]
    grads = _group_grads(params, world["tokens"], world["labels"],
                         local_epochs)
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
    opt = make_optimizer(OCFG)
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
