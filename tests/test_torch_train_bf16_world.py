"""The port's train steps at bf16 params on four gloo ranks, against
``repro``'s train-step algebra (``test_torch_distributed.py``'s
``_oracle``, built at bf16 params).

The config is that file's tiny one with Qwen3's qk-norm, at
``param_dtype="bfloat16"``: a mixed tree, its qk-norm scales float32 and
every other leaf bf16, as ``repro`` builds it.  The module fixture saves
``repro``'s params (a bf16 leaf as an int16 view of its bits: numpy has
no bf16) and a batch, and spawns four CPU ranks once; each rank runs one
step of every case from the same state and writes its params widened to
float32 (exact for bf16), every collective's dtype and size, and the
dtypes the optimizer got.

At the oracle's lr of 0.1 most bf16 updates are under half an ulp and
round away, so the cases run SGD at ``LR``, where most elements move
(asserted); the widened update p_new - p_old is compared.  The oracle
reduces in float32, the port in bf16 (as ``repro``'s psum of a bf16
leaf): each element's update within ``ULPS`` ulps of its param plus
``UPD_TOL`` of its leaf's largest update.
"""
import dataclasses
import json

import jax
import numpy as np
import pytest
import torch_threads  # noqa: F401  (one torch thread a worker)
from test_torch_distributed import CFG, _oracle, _run_ranks

from repro.configs import OptimizerConfig as ROptimizerConfig
from repro.configs.base import AttentionConfig
from repro.models import transformer as RT

BCFG = dataclasses.replace(
    CFG, param_dtype="bfloat16",
    attention=AttentionConfig(num_heads=4, num_kv_heads=2, head_dim=16,
                              qk_norm=True))
LR = 10.0
OCFG = ROptimizerConfig(name="sgd", lr=LR, schedule="constant",
                        warmup_steps=0, grad_clip=0.0)
B, S = 8, 16
ALIVE = {"none": [1., 1., 1., 1.], "client": [1., 0., 1., 1.],
         "head": [0., 1., 1., 1.]}
#: (name, schedule, alive, TolFLConfig extras)
CASES = ([(f"ring_{a}", "tolfl_ring", a, {}) for a in ALIVE]
         + [("psum_mb1", "tolfl_psum", "none", {}),
            ("psum_mb2", "tolfl_psum", "none", {"microbatches": 2}),
            ("ring_sync", "tolfl_ring", "none",
             {"grad_sync_dtype": "bfloat16"}),
            ("ring_e2", "tolfl_ring", "none", {"local_epochs": 2})])
#: the widened update's bound: ULPS ulps of the new param (both sides
#: round p + u to bf16) + UPD_TOL x the leaf's largest |update| (the
#: port's bf16 reductions against the oracle's float32 ones); measured
#: at most 1 ulp + 0.83% (ring under a client failure), 98-99.7% of the
#: elements moved
ULPS, UPD_TOL = 1, 1.6e-2

RANK_SCRIPT = r"""
import json, os, sys
import numpy as np
import torch
import torch.distributed as dist
torch.set_num_threads(1)
from repro_torch.configs.base import (AttentionConfig, ModelConfig,
                                      OptimizerConfig, TolFLConfig)
from repro_torch.core import distributed as D
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.models import params as P

work = sys.argv[1]
spec = json.load(open(os.path.join(work, "spec.json")))
mesh = make_host_mesh(data=4, model=1, device="cpu")
cfg = ModelConfig(name="tiny", num_layers=2, d_model=64, d_ff=128,
                  vocab_size=256, remat="none", dtype="float32",
                  param_dtype="bfloat16",
                  attention=AttentionConfig(num_heads=4, num_kv_heads=2,
                                            head_dim=16, qk_norm=True))
ocfg = OptimizerConfig(**spec["ocfg"])
data = np.load(os.path.join(work, "data.npz"))
leaves = []
for k in data.files:
    if k.startswith("f32/"):
        leaves.append((tuple(k[4:].split("/")), torch.from_numpy(data[k])))
    elif k.startswith("b16/"):
        leaves.append((tuple(k[4:].split("/")),
                       torch.from_numpy(data[k]).view(torch.bfloat16)))
params = P.tree_from_items(leaves)
rows = slice(mesh.group * 2, mesh.group * 2 + 2)
batch = {"tokens": torch.from_numpy(data["tokens"][rows]).long(),
         "labels": torch.from_numpy(data["labels"][rows]).long()}

sent = []
for name in ("all_reduce", "send"):
    def spy(buf, *a, _f=getattr(dist, name), _n=name, **kw):
        sent.append([_n, str(buf.dtype).split(".")[-1], buf.numel()])
        return _f(buf, *a, **kw)
    setattr(dist, name, spy)
got = []
make = D.make_optimizer
def spy_opt(*a, **kw):
    opt = make(*a, **kw)
    def update(grads, state, p=None):
        got.append(sorted({str(g.dtype).split(".")[-1]
                           for _, g in P.tree_items(grads)}))
        return opt.update(grads, state, p)
    return opt._replace(update=update)
D.make_optimizer = spy_opt

out = {}
for name, schedule, alive, extra in spec["cases"]:
    step = D.make_train_step(cfg, TolFLConfig(num_clusters=2,
                                              schedule=schedule, **extra),
                             ocfg, mesh)
    state = {"params": params, "opt": D.make_optimizer(ocfg).init(params),
             "step": torch.zeros((), dtype=torch.int32)}
    del sent[:], got[:]
    new, metrics = step(state, batch, torch.tensor(spec["alive"][alive]))
    items = P.tree_items(new["params"])
    out[name] = np.concatenate([x.float().numpy().ravel() for _, x in items])
    out[name + "/dtypes"] = np.asarray(json.dumps(
        ["/".join(p) + ":" + str(x.dtype).split(".")[-1] for p, x in items]))
    out[name + "/sent"] = np.asarray(json.dumps(sent))
    out[name + "/grads"] = np.asarray(json.dumps(got))
    out[name + "/loss"] = np.asarray(float(metrics["loss"]))
np.savez(os.path.join(work, f"rank{mesh.rank}.npz"), **out)
"""


def _bf16_npz(params):
    """repro's params as npz entries: a bf16 leaf as the int16 view of
    its bits under ``b16/``, a float32 one under ``f32/``."""
    out = {}
    for path, x in jax.tree_util.tree_flatten_with_path(params)[0]:
        key = "/".join(k.key for k in path)
        x = np.asarray(x)
        if x.dtype.name == "bfloat16":
            out["b16/" + key] = x.view(np.int16)
        else:
            out["f32/" + key] = x
    return out


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    work = tmp_path_factory.mktemp("gloo_bf16")
    params, _ = RT.init_params(jax.random.PRNGKey(0), BCFG)
    rng = np.random.default_rng(0)
    tokens = rng.integers(0, 256, (B, S)).astype(np.int32)
    labels = rng.integers(0, 256, (B, S)).astype(np.int32)
    np.savez(work / "data.npz", tokens=tokens, labels=labels,
             **_bf16_npz(params))
    ranks = _run_ranks(work, {"cases": CASES, "alive": ALIVE,
                              "ocfg": dataclasses.asdict(OCFG)},
                       script=RANK_SCRIPT)
    return {"params": params, "tokens": tokens, "labels": labels,
            "ranks": ranks, "out": ranks[0]}


def _leaves(params):
    """(path, dtype name, size) of each leaf, in tree order."""
    return [("/".join(k.key for k in path), np.asarray(x).dtype.name,
             np.asarray(x).size)
            for path, x in jax.tree_util.tree_flatten_with_path(params)[0]]


def _widened(params):
    return np.concatenate([np.asarray(x).astype(np.float32).ravel()
                           for x in jax.tree.leaves(params)])


def _ulp(x):
    """One bf16 ulp of each |x| (2^-7 of its binade; bf16 keeps 8 bits)."""
    m = np.maximum(np.abs(x), np.float32(2.0 ** -126))
    return np.exp2(np.floor(np.log2(m)) - 7).astype(np.float32)


def _check_update(world, name, alive, local_epochs=1):
    """The port's widened update against the oracle's: most elements
    moved, each within ULPS ulps + UPD_TOL of its leaf's largest."""
    p0 = _widened(world["params"])
    want = _oracle(world, ALIVE[alive], local_epochs, cfg=BCFG,
                   params=world["params"], ocfg=OCFG)
    got = world["out"][name]
    moved = float(np.mean(got != p0))
    assert moved > 0.5, moved
    assert float(np.mean(want != p0)) > 0.5
    off = 0
    worst = 0.0
    for path, _, size in _leaves(world["params"]):
        g, w, p = (a[off:off + size] for a in (got, want, p0))
        off += size
        du_got, du_want = g - p, w - p
        scale = float(np.max(np.abs(du_want)))
        excess = np.abs(du_got - du_want) - ULPS * _ulp(w)
        worst = max(worst, float(np.max(excess)) / max(scale, 1e-30))
        assert float(np.max(excess)) <= UPD_TOL * scale, (path, scale)
    return worst


@pytest.mark.parametrize("alive", list(ALIVE))
def test_ring_bf16_equals_oracle(world, alive):
    _check_update(world, f"ring_{alive}", alive)


@pytest.mark.parametrize("name", ["psum_mb1", "psum_mb2", "ring_sync"])
def test_psum_and_sync_bf16_equal_oracle(world, name):
    _check_update(world, name, "none")


def test_local_epochs_bf16_equal_oracle(world):
    _check_update(world, "ring_e2", "none", local_epochs=2)


def test_failure_changes_the_bf16_update(world):
    out = world["out"]
    assert not np.array_equal(out["ring_none"], out["ring_head"])


def test_bf16_ranks_agree(world):
    """Every rank ends every case with the same params, bit for bit."""
    for r in world["ranks"][1:]:
        for name, *_ in CASES:
            np.testing.assert_array_equal(r[name], world["out"][name])
            assert r[name + "/loss"] == world["out"][name + "/loss"]


def test_params_keep_their_dtypes(world):
    """The step's params keep repro's dtypes: bf16, and float32 for the
    qk-norm scales."""
    want = [f"{p}:{d}" for p, d, _ in _leaves(world["params"])]
    assert any(w.endswith("float32") for w in want)
    assert any(w.endswith("bfloat16") for w in want)
    for name, *_ in CASES:
        assert json.loads(str(world["out"][name + "/dtypes"])) == want


def _sizes(world):
    sz = {"bfloat16": 0, "float32": 0}
    for _, d, n in _leaves(world["params"]):
        sz[d] += n
    return sz


@pytest.mark.parametrize("name", ["ring_none", "ring_head", "psum_mb1"])
def test_collectives_carry_bf16(world, name):
    """The gradient's bf16 leaves are all-reduced in one bf16 buffer of
    their size (no float32 buffer carries them), the float32 leaves with
    the float32 scalars at the end of theirs; the ring's chain hop (rank
    0, the first cluster's head, to rank 2) sends the scalars, then the
    float32 buffer, then the bf16 one, as bytes."""
    sz = _sizes(world)
    sent = json.loads(str(world["out"][name + "/sent"]))
    reduces = [(d, n) for op, d, n in sent if op == "all_reduce"]
    assert ("bfloat16", sz["bfloat16"]) in reduces
    assert all(n < sz["bfloat16"] for d, n in reduces if d == "float32")
    if name.startswith("ring"):
        assert ("float32", sz["float32"] + 1) in reduces   # + the loss
        assert ("float32", sz["float32"] + 2) in reduces   # + loss, n
        assert [s for s in sent if s[0] == "send"] == [
            ["send", "uint8", 8 + 4 * sz["float32"] + 2 * sz["bfloat16"]]]
    else:
        assert ("float32", sz["float32"] + 1) in reduces


def test_sync_dtype_and_microbatches_reduce_as_repro(world):
    """grad_sync_dtype bf16 on gloo: the chain carries every leaf in bf16
    and the final all-reduce is float32 (repro's CPU psums); at
    microbatches 2 the psum accumulates and reduces one float32 buffer."""
    sz = _sizes(world)
    sent = json.loads(str(world["out"]["ring_sync/sent"]))
    assert [s for s in sent if s[0] == "send"] == [
        ["send", "uint8", 8 + 2 * (sz["float32"] + sz["bfloat16"])]]
    sent = json.loads(str(world["out"]["psum_mb2/sent"]))
    assert [s for s in sent if s[0] == "all_reduce"] == [
        ["all_reduce", "float32", sz["float32"] + sz["bfloat16"] + 1]]


@pytest.mark.parametrize("name,want", [
    ("ring_none", ["bfloat16", "float32"]),
    ("psum_mb1", ["bfloat16", "float32"]),
    ("psum_mb2", ["float32"]), ("ring_sync", ["float32"]),
    ("ring_e2", ["float32"])])
def test_grads_reach_the_optimizer_in_repros_dtypes(world, name, want):
    """The leaves' dtypes at microbatches 1 without grad_sync_dtype,
    float32 otherwise (repro's float32 accumulation and master grads)."""
    assert json.loads(str(world["out"][name + "/grads"])) == [want]
