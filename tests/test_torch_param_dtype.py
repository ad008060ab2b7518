"""Port parity at bf16 params (``ModelConfig.param_dtype="bfloat16"``):
for every arch of ``test_torch_serve.py``'s ``ARCH_CASES`` the port's
init tree has ``repro``'s keys, shapes and dtypes (Qwen3's qk-norm
scales float32, as ``repro`` builds them), the weight bridge carries
``repro``'s bf16 leaves across bit for bit, and prefill, ``pad_cache``
and decode agree with ``repro``'s ``prefill(..., use_pallas=True)`` and
``decode_step`` within rtol = atol = 1e-4 (the reduced configs compute
in float32 activations).  In bf16 activations too for Maverick and
RecurrentGemma, within ``BF16_TOL`` of the largest |logit|.

Within the port, bf16 params give the same logits and caches, bit for
bit, as float32 params that hold the same rounded values, in float32 and
in bf16 activations: every use of a leaf casts it to the activation
dtype or to float32 first.  A bf16 init draws one (in, out) block at a
time; the float32 init is pinned to the values it gave before bf16
params existed.  The train steps take bf16 params: each builder keeps
every leaf's dtype through a step, and a bf16 checkpoint resumes bit for
bit.
"""
import dataclasses
import functools
import hashlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import transformer as JT
from repro.serving import decode as JD
from repro_torch.configs.base import OptimizerConfig, TolFLConfig
from repro_torch.configs.registry import ARCHS as TARCHS
from repro_torch.core import distributed as D
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.models import params as TP
from repro_torch.models import transformer as TT
from repro_torch.serving import decode as TD
from test_torch_serve import (ARCH_CASES, PROMPT, RG, STEPS, _batches, _cfgs,
                              _inputs)
from torch_threads import one_torch_thread  # noqa: F401

TOL = dict(rtol=1e-4, atol=1e-4)
MAVERICK = "llama4-maverick-400b-a17b"
#: bf16 activations, port vs repro: each step's largest |logit diff| over
#: its largest |logit|.  The two round the same products' bf16 outputs
#: after sums in other orders (the CPU's bf16 GEMMs, the attention's
#: online softmax); one ulp of a bf16 activation is 2^-8 (0.0039) of it.
#: Measured 0.0055-0.0165 for Maverick and RecurrentGemma over two
#: prompts (0.0215 for RWKV6): 4e-2 is ~2.4x the worst of the two
BF16_TOL = 4e-2


def _bf16(cfg):
    return dataclasses.replace(cfg, param_dtype="bfloat16")


@functools.lru_cache(maxsize=None)
def _repro_params(jcfg):
    """``repro``'s params of ``jcfg`` (made once a config: the bridge and
    the serving tests share them)."""
    jp, _ = JT.init_params(jax.random.PRNGKey(0), jcfg)
    return jp


def _run_port(tp, tcfg, inp, S):
    """prefill of the first S tokens, pad_cache, then STEPS decode steps:
    the logits of each and the final cache's leaves."""
    P0 = inp["prefix"].shape[1] if "prefix" in inp else 0
    _, tb = _batches(inp, S)
    logits, cache = TD.prefill(tp, tcfg, tb)
    out = [logits]
    cache = TD.pad_cache(cache, tcfg, P0 + S, P0 + S + STEPS)
    toks = inp["tokens"]
    for t in range(S, S + STEPS):
        logits, cache = TD.decode_step(tp, tcfg,
                                       torch.from_numpy(toks[:, t:t + 1]),
                                       cache, P0 + t)
        out.append(logits)
    return out + [x for _, x in TP.tree_items(cache)]


def _run_repro(jp, jcfg, inp, S):
    P0 = inp["prefix"].shape[1] if "prefix" in inp else 0
    jb, _ = _batches(inp, S)
    logits, cache = JD.prefill(jp, jcfg, jb, use_pallas=True)
    out = [logits]
    cache = JD.pad_cache(cache, jcfg, prompt_len=P0 + S,
                         target_len=P0 + S + STEPS)
    toks = inp["tokens"]
    for t in range(S, S + STEPS):
        logits, cache = JD.decode_step(
            jp, jcfg, jnp.asarray(toks[:, t:t + 1], jnp.int32), cache,
            jnp.int32(P0 + t))
        out.append(logits)
    return out + [x for _, x in TP.tree_items(cache)]


@pytest.mark.parametrize("arch,n_layers", ARCH_CASES)
def test_bf16_init_tree_matches_repro(arch, n_layers):
    """Keys, shapes and dtypes leaf for leaf ``repro``'s ``eval_shape``."""
    jcfg, tcfg = (_bf16(c) for c in _cfgs(n_layers, arch))
    want = jax.eval_shape(lambda k: JT.init_params(k, jcfg)[0],
                          jax.random.PRNGKey(0))
    got = TT.init_params(torch.Generator().manual_seed(0), tcfg, "cpu")
    jitems, titems = TP.tree_items(want), TP.tree_items(got)
    assert [p for p, _ in jitems] == [p for p, _ in titems]
    for (path, a), (_, b) in zip(jitems, titems):
        assert a.shape == tuple(b.shape), path
        assert str(a.dtype) == str(b.dtype).replace("torch.", ""), path
    f32 = [p for p, x in titems if x.dtype == torch.float32]
    assert f32 == ([p for p, _ in titems if p[-2] in ("q_norm", "k_norm")]
                   if tcfg.attention.qk_norm else [])
    meta = TT.init_params(None, tcfg, "meta")
    assert [(p, x.dtype) for p, x in TP.tree_items(meta)] == \
        [(p, x.dtype) for p, x in titems]


@pytest.mark.parametrize("arch,n_layers", ARCH_CASES)
def test_bridge_carries_bf16_bits(arch, n_layers):
    """``from_numpy_tree`` of ``repro``'s bf16 params is ``repro``'s bit for
    bit (int16 views); ``to_numpy_tree`` gives each bf16 leaf back as its
    exact float32 widening."""
    jcfg, _ = (_bf16(c) for c in _cfgs(n_layers, arch))
    jnp_tree = jax.tree.map(np.asarray, _repro_params(jcfg))
    tp = dict(TP.tree_items(TP.from_numpy_tree(jnp_tree, device="cpu")))
    back = dict(TP.tree_items(TP.to_numpy_tree(TP.tree_from_items(
        tp.items()))))
    n_bf16 = 0
    for path, a in TP.tree_items(jnp_tree):
        b = tp[path]
        assert str(b.dtype).replace("torch.", "") == a.dtype.name, path
        if a.dtype.name == "bfloat16":
            n_bf16 += 1
            np.testing.assert_array_equal(b.view(torch.int16).numpy(),
                                          a.view(np.int16), err_msg=str(path))
            assert back[path].dtype == np.float32
            np.testing.assert_array_equal(back[path], a.astype(np.float32))
        else:
            np.testing.assert_array_equal(b.numpy(), a, err_msg=str(path))
            np.testing.assert_array_equal(back[path], a)
    assert n_bf16 > 0


@pytest.mark.parametrize("arch,n_layers", ARCH_CASES)
def test_bf16_params_serve_like_repro(arch, n_layers):
    """prefill, pad_cache and STEPS decode steps on ``repro``'s bf16 params
    through the bridge, float32 activations: the logits and every cache
    leaf within 1e-4 of ``repro``'s."""
    jcfg, tcfg = (_bf16(c) for c in _cfgs(n_layers, arch))
    jp = _repro_params(jcfg)
    tp = TP.from_numpy_tree(jax.tree.map(np.asarray, jp), device="cpu")
    S = PROMPT[arch]
    inp = _inputs(jcfg, abs(n_layers), S, S + STEPS)
    want = _run_repro(jp, jcfg, inp, S)
    got = _run_port(tp, tcfg, inp, S)
    assert len(want) == len(got)
    for a, b in zip(want, got):
        assert str(b.dtype) == f"torch.{np.asarray(a).dtype.name}"
        np.testing.assert_allclose(b.float().numpy(),
                                   np.asarray(a, np.float32), **TOL)


@pytest.mark.parametrize("arch", [MAVERICK, RG])
def test_bf16_params_and_activations_like_repro(arch):
    """bf16 params and bf16 activations: each step's logits within
    ``BF16_TOL`` of the step's largest |logit|."""
    jcfg, tcfg = (dataclasses.replace(_bf16(c), dtype="bfloat16")
                  for c in _cfgs(2, arch))
    jp = _repro_params(jcfg)
    tp = TP.from_numpy_tree(jax.tree.map(np.asarray, jp), device="cpu")
    S = PROMPT[arch]
    inp = _inputs(jcfg, 7, S, S + STEPS)
    want = _run_repro(jp, jcfg, inp, S)[:1 + STEPS]
    got = _run_port(tp, tcfg, inp, S)[:1 + STEPS]
    for a, b in zip(want, got):
        a = np.asarray(a, np.float32)
        assert b.dtype == torch.bfloat16
        err = np.abs(b.float().numpy() - a).max()
        assert err <= BF16_TOL * np.abs(a).max(), (err, np.abs(a).max())


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch,n_layers", ARCH_CASES)
def test_bf16_params_equal_rounded_float32(arch, n_layers, dtype):
    """bf16 params against float32 params that hold the same rounded
    values, in float32 and in bf16 activations: the logits and every
    cache leaf bit for bit (RWKV6 too: ``repro`` differs there by 3.4e-6,
    the port by nothing)."""
    _, tcfg = _cfgs(n_layers, arch)
    tcfg = dataclasses.replace(_bf16(tcfg), dtype=dtype)
    p16 = TT.init_params(torch.Generator().manual_seed(2), tcfg, "cpu")
    p32 = TP.cast_tree(p16, torch.float32)
    S = PROMPT[arch]
    inp = _inputs(tcfg, abs(n_layers), S, S + STEPS)
    for a, b in zip(_run_port(p16, tcfg, inp, S),
                    _run_port(p32, dataclasses.replace(
                        tcfg, param_dtype="float32"), inp, S)):
        assert a.dtype == b.dtype and torch.equal(a, b)


def test_bf16_init_draws_one_block_at_a_time(monkeypatch):
    """A bf16 init of the reduced Maverick draws every leaf in blocks of
    its last two dims: the stacked experts (units, E, d, d_ff) as units x
    E draws of (d, d_ff).  The float32 init draws them in one."""
    cfg = TARCHS[MAVERICK].reduced()
    draws = []
    randn = torch.randn

    def spy(*args, **kw):
        x = randn(*args, **kw)
        draws.append(tuple(x.shape))
        return x

    monkeypatch.setattr(torch, "randn", spy)
    p = TT.init_params(torch.Generator().manual_seed(0), _bf16(cfg), "cpu")
    up = p["units"]["l0"]["mlp"]["experts"]["up"]["w"]
    assert up.dtype == torch.bfloat16 and up.dim() == 4
    assert max(len(s) for s in draws) == 2
    for path, x in TP.tree_items(p):
        if x.dim() > 2 and x.dtype == torch.bfloat16:
            assert draws.count(tuple(x.shape[-2:])) >= np.prod(x.shape[:-2])
    assert draws.count(tuple(up.shape[-2:])) >= up.shape[0] * up.shape[1]
    draws.clear()
    TT.init_params(torch.Generator().manual_seed(0), cfg, "cpu")
    assert tuple(up.shape) in draws


#: the float32 init of three reduced archs as it was before bf16 params:
#: (sum over the leaves of each leaf's float64 sum, the same of squares,
#: the first 16 hex digits of sha256 over each leaf's path and bytes)
F32_PINS = {
    RG: (2060.6621598783267, 8188.288362139856, "dd7ab63665196e95"),
    MAVERICK: (1211.4264333939411, 12129.822971496642, "178561ad4d1540ff"),
    "rwkv6-7b": (1714.8021619408194, 7240.991418637301, "c0c2058dfc66f2f8"),
}


@pytest.mark.parametrize("arch", sorted(F32_PINS))
def test_float32_init_unchanged(arch):
    p = TT.init_params(torch.Generator().manual_seed(0),
                       TARCHS[arch].reduced(), "cpu")
    items = TP.tree_items(p)
    assert all(x.dtype == torch.float32 for _, x in items)
    s = sum(float(x.double().sum()) for _, x in items)
    s2 = sum(float(x.double().square().sum()) for _, x in items)
    h = hashlib.sha256()
    for path, x in items:
        h.update("/".join(path).encode())
        h.update(x.contiguous().numpy().tobytes())
    want = F32_PINS[arch]
    assert s == pytest.approx(want[0], rel=1e-12)
    assert s2 == pytest.approx(want[1], rel=1e-12)
    assert h.hexdigest()[:16] == want[2]


def _train_bits(tree):
    """Every tensor of a train state (params, moments, step) as (dtype,
    bits) pairs, a bf16 leaf as its int16 view."""
    from repro_torch.training.checkpoint import tree_leaves
    return [(x.dtype, x.view(torch.int16) if x.dtype == torch.bfloat16
             else x) for x in tree_leaves(tree)]


def _bf16_qwen3_step(build, **tolfl):
    cfg = dataclasses.replace(_bf16(TARCHS["qwen3-8b"].reduced()),
                              remat="full")
    mesh = make_host_mesh(data=1, model=1, device="cpu")
    ocfg = OptimizerConfig(lr=1e-2, warmup_steps=1, total_steps=4)
    step = build(cfg, TolFLConfig(num_clusters=1, **tolfl), ocfg, mesh)
    return cfg, ocfg, step


def _token_batches(cfg, n):
    from repro_torch.data.pipeline import TokenPipeline
    return [{k: torch.as_tensor(v).long() for k, v in b.items()}
            for b in TokenPipeline(cfg.vocab_size, 16, 2).batches(n)]


@pytest.mark.parametrize("build", [D.make_train_step, D.make_psum_train_step,
                                   D.make_ring_train_step])
def test_train_steps_take_bf16_params(build):
    """Each step builder trains the reduced Qwen3 at bf16 params (a mixed
    tree: float32 qk-norm scales) on a one-rank CPU mesh: every param
    and Adam moment keeps its dtype (repro's: moments in the leaf's),
    the step count is int32, the loss a finite float32 scalar, and the
    params moved."""
    cfg, ocfg, step = _bf16_qwen3_step(build)
    state = D.init_state(torch.Generator().manual_seed(0), cfg, ocfg)
    dtypes = {p: x.dtype for p, x in TP.tree_items(state["params"])}
    assert set(dtypes.values()) == {torch.bfloat16, torch.float32}
    new, metrics = step(state, _token_batches(cfg, 1)[0], torch.ones(1))
    for tree in (new["params"], new["opt"].mu, new["opt"].nu):
        assert {p: x.dtype for p, x in TP.tree_items(tree)} == dtypes
    assert new["step"].dtype == new["opt"].step.dtype == torch.int32
    assert int(new["step"]) == 1
    for v in metrics.values():
        assert v.dtype == torch.float32 and bool(torch.isfinite(v))
    moved = [not torch.equal(a, b) for (_, a), (_, b) in zip(
        TP.tree_items(state["params"]), TP.tree_items(new["params"]))]
    assert all(moved)


def test_bf16_checkpoint_resumes_bit_for_bit(tmp_path):
    """[train-ckpt] at bf16 params: 4 ring steps of the reduced Qwen3
    uninterrupted; then 2, a checkpoint of the whole state saved and
    restored into a fresh one, and steps 3-4: the params, moments, step
    and losses equal the uninterrupted run's bit for bit, in their
    dtypes."""
    from repro_torch.training.checkpoint import CheckpointManager
    cfg, ocfg, step = _bf16_qwen3_step(D.make_train_step)
    batches = _token_batches(cfg, 4)

    def fresh():
        return D.init_state(torch.Generator().manual_seed(4), cfg, ocfg)

    def run(state, lo, hi, losses):
        for i in range(lo, hi):
            state, m = step(state, batches[i], torch.ones(1))
            losses.append(float(m["loss"]))
        return state

    whole_losses, losses = [], []
    whole = run(fresh(), 0, 4, whole_losses)
    mgr = CheckpointManager(str(tmp_path), keep=2)
    mgr.save(run(fresh(), 0, 2, losses), 2)
    restored, at = mgr.restore_latest(fresh())
    assert at == 2
    resumed = run(restored, at, 4, losses)
    assert losses == whole_losses
    got, want = _train_bits(resumed), _train_bits(whole)
    assert [d for d, _ in got] == [d for d, _ in want]
    assert torch.bfloat16 in {d for d, _ in got}
    assert all(torch.equal(a, b) for (_, a), (_, b) in zip(got, want))
