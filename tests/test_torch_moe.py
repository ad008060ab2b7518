"""Port parity for the MoE layer (``repro_torch.models.moe``) against
``repro.models.moe``: the same params (``repro``'s ``moe_init`` through the
weight bridge) and the same numpy inputs.

The dispatch masks must be equal bit for bit (the same top-k by first
argmax, the same per-expert positions and drops), the combine masks hold
the same slots, their router probabilities within 1e-6; the output and
the load-balance and z losses within 1e-5.  Cases: the reduced Scout (4
experts, top-1, a shared expert) at capacity 1.25, where a chunk drops
tokens; top-2 routing; several chunks, each with its own capacity; the
decode shape (chunk 1, capacity 1, nothing dropped); the reduced
Maverick's interleaved unit (MoE, then a dense layer) through
``repro``'s and the port's layer application.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCHS as JARCHS
from repro.models import moe as JM
from repro.models import transformer as JT
from repro.serving import decode as JD
from repro_torch.configs.registry import ARCHS as TARCHS
from repro_torch.models import moe as TM
from repro_torch.models import params as TP
from repro_torch.models import transformer as TT
from repro_torch.models.mlp import mlp_apply
from repro_torch.serving import decode as TD
from torch_threads import one_torch_thread  # noqa: F401

SCOUT, MAVERICK = "llama4-scout-17b-a16e", "llama4-maverick-400b-a17b"
TOL = dict(rtol=1e-5, atol=1e-5)


def _cfgs(arch, **moe):
    jcfg, tcfg = JARCHS[arch].reduced(), TARCHS[arch].reduced()
    if moe:
        jcfg = dataclasses.replace(jcfg, moe=dataclasses.replace(jcfg.moe,
                                                                 **moe))
        tcfg = dataclasses.replace(tcfg, moe=dataclasses.replace(tcfg.moe,
                                                                 **moe))
    assert dataclasses.asdict(jcfg) == dataclasses.asdict(tcfg)
    return jcfg, tcfg


def _moe_params(jcfg, seed=0):
    jp, _ = JM.moe_init(jax.random.PRNGKey(seed), jcfg.d_model, jcfg.d_ff,
                        jcfg.moe, jcfg.glu, "float32")
    return jp, TP.from_numpy_tree(jax.tree.map(np.asarray, jp), "cpu")


def _x(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


# (arch, moe overrides, (B, S), chunk)
CASES = [
    pytest.param(SCOUT, {}, (2, 96), 512, id="scout-drops"),
    pytest.param(SCOUT, {"num_experts_per_tok": 2}, (2, 96), 512,
                 id="scout-top2"),
    pytest.param(SCOUT, {}, (2, 256), 64, id="scout-4-chunks"),
    pytest.param(SCOUT, {}, (3, 1), 1, id="scout-decode"),
    pytest.param(SCOUT, {"capacity_factor": 16.0}, (2, 96), 512,
                 id="scout-no-drop"),
    pytest.param(MAVERICK, {}, (2, 96), 512, id="maverick"),
    pytest.param(MAVERICK, {"num_experts_per_tok": 2,
                            "shared_expert": False}, (1, 60), 512,
                 id="maverick-top2-unshared"),
]


@pytest.mark.parametrize("arch,moe,shape,chunk", CASES)
def test_dispatch_mask_equals_repros(arch, moe, shape, chunk):
    jcfg, tcfg = _cfgs(arch, **moe)
    B, S = shape
    logits = _x((B, S, jcfg.moe.num_experts), 7) * 3.0
    C = TM._capacity(S, tcfg.moe)
    assert C == JM._capacity(S, jcfg.moe)
    jd, jc, jpr = JM._dispatch_mask(jnp.asarray(logits), jcfg.moe, C)
    td, tc, tpr = TM._dispatch_mask(torch.from_numpy(logits), tcfg.moe, C)
    np.testing.assert_array_equal(td.numpy(), np.asarray(jd))
    # combine = dispatch x the router probability: the same slots, the
    # values within the last bit of XLA's and torch's softmax
    np.testing.assert_array_equal(tc.numpy() != 0, np.asarray(jc) != 0)
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), rtol=1e-6,
                               atol=0)
    np.testing.assert_allclose(tpr.numpy(), np.asarray(jpr), rtol=1e-6,
                               atol=0)
    # each token takes at most top-k slots, each slot at most one token
    k = tcfg.moe.num_experts_per_tok
    assert float(td.sum(dim=(2, 3)).max()) <= k
    assert float(td.sum(dim=1).max()) <= 1


@pytest.mark.parametrize("arch,moe,shape,chunk", CASES)
def test_moe_apply_equals_repros(arch, moe, shape, chunk):
    jcfg, tcfg = _cfgs(arch, **moe)
    jp, tp = _moe_params(jcfg)
    B, S = shape
    x = _x((B, S, jcfg.d_model), 3)
    jout, jaux = JM.moe_apply(jp, jnp.asarray(x), jcfg.moe, jcfg.act,
                              jcfg.glu, chunk=chunk)
    tout, taux = TM.moe_apply(tp, torch.from_numpy(x), tcfg.moe, tcfg.act,
                              tcfg.glu, chunk=chunk)
    np.testing.assert_allclose(tout.numpy(), np.asarray(jout), **TOL)
    for name in ("lb_loss", "z_loss"):
        assert taux[name].dtype == torch.float32 and taux[name].dim() == 0
        np.testing.assert_allclose(taux[name].numpy(),
                                   np.asarray(jaux[name]), **TOL)


def test_capacity_drops_tokens_and_keeps_their_residual():
    """At capacity 1.25 a 96-token chunk gives each of 4 experts 30 slots:
    with this router some expert is asked for more, and its overflow tokens
    get no routed output (only the shared expert's)."""
    _, tcfg = _cfgs(SCOUT)
    jp, tp = _moe_params(_cfgs(SCOUT)[0])
    x = torch.from_numpy(_x((2, 96, tcfg.d_model), 3))
    logits = TP.dense_apply(tp["router"], x, torch.float32)
    C = TM._capacity(96, tcfg.moe)
    assert C == 30
    dispatch, _, _ = TM._dispatch_mask(logits, tcfg.moe, C)
    routed = dispatch.sum(dim=(2, 3))                   # (B, T): 0 or 1
    dropped = routed == 0
    assert 0 < int(dropped.sum()) < routed.numel()
    out, _ = TM.moe_apply(tp, x, tcfg.moe, tcfg.act, tcfg.glu)
    only_shared = mlp_apply(tp["shared"], x, tcfg.act, tcfg.glu)
    torch.testing.assert_close(out[dropped], only_shared[dropped], rtol=0,
                               atol=0)
    assert not torch.allclose(out[~dropped], only_shared[~dropped])


def test_maverick_unit_is_moe_then_dense():
    """The reduced Maverick's unit (interleave 2) is (MoE, dense): one
    prefill and two decode steps of it equal repro's within 1e-5, and
    its params hold experts in l0 only."""
    jcfg, tcfg = _cfgs(MAVERICK)
    assert TT.unit_pattern(tcfg) == (("attn", True), ("attn", False)) == \
        JT.unit_pattern(jcfg)
    jp, _ = JT.init_params(jax.random.PRNGKey(2), jcfg)
    tp = TP.from_numpy_tree(jax.tree.map(np.asarray, jp), "cpu")
    assert "experts" in tp["units"]["l0"]["mlp"]
    assert "experts" not in tp["units"]["l1"]["mlp"]
    toks = np.random.default_rng(4).integers(0, jcfg.vocab_size, (2, 66))
    jl, jc = JD.prefill(jp, jcfg, {"tokens": jnp.asarray(toks[:, :64])})
    tl, tc = TD.prefill(tp, tcfg, {"tokens": torch.from_numpy(toks[:, :64])})
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
    jc = JD.pad_cache(jc, jcfg, 64, 66)
    tc = TD.pad_cache(tc, tcfg, 64, 66)
    for t in (64, 65):
        jl, jc = JD.decode_step(jp, jcfg, jnp.asarray(toks[:, t:t + 1]), jc,
                                jnp.int32(t))
        tl, tc = TD.decode_step(tp, tcfg, torch.from_numpy(toks[:, t:t + 1]),
                                tc, t)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)


@pytest.mark.parametrize("arch", [SCOUT, MAVERICK])
def test_prefill_equals_decode_at_capacity_16(arch):
    """With capacity >= chunk nothing is dropped, so a decode step at
    position S gives the logits of a prefill over S + 1 tokens (repro's
    tests/test_serving.py sets capacity 16 for the same reason)."""
    _, tcfg = _cfgs(arch, capacity_factor=16.0)
    tp = TT.init_params(torch.Generator().manual_seed(0), tcfg, "cpu")
    toks = torch.randint(0, tcfg.vocab_size, (2, 33),
                         generator=torch.Generator().manual_seed(1))
    want, _ = TD.prefill(tp, tcfg, {"tokens": toks})
    _, cache = TD.prefill(tp, tcfg, {"tokens": toks[:, :32]})
    cache = TD.pad_cache(cache, tcfg, 32, 33)
    got, _ = TD.decode_step(tp, tcfg, toks[:, 32:], cache, 32)
    torch.testing.assert_close(got, want, rtol=2e-3, atol=2e-3)
