"""Port parity for attention: the flash-attention kernel's plain version
against ``repro``'s Pallas kernel (interpret mode) and the port's oracle,
and the serving path's projections, RoPE, prefill attention, decode
attention and ring-cache validity against ``repro``'s.

Inputs are drawn with numpy from a seed and handed to both packages;
``repro``'s params come from its ``init_params`` through the weight
bridge.  Tolerance rtol = atol = 2e-4, that of tests/test_kernels.py:
float32 sums in another order than XLA's.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCHS as JARCHS
from repro.kernels.flash_attention import flash_attention as j_flash
from repro.models import attention as JA
from repro.models import transformer as JT
from repro_torch.configs.registry import ARCHS as TARCHS
from repro_torch.kernels import flash_attention as tfa
from repro_torch.kernels import ops, ref
from repro_torch.models import attention as TA
from repro_torch.models import params as TP

TOL = dict(rtol=2e-4, atol=2e-4)

# the shapes of tests/test_kernels.py (MQA, GQA, window, bidirectional)
ATTN_SHAPES = [
    # (B, S, H, KVH, D, causal, window)
    (1, 128, 4, 4, 32, True, None),
    (2, 256, 4, 2, 32, True, None),
    (1, 256, 8, 1, 16, True, None),
    (1, 128, 4, 4, 32, False, None),
    (2, 256, 4, 2, 32, True, 64),
    (1, 512, 2, 2, 64, True, 128),
    (1, 128, 2, 2, 16, True, 1),
]


def _qkv(B, Sq, Sk, H, KVH, D, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((B, Sq, H, D)).astype(np.float32),
            rng.standard_normal((B, Sk, KVH, D)).astype(np.float32),
            rng.standard_normal((B, Sk, KVH, D)).astype(np.float32))


@pytest.mark.parametrize("B,S,H,KVH,D,causal,window", ATTN_SHAPES)
def test_flash_plain_matches_pallas_kernel(B, S, H, KVH, D, causal, window):
    q, k, v = _qkv(B, S, S, H, KVH, D)
    want = j_flash(*(jnp.asarray(x) for x in (q, k, v)), causal=causal,
                   window=window, q_block=64, kv_block=64, interpret=True)
    got = ops.attention(*(torch.from_numpy(x) for x in (q, k, v)),
                        causal=causal, window=window)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("S,window", [(97, None), (130, 64), (4097 // 16, 7)])
def test_flash_plain_ragged_matches_oracle(S, window):
    """Sequence lengths that no tile divides (the Pallas kernel asserts
    divisibility; the port's kernel and its plain version do not)."""
    q, k, v = (torch.from_numpy(x) for x in _qkv(2, S, S, 8, 2, 32, seed=1))
    np.testing.assert_allclose(
        tfa.flash_attention_plain(q, k, v, True, window).numpy(),
        ref.attention_reference(q, k, v, True, window).numpy(), **TOL)


def test_flash_plain_zero_row_and_dtype():
    """A query that sees no key gives 0 (the kernel's rule), and the
    output keeps the inputs' dtype."""
    q, k, v = (torch.from_numpy(x) for x in _qkv(1, 8, 4, 2, 1, 16))
    # causal with Sk < Sq: every query sees keys 0..min(i, 3); window 1
    # leaves queries 4..7 with no key at all
    out = tfa.flash_attention_plain(q, k, v, causal=True, window=1)
    assert torch.all(out[:, 4:] == 0) and torch.all(torch.isfinite(out))
    np.testing.assert_allclose(
        out[:, :4].numpy(),
        ref.attention_reference(q[:, :4], k, v, True, 1).numpy(), **TOL)
    bf = tfa.flash_attention(q.bfloat16(), k.bfloat16(), v.bfloat16())
    assert bf.dtype == torch.bfloat16


def test_flash_rejects_mismatched_shapes():
    q, k, v = (torch.from_numpy(x) for x in _qkv(1, 8, 8, 3, 2, 16))
    with pytest.raises(ValueError):
        ops.attention(q, k, v)


def _cfg_params(seed=0):
    jcfg = JARCHS["recurrentgemma-9b"].reduced()
    tcfg = TARCHS["recurrentgemma-9b"].reduced()
    jp, _ = JT.init_params(jax.random.PRNGKey(seed), jcfg)
    # the local-attention layer of the reduced config's one unit
    jattn = jax.tree.map(lambda x: x[0], jp["units"]["l1"]["mix"])
    tattn = TP.from_numpy_tree(jax.tree.map(np.asarray, jattn), device="cpu")
    return jcfg, tcfg, jattn, tattn


def test_project_qkv_rope_and_attn_apply():
    jcfg, tcfg, jp, tp = _cfg_params()
    x = np.random.default_rng(2).standard_normal(
        (2, 80, jcfg.d_model)).astype(np.float32)
    pos = np.arange(80)
    jq = JA.project_qkv(jp, jnp.asarray(x), jcfg.attention,
                        jnp.asarray(pos), compute_dtype=jnp.float32)
    tq = TA.project_qkv(tp, torch.from_numpy(x), tcfg.attention,
                        torch.from_numpy(pos), compute_dtype=torch.float32)
    for a, b in zip(jq, tq):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), **TOL)
    want = JA.attn_apply(jp, jnp.asarray(x), jcfg.attention, use_pallas=True)
    got = TA.attn_apply(tp, torch.from_numpy(x), tcfg.attention)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("Sc,position,window", [
    (16, 5, None), (16, 40, None), (8, 8, 8), (8, 21, 8), (8, 3, 8),
    (12, 30, 5)])
def test_cache_slot_validity(Sc, position, window):
    want = JA.cache_slot_validity(Sc, jnp.int32(position), window)
    got = TA.cache_slot_validity(Sc, position, window, "cpu")
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("Sc,position,window", [(64, 70, 64), (32, 10, None)])
def test_attn_decode_matches(Sc, position, window):
    jcfg, tcfg, jp, tp = _cfg_params(seed=3)
    a = jcfg.attention
    rng = np.random.default_rng(4)
    x = rng.standard_normal((2, 1, jcfg.d_model)).astype(np.float32)
    kc, vc = (rng.standard_normal((2, Sc, a.num_kv_heads, a.head_dim))
              .astype(np.float32) for _ in range(2))
    jout, jcache = JA.attn_decode(
        jp, jnp.asarray(x), {"k": jnp.asarray(kc), "v": jnp.asarray(vc)},
        jcfg.attention, jnp.int32(position), window=window)
    tcache = {"k": torch.from_numpy(kc), "v": torch.from_numpy(vc)}
    tout, tnew = TA.attn_decode(tp, torch.from_numpy(x), tcache,
                                tcfg.attention, position, window=window)
    np.testing.assert_allclose(tout.numpy(), np.asarray(jout), **TOL)
    for name in ("k", "v"):
        np.testing.assert_allclose(tnew[name].numpy(),
                                   np.asarray(jcache[name]), **TOL)
    # the given cache is left as it was
    np.testing.assert_array_equal(tcache["k"].numpy(), kc)


def test_decode_attention_bf16_accumulates_in_f32():
    """In bfloat16 the decode scores are float32 sums of bf16 products, as
    repro's einsums with preferred_element_type=float32."""
    rng = np.random.default_rng(5)
    q = rng.standard_normal((2, 1, 4, 32)).astype(np.float32)
    kc, vc = (rng.standard_normal((2, 24, 1, 32)).astype(np.float32)
              for _ in range(2))
    kn, vn = (rng.standard_normal((2, 1, 1, 32)).astype(np.float32)
              for _ in range(2))
    valid = np.arange(24) < 20
    args = [q, kc, vc, kn, vn]
    want = JA.decode_attention(*(jnp.asarray(x, jnp.bfloat16) for x in args),
                               cache_valid=jnp.asarray(valid))
    got = TA.decode_attention(*(torch.from_numpy(x).bfloat16() for x in args),
                              cache_valid=torch.from_numpy(valid))
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32),
                               rtol=1e-2, atol=1e-2)


def test_reduced_window_config_equal():
    """The windowed config the tests use is the same on both sides."""
    assert dataclasses.asdict(JARCHS["recurrentgemma-9b"].reduced()) == \
        dataclasses.asdict(TARCHS["recurrentgemma-9b"].reduced())
