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


@pytest.mark.parametrize("dtype,D,kernel", [
    (torch.bfloat16, 64, "tensor_core"), (torch.bfloat16, 128, "tensor_core"),
    (torch.bfloat16, 256, "tensor_core"), (torch.bfloat16, 32, "cuda_core"),
    (torch.float32, 32, "cuda_core"), (torch.float32, 64, "cuda_core"),
    (torch.float32, 128, "cuda_core"), (torch.float32, 256, "cuda_core")])
def test_route(dtype, D, kernel):
    """bf16 at D in {64, 128, 256} goes to the tensor cores; float32, and
    bf16 at D = 32, to the CUDA-core kernel."""
    assert tfa.route(dtype, D) == kernel


@pytest.mark.parametrize("dtype,D,err", [
    (torch.float16, 64, TypeError), (torch.float64, 128, TypeError),
    (torch.float32, 48, ValueError), (torch.bfloat16, 512, ValueError),
    (torch.bfloat16, 16, ValueError)])
def test_route_rejects(dtype, D, err):
    with pytest.raises(err):
        tfa.route(dtype, D)


# (Sq, Sk, G, causal, window): the serving prefill, fully masked rows,
# Sq != Sk both ways, the zoo's group sizes, window 1, bidirectional
TILE_CASES = [(4096, 4096, 16, True, 2048), (300, 100, 16, True, 64),
              (97, 200, 6, False, 50), (200, 97, 16, True, None),
              (333, 333, 4, True, 100), (130, 130, 1, False, None),
              (97, 97, 5, True, 1), (1000, 1000, 2, True, 300)]


def _unmasked(k0, Sk, q_lo, q_hi, causal, window):
    """The tensor-core kernel's rule for a tile it does not mask: keys
    [k0, k0 + TC_KEYS) inside every band of queries [q_lo, q_hi]
    (``inside`` in csrc/flash_attention_wgmma.cu)."""
    return (k0 + tfa.TC_KEYS <= Sk
            and (not causal or k0 + tfa.TC_KEYS - 1 <= q_lo)
            and (window is None or k0 >= q_hi - window + 1))


@pytest.mark.parametrize("Sq,Sk,G,causal,window", TILE_CASES)
def test_wgmma_tiles_cover_each_rows_band(Sq, Sk, G, causal, window):
    """The tensor-core kernel's key tiles, block by block: every key any
    of the block's rows sees lies in a visited tile, the first and last
    visited tiles hold a visible key, a block whose rows see nothing visits
    none, and a tile the kernel leaves unmasked is visible from every row
    of the block."""
    ok = tfa.visible(Sq, Sk, causal, window)
    rows = Sq * G
    plan = tfa.wgmma_tiles(Sq, Sk, G, causal, window)
    assert len(plan) == -(-rows // tfa.TC_ROWS)
    for x, (first, count) in enumerate(plan):
        q_lo = x * tfa.TC_ROWS // G
        q_hi = (min((x + 1) * tfa.TC_ROWS, rows) - 1) // G
        band = ok[q_lo:q_hi + 1]
        keys = torch.nonzero(band.any(0)).flatten()
        if keys.numel() == 0:
            assert count == 0
            continue
        lo, hi = first * tfa.TC_KEYS, (first + count) * tfa.TC_KEYS
        assert lo <= int(keys.min()) and int(keys.max()) < hi
        assert int(keys.min()) < lo + tfa.TC_KEYS
        assert int(keys.max()) >= hi - tfa.TC_KEYS
        for t in range(first, first + count):
            k0 = t * tfa.TC_KEYS
            if _unmasked(k0, Sk, q_lo, q_hi, causal, window):
                assert k0 + tfa.TC_KEYS <= Sk
                assert bool(band[:, k0:k0 + tfa.TC_KEYS].all())


def test_wgmma_tiles_serving_band_waste():
    """At the serving prefill (S 4,096, 16 heads on one kv head, window
    2,048) a block's 128 rows are 8 queries, and its tiles hold at most
    7% more (query, key) pairs than its rows see."""
    S, G, window = 4096, 16, 2048
    plan = tfa.wgmma_tiles(S, S, G, True, window)
    computed = sum(count for _, count in plan) * tfa.TC_KEYS * tfa.TC_ROWS
    seen = int(tfa.visible(S, S, True, window).sum()) * G
    assert seen < computed <= 1.07 * seen


def test_build_hash_covers_headers(tmp_path, monkeypatch):
    """A library's name hashes the headers of csrc too: an edited header
    builds anew instead of loading a stale library."""
    from repro_torch.kernels import _build
    src = tmp_path / "k.cu"
    src.write_text('#include "h.cuh"\n')
    (tmp_path / "h.cuh").write_text("// one\n")
    monkeypatch.setattr(_build, "CSRC", tmp_path)
    before = _build.library_path(src)
    (tmp_path / "h.cuh").write_text("// two\n")
    assert _build.library_path(src) != before
    (tmp_path / "h.cuh").write_text("// one\n")
    assert _build.library_path(src) == before


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
