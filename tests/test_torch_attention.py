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
from hypothesis_compat import given, settings, st

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
    (torch.bfloat16, 256, "tensor_core"), (torch.bfloat16, 32, "tf32x3"),
    (torch.float32, 32, "tf32x3"), (torch.float32, 64, "tf32x3"),
    (torch.float32, 128, "tf32x3"), (torch.float32, 256, "tf32x3")])
def test_route(dtype, D, kernel):
    """bf16 at D in {64, 128, 256} goes to the bf16 tensor cores; float32,
    and bf16 at D = 32, to the split-TF32 kernel."""
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


@pytest.mark.parametrize("D", tfa.TC_HEAD_DIMS)
@pytest.mark.parametrize("Sq,Sk,G,causal,window", TILE_CASES)
def test_wgmma_tiles_cover_each_rows_band(Sq, Sk, G, causal, window, D):
    """The tensor-core kernel's key tiles at head dim D, block by block:
    every key any of the block's rows sees lies in a visited tile, the
    first and last visited tiles hold a visible key, a block whose rows see
    nothing visits none, and a tile the kernel leaves unmasked is visible
    from every row of the block."""
    rows_b, keys_t, _ = tfa.wgmma_plan(D)
    ok = tfa.visible(Sq, Sk, causal, window)
    rows = Sq * G
    plan = tfa.wgmma_tiles(Sq, Sk, G, causal, window, D)
    assert len(plan) == -(-rows // rows_b)
    for (r0, r1), (first, count) in zip(tfa.wgmma_blocks(Sq, G, D), plan):
        q_lo, q_hi = r0 // G, (r1 - 1) // G
        band = ok[q_lo:q_hi + 1]
        keys = torch.nonzero(band.any(0)).flatten()
        if keys.numel() == 0:
            assert count == 0
            continue
        lo, hi = first * keys_t, (first + count) * keys_t
        assert lo <= int(keys.min()) and int(keys.max()) < hi
        assert int(keys.min()) < lo + keys_t
        assert int(keys.max()) >= hi - keys_t
        for t in range(first, first + count):
            k0 = t * keys_t
            if not tfa.wgmma_tile_masked(k0, Sk, q_lo, q_hi, causal, window,
                                         D):
                assert k0 + keys_t <= Sk
                assert bool(band[:, k0:k0 + keys_t].all())


@pytest.mark.parametrize("D", tfa.TC_HEAD_DIMS)
def test_wgmma_tiles_serving_band_waste(D):
    """At the serving prefill (S 4,096, 16 heads on one kv head, window
    2,048) a block's 128 rows are 8 queries, and its tiles hold at most
    7% more (query, key) pairs than its rows see, at every D's tiles."""
    S, G, window = 4096, 16, 2048
    rows_b, keys_t, _ = tfa.wgmma_plan(D)
    plan = tfa.wgmma_tiles(S, S, G, True, window, D)
    computed = sum(count for _, count in plan) * keys_t * rows_b
    seen = int(tfa.visible(S, S, True, window).sum()) * G
    assert seen < computed <= 1.07 * seen


def test_wgmma_plan_fits_the_card():
    """Each D's tiles: blocks of 64-row warpgroups, keys a multiple of
    wgmma's 16-key step, at least 3 stages at D 64 / 128 (the producer's
    ring), and shared memory (Q, the ring's K and V, three mbarriers a
    stage and 1 KB to align) within the 232,448 bytes a block may use."""
    for D in tfa.TC_HEAD_DIMS:
        rows, keys, stages = tfa.wgmma_plan(D)
        assert rows % 64 == 0 and keys % 16 == 0
        assert stages >= (2 if D == 256 else 3)
        smem = rows * D * 2 + 2 * stages * keys * D * 2 + 3 * stages * 8 + 1024
        assert smem <= 232_448
    with pytest.raises(ValueError):
        tfa.wgmma_plan(32)


def _covered(Sq, Sk, G, causal, window, D):
    """(rows Sq G, Sk) int: how often the kernel's warpgroups compute each
    (query-head row, key) pair, and (rows, Sk) bool: the pairs a masked
    tile computes."""
    rows_b, keys_t, _ = tfa.wgmma_plan(D)
    rows = Sq * G
    cover = np.zeros((rows, Sk), dtype=np.int64)
    masked = np.zeros((rows, Sk), dtype=bool)
    plan = tfa.wgmma_tiles(Sq, Sk, G, causal, window, D)
    groups = tfa.wgmma_group_tiles(Sq, Sk, G, causal, window, D)
    blocks = tfa.wgmma_blocks(Sq, G, D)
    for (b0, b1), (first, count), counts in zip(blocks, plan, groups):
        q_lo, q_hi = b0 // G, (b1 - 1) // G
        assert len(counts) == rows_b // 64 and max(counts) <= count
        for g, n in enumerate(counts):
            r0, r1 = min(b0 + 64 * g, b1), min(b0 + 64 * (g + 1), b1)
            for t in range(first, first + n):
                k0, k1 = t * keys_t, min((t + 1) * keys_t, Sk)
                cover[r0:r1, k0:k1] += 1
                if tfa.wgmma_tile_masked(t * keys_t, Sk, q_lo, q_hi, causal,
                                         window, D):
                    masked[r0:r1, k0:k1] = True
    return cover, masked


@settings(max_examples=60, deadline=None)
@given(Sq=st.integers(1, 300), Sk=st.integers(1, 300), G=st.integers(1, 8),
       causal=st.booleans(), window=st.sampled_from([None, 1, 7, 64, 200]),
       D=st.sampled_from([64, 128, 256]))
def test_wgmma_tiles_cover_each_visible_triple_once(Sq, Sk, G, causal,
                                                    window, D):
    """Every visible (query, head, key) triple lies in exactly one tile a
    warpgroup computes, and every pair an unmasked tile computes is
    visible: only the band's edge tiles are masked."""
    cover, masked = _covered(Sq, Sk, G, causal, window, D)
    ok = np.repeat(tfa.visible(Sq, Sk, causal, window).numpy(), G, axis=0)
    assert (cover[ok] == 1).all()
    assert (cover <= 1).all()
    assert ok[(cover == 1) & ~masked].all()


@settings(max_examples=60, deadline=None)
@given(Sq=st.integers(1, 2000), G=st.integers(1, 16),
       D=st.sampled_from([64, 128, 256]))
def test_wgmma_blocks_partition_the_rows(Sq, G, D):
    """The row blocks cover the Sq G rows of a (batch, kv head) once, in
    order, each of at most a block's rows; only one block is short: the
    last at D = 256, the first at D 64 / 128, whose blocks end at the last
    row, so that under a causal mask the short block visits the fewest
    key tiles."""
    rows_b = tfa.wgmma_plan(D)[0]
    blocks = tfa.wgmma_blocks(Sq, G, D)
    assert len(blocks) == -(-Sq * G // rows_b)
    assert blocks[0][0] == 0 and blocks[-1][1] == Sq * G
    assert all(a[1] == b[0] for a, b in zip(blocks, blocks[1:]))
    sizes = [r1 - r0 for r0, r1 in blocks]
    short = sizes[-1] if D == 256 else sizes[0]
    rest = sizes[:-1] if D == 256 else sizes[1:]
    assert 0 < short <= rows_b and all(n == rows_b for n in rest)
    plan = tfa.wgmma_tiles(Sq, Sq, G, True, None, D)
    if D != 256:
        assert plan[0][1] == min(count for _, count in plan)


@settings(max_examples=60, deadline=None)
@given(Sq=st.integers(1, 2000), G=st.integers(1, 16), causal=st.booleans(),
       D=st.sampled_from([64, 128, 256]), BKVH=st.integers(1, 5))
def test_wgmma_order_is_a_permutation_heaviest_first(Sq, G, causal, D,
                                                     BKVH):
    """The blocks start in an order that holds every (batch-kv head, row
    block) once; at D 64 / 128 under a causal mask (no window) every (batch,
    kv head)'s last row block starts first, and the key tiles a block
    visits never grow along the order: the heaviest start first."""
    rows = tfa.wgmma_plan(D)[0]
    order = tfa.wgmma_order(Sq, G, causal, D, BKVH)
    n = -(-Sq * G // rows)
    assert sorted(order) == [(bh, y) for bh in range(BKVH) for y in range(n)]
    if D == 256 or not causal:
        return
    plan = tfa.wgmma_tiles(Sq, Sq, G, True, None, D)
    work = [plan[y][1] for _, y in order]
    assert work == sorted(work, reverse=True)
    assert [y for _, y in order[:BKVH]] == [n - 1] * BKVH


# the nine served D <= 128 prefill shapes (B, Sq, Sk, H, KVH, D, causal)
# and the most their warpgroups may compute beyond the (query, head, key)
# triples their rows see: a warpgroup's tiles at the causal diagonal, a
# ragged last key tile, a ragged last warpgroup (whisper's 416 rows are
# 6.5 warpgroups)
SERVED_SHAPES = [
    ((4, 4352, 4352, 48, 8, 128, True), 0.025),    # InternVL2
    ((4, 4096, 4096, 32, 8, 128, True), 0.025),    # qwen3-8b
    ((4, 4096, 4096, 32, 8, 64, True), 0.025),     # granite-3-2b
    ((4, 4096, 4096, 16, 8, 128, True), 0.025),    # internlm2-1.8b
    ((4, 4096, 4096, 16, 16, 64, True), 0.035),    # qwen1.5-0.5b
    ((4, 4096, 4096, 40, 8, 128, True), 0.025),    # Scout
    ((4, 1500, 1500, 20, 20, 64, False), 0.04),    # whisper encoder
    ((4, 416, 1500, 20, 20, 64, False), 0.1),      # whisper cross
    ((4, 416, 416, 20, 20, 64, True), 0.5),        # whisper self
]


@pytest.mark.parametrize("shape,waste", SERVED_SHAPES)
def test_wgmma_tiles_served_band_waste(shape, waste):
    """At each served D <= 128 prefill the warp-specialized kernel's
    warpgroups compute at most ``waste`` more (query, head, key) triples
    than their rows see (:func:`wgmma_group_tiles`)."""
    B, Sq, Sk, H, KVH, D, causal = shape
    G = H // KVH
    keys_t = tfa.wgmma_plan(D)[1]
    groups = tfa.wgmma_group_tiles(Sq, Sk, G, causal, None, D)
    computed = sum(sum(counts) for counts in groups) * keys_t * 64
    seen = int(tfa.visible(Sq, Sk, causal, None).sum()) * G
    assert seen < computed <= (1 + waste) * seen


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
