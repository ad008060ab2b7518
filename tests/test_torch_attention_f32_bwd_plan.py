"""The split-TF32 attention backward's host side on the CPU: its routing
(``bwd_route`` -> ``"tf32x3"``), a mirror of its kernels' tile plans
(``f32_bwd_tiles``, head split included) against ``visible()``, the
operand split (``split_tf32``, ``cvt.rna.tf32.f32`` emulated on the int32
view), and the kernels' arithmetic emulated in their tile order against
``jax.grad`` of ``repro``'s ``attention_reference`` in float32.

Inputs are drawn with numpy from a seed.  The emulation (three TF32
terms a k-step of 8, float32 sums) lies within 1e-5 of each gradient's
largest |value| of ``jax.grad``; the one-term product (hi.hi alone, plain
TF32) lands at least 10x further off, which is why every product is
split.  As in ``test_torch_attention_grad.py``, a row that sees no key
gets a zero output gradient (it is 0 in the kernels and the mean of v in
the reference).
"""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis_compat import given, settings, st
import torch_threads  # noqa: F401  (one torch thread a module)

from repro.kernels.ref import attention_reference
from repro_torch.kernels import flash_attention as fa

one_torch_thread = torch_threads.one_torch_thread


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16])
@pytest.mark.parametrize("D", [16, 32, 64, 96, 128, 256])
def test_bwd_route_sends_float32_to_split_tf32(dtype, D):
    """The split-TF32 backward serves float32 at every D of ``HEAD_DIMS``
    and bfloat16 at D = 32, and has a tile plan at each of them; bf16 at
    64, 128 and 256 stays on the bf16 tensor-core backward; float16 and
    other D raise."""
    assert sorted(fa.F32_BWD_PLANS) == sorted(fa.HEAD_DIMS)
    if dtype == torch.float16:
        with pytest.raises(TypeError):
            fa.bwd_route(dtype, D)
    elif D not in fa.HEAD_DIMS:
        with pytest.raises(ValueError):
            fa.bwd_route(dtype, D)
    elif dtype == torch.float32 or D == 32:
        assert fa.bwd_route(dtype, D) == "tf32x3"
    else:
        assert fa.bwd_route(dtype, D) == "tensor_core"


def _covered(Sq, Sk, G, causal, window, D, B=1, KVH=1):
    """How often each (head, query, key) triple is computed by the dk/dv
    plan and by the dq plan, checking that every unmasked tile holds only
    visible pairs inside the sequences and that each dk/dv block's tiles
    lie in its keys and its split's heads."""
    ok = fa.visible(Sq, Sk, causal, window).numpy()
    plan = fa.f32_bwd_tiles(Sq, Sk, G, causal, window, D, B, KVH)
    QT, BK = plan["kv_queries"], plan["kv_keys"]
    dkdv = np.zeros((G, Sq, Sk), np.int64)
    at = 0
    for n_block, (key0, z, n) in enumerate(plan["blocks"]):
        assert z == n_block % plan["hs"]      # a key block's splits in order
        g0, g1 = plan["heads"][z]
        for kw0, g, q0, masked in plan["dkdv"][at:at + n]:
            assert key0 <= kw0 < key0 + BK and (kw0 - key0) % 16 == 0
            assert g0 <= g < g1
            qs = slice(q0, min(q0 + QT, Sq))
            ks = slice(kw0, min(kw0 + 16, Sk))
            if masked:
                dkdv[g, qs, ks] += ok[qs, ks]
            else:
                assert q0 + QT <= Sq and kw0 + 16 <= Sk
                assert ok[qs, ks].all()
                dkdv[g, qs, ks] += 1
        at += n
    assert at == len(plan["dkdv"])
    rows, keys = plan["dq_rows"], plan["dq_keys"]
    dq = np.zeros((Sq * G, Sk), np.int64)
    okr = np.repeat(ok, G, axis=0)       # row r = query r // G, head r % G
    for row0, k0, masked in plan["dq"]:
        rs = slice(row0, min(row0 + rows, Sq * G))
        ks = slice(k0, min(k0 + keys, Sk))
        if masked:
            dq[rs, ks] += okr[rs, ks]
        else:
            assert k0 + keys <= Sk
            assert okr[rs, ks].all()
            dq[rs, ks] += 1
    dq = dq.reshape(Sq, G, Sk).transpose(1, 0, 2)
    return ok, dkdv, dq


@settings(max_examples=80, deadline=None)
@given(Sq=st.integers(1, 300), Sk=st.integers(1, 300),
       G=st.sampled_from([1, 2, 3, 4, 6, 16]), causal=st.booleans(),
       window=st.sampled_from([None, 1, 2, 7, 15, 16, 17, 64, 65, 200]),
       D=st.sampled_from([32, 64, 128, 256]), B=st.integers(1, 3),
       KVH=st.integers(1, 4))
def test_f32_bwd_tiles_cover_each_visible_triple_once(Sq, Sk, G, causal,
                                                      window, D, B, KVH):
    """Every visible (query, head, key) triple is computed exactly once by
    the dk/dv kernel's warp pairs (over all head splits) and exactly once
    by the dq kernel's blocks, and no invisible one is computed unmasked;
    the splits are hs equal runs of the group's heads."""
    plan = fa.f32_bwd_tiles(Sq, Sk, G, causal, window, D, B, KVH)
    hs = plan["hs"]
    assert G % hs == 0
    assert plan["heads"] == [(z * G // hs, (z + 1) * G // hs)
                             for z in range(hs)]
    ok, dkdv, dq = _covered(Sq, Sk, G, causal, window, D, B, KVH)
    want = np.broadcast_to(ok, (G, Sq, Sk)).astype(np.int64)
    assert np.array_equal(dkdv, want)
    assert np.array_equal(dq, want)


@pytest.mark.parametrize("shape,hs", [
    ((1, 2048, 1, 16, 256), 16),    # [train-families]' RecurrentGemma-9B
    ((8, 1024, 16, 1, 64), 1),      # [train]'s qwen1.5-0.5b in float32
    ((8, 1024, 8, 2, 128), 1),      # internlm2's heads
    ((1, 700, 1, 4, 256), 4),       # too few key blocks at any split
    ((4, 2048, 1, 16, 256), 4),     # four batches: a quarter of the heads
    ((2, 64, 2, 2, 32), 2),         # a reduced config: every head split
])
def test_f32_bwd_head_split(shape, hs):
    """RecurrentGemma's 32 key blocks of 64 keys (B = KVH = 1) reach 2 x
    132 blocks only at hs = 16 (8 x 32 = 256 fall short); [train]'s and
    internlm2's grids are large enough unsplit; a grid that no divisor
    fills splits every head.  The scratch holds delta and, where hs > 1,
    the partials from a 16-byte boundary."""
    B, Sk, KVH, G, D = shape
    assert fa.f32_bwd_head_split(B, Sk, KVH, G, D) == hs
    plan = fa.f32_bwd_tiles(Sk, Sk, G, True, None, D, B, KVH)
    assert plan["hs"] == hs and len(plan["heads"]) == hs
    H = G * KVH
    delta = -(-B * H * Sk // 4) * 4
    assert fa.f32_bwd_scratch(B, Sk, Sk, H, KVH, D) == delta + (
        2 * hs * B * Sk * KVH * D if hs > 1 else 0)


def test_f32_bwd_tiles_heaviest_first():
    """Causal: the dk/dv blocks run first keys first and the dq blocks
    last rows first, so the blocks with the most tiles start first."""
    plan = fa.f32_bwd_tiles(2048, 2048, 16, True, None, 256)
    per_key_block = [n for _, z, n in plan["blocks"] if z == 0]
    assert per_key_block == sorted(per_key_block, reverse=True)
    assert per_key_block[0] > per_key_block[-1]
    for D in fa.HEAD_DIMS:
        row0s = [row0 for row0, _, _ in
                 fa.f32_bwd_tiles(500, 500, 2, True, None, D)["dq"]]
        assert row0s == sorted(row0s, reverse=True)
        row0s = [row0 for row0, _, _ in
                 fa.f32_bwd_tiles(500, 500, 2, False, None, D)["dq"]]
        assert row0s == sorted(row0s)


def _rna_reference(x: np.ndarray) -> np.ndarray:
    """The TF32 value nearest to each float32 x, ties away from zero, by
    float64 arithmetic on the exponent (finite, normal x)."""
    x = x.astype(np.float64)
    ulp = 2.0 ** (np.floor(np.log2(np.abs(x))) - 10)
    q = np.abs(x) / ulp
    return (np.sign(x) * np.floor(q + 0.5) * ulp).astype(np.float32)


def test_split_tf32():
    """hi and lo are exact TF32 values (the low 13 bits of the mantissa
    zero), hi is x rounded to the nearest TF32 value with ties away from
    zero (cvt.rna), and hi + lo is x within 2^-22 |x|, over signs,
    exponents, exact ties and zero."""
    rng = np.random.default_rng(5)
    x = (rng.standard_normal(20000) * np.exp2(rng.integers(-60, 60, 20000))
         ).astype(np.float32)
    ties = (rng.integers(1, 2**10, 64) << 13 | 0x1000).astype(np.int32) \
        | (127 << 23)
    x = np.concatenate([x, ties.view(np.float32),
                        -ties.view(np.float32), [0.0, -0.0, 1.0, -3.5]]
                       ).astype(np.float32)
    hi, lo = (t.numpy() for t in fa.split_tf32(torch.from_numpy(x)))
    for part in (hi, lo):
        assert np.all(part.view(np.int32) & 0x1FFF == 0)
    nz = x != 0
    np.testing.assert_array_equal(hi[nz], _rna_reference(x[nz]))
    n = len(ties)
    assert np.all(np.abs(hi[-4 - 2 * n:-4 - n]) > np.abs(x[-4 - 2 * n:-4 - n]))
    err = np.abs(hi.astype(np.float64) + lo - x)
    assert np.all(err <= 2.0 ** -22 * np.abs(x.astype(np.float64)))
    assert np.all(hi[~nz] == 0) and np.all(lo[~nz] == 0)


def test_split_tf32_keeps_non_finite():
    """A NaN x gives a NaN hi whatever its payload (the add of half a TF32
    ulp would carry 0x7fffffff into the sign bit, and leave 0x7f800001 an
    infinity in the bits the MMA reads); an infinity gives itself."""
    bits = np.array([0x7FFFFFFF, 0x7F800001, 0x7FC00000, 0x7FFFF000,
                     0xFFC00000, 0xFFFFFFFF, 0x7F800000, 0xFF800000],
                    dtype=np.uint32).view(np.int32)
    hi, _ = fa.split_tf32(torch.from_numpy(bits).view(torch.float32))
    hi = hi.numpy()
    assert np.all(hi.view(np.int32) & 0x1FFF == 0)
    assert np.all(np.isnan(hi[:6]))
    np.testing.assert_array_equal(hi[6:], [np.inf, -np.inf])


@pytest.mark.parametrize("at", ["q", "do"])
def test_split_tf32_products_keep_nan(at):
    """One NaN in q or dO (the card's 0x7fffffff), through the kernels' arithmetic emulated in
    tile order, makes NaN the gradients it reaches, as in the plain
    backward: dq of its row, and dk and dv of every key that row sees
    (the head split's partials included; dv = P^T dO only in the NaN's
    column where dO holds it); the other (batch, kv head) groups stay
    finite."""
    B, Sq, Sk, H, KVH, D, causal, window = 2, 40, 40, 4, 1, 64, True, 16
    rng = np.random.default_rng(9)
    q, k, v, do = (torch.from_numpy(rng.standard_normal(shape).astype(
        np.float32)) for shape in ((B, Sq, H, D), (B, Sk, KVH, D),
                                   (B, Sk, KVH, D), (B, Sq, H, D)))
    row = 25      # the card's NaN, 0x7fffffff
    (q if at == "q" else do).view(torch.int32)[0, row, 0, 3] = 0x7FFFFFFF
    assert fa.f32_bwd_head_split(B, Sk, KVH, H, D) > 1
    o, lse = fa.flash_attention_plain(q, k, v, causal, window,
                                      return_lse=True)
    keys = fa.visible(Sq, Sk, causal, window)[row]
    for grads in (_emulated_bwd(q, k, v, o, do, lse, causal, window, 3),
                  fa.flash_attention_backward_plain(q, k, v, o, do, causal,
                                                    window)):
        dq, dk, dv = grads
        assert torch.isnan(dq[0, row, 0]).all()
        assert torch.isnan(dk[0, keys]).all()
        assert torch.isnan(dv[0, keys][..., 3 if at == "do" else slice(None)]
                           ).all()
        assert all(torch.isfinite(g[1]).all() for g in grads)


def _mm(a: torch.Tensor, b: torch.Tensor, terms: int) -> torch.Tensor:
    """a (..., M, K) b (..., K, N) as the kernels compute it: k-steps of 8
    in order, each adding lo.hi, hi.lo and hi.hi (terms = 3) or hi.hi
    alone (terms = 1) of the split operands into float32 sums."""
    K = a.shape[-1]
    ah, al = (x.unflatten(-1, (K // 8, 8)) for x in fa.split_tf32(a))
    bh, bl = (x.unflatten(-2, (K // 8, 8)) for x in fa.split_tf32(b))
    steps = [torch.einsum("...mck,...ckn->...cmn", x, y) for x, y in (
        ((al, bh), (ah, bl), (ah, bh)) if terms == 3 else ((ah, bh),))]
    out = torch.zeros(a.shape[:-1] + b.shape[-1:])
    for c in range(K // 8):
        for step in steps:
            out = out + step[..., c, :, :]
    return out


def _pad(x: torch.Tensor, start: int, n: int, axis: int) -> torch.Tensor:
    """x[start:start + n] along ``axis``, zeros past x's end."""
    piece = x.narrow(axis, start, min(n, x.shape[axis] - start))
    shape = list(piece.shape)
    shape[axis] = n - piece.shape[axis]
    return torch.cat([piece, torch.zeros(shape)], dim=axis)


def _emulated_bwd(q, k, v, o, do, lse, causal, window, terms):
    """(dq, dk, dv) of float32 inputs as the split-TF32 backward's kernels
    compute them, in the order of ``f32_bwd_tiles``, every (batch, kv
    head) at once: dq by row blocks and K/V tiles, dk and dv by warp
    pairs' 16 keys and Q/dO tiles, the head split's partials summed in
    order."""
    B, Sq, H, D = q.shape
    Sk, KVH = k.shape[1], k.shape[2]
    G = H // KVH
    scale = 1.0 / math.sqrt(D)
    plan = fa.f32_bwd_tiles(Sq, Sk, G, causal, window, D, B, KVH)
    ok = fa.visible(Sq, Sk, causal, window)
    delta = (do * o).sum(-1)                                  # (B, Sq, H)

    def by_rows(x):   # (B, Sq, H, ...) -> (B, KVH, Sq G, ...)
        x = x.reshape(B, Sq, KVH, G, *x.shape[3:]).transpose(1, 2)
        return x.reshape(B, KVH, Sq * G, *x.shape[4:])
    qr, dor, dlr = by_rows(q), by_rows(do), by_rows(delta)
    lser = by_rows(lse.transpose(1, 2))
    kr, vr = k.transpose(1, 2), v.transpose(1, 2)            # (B, KVH, Sk, D)
    okr = torch.repeat_interleave(ok, G, dim=0)              # (Sq G, Sk)

    R, KT = plan["dq_rows"], plan["dq_keys"]
    dq = torch.zeros(B, KVH, -(-Sq * G // R) * R, D)
    for row0, k0, _ in plan["dq"]:
        qt, dot = _pad(qr, row0, R, 2), _pad(dor, row0, R, 2)
        kt, vt = _pad(kr, k0, KT, 2), _pad(vr, k0, KT, 2)
        vis = _pad(_pad(okr.float(), row0, R, 0), k0, KT, 1) > 0
        s = _mm(qt, kt.transpose(-1, -2), terms)
        dp = _mm(dot, vt.transpose(-1, -2), terms)
        p = torch.where(vis, torch.exp(s * scale
                                       - _pad(lser, row0, R, 2)[..., None]),
                        0.0)
        ds = p * (dp - _pad(dlr, row0, R, 2)[..., None])
        dq[:, :, row0:row0 + R] += _mm(ds, kt, terms)
    dq = (dq[:, :, :Sq * G] * scale).reshape(B, KVH, Sq, G, D)
    dq = dq.transpose(1, 2).reshape(B, Sq, H, D)

    QT, BK, hs = plan["kv_queries"], plan["kv_keys"], plan["hs"]
    n_keys = -(-Sk // BK) * BK
    part = torch.zeros(hs, 2, B, KVH, n_keys, D)
    qh = q.reshape(B, Sq, KVH, G, D).permute(0, 2, 3, 1, 4)  # (B, KVH, G, Sq, D)
    doh = do.reshape(B, Sq, KVH, G, D).permute(0, 2, 3, 1, 4)
    lseh = lse.reshape(B, KVH, G, Sq)
    dlh = delta.reshape(B, Sq, KVH, G).permute(0, 2, 3, 1)
    at = 0
    for key0, z, n in plan["blocks"]:
        for kw0, g, q0, _ in plan["dkdv"][at:at + n]:
            kt, vt = _pad(kr, kw0, 16, 2), _pad(vr, kw0, 16, 2)
            qt, dot = _pad(qh[:, :, g], q0, QT, 2), _pad(doh[:, :, g], q0, QT, 2)
            vis = _pad(_pad(ok.float(), q0, QT, 0), kw0, 16, 1).T > 0
            st = _mm(kt, qt.transpose(-1, -2), terms)
            pt = torch.where(vis, torch.exp(
                st * scale - _pad(lseh[:, :, g], q0, QT, 2)[..., None, :]), 0.0)
            dpt = _mm(vt, dot.transpose(-1, -2), terms)
            dst = pt * (dpt - _pad(dlh[:, :, g], q0, QT, 2)[..., None, :])
            part[z, 1, :, :, kw0:kw0 + 16] += _mm(pt, dot, terms)
            part[z, 0, :, :, kw0:kw0 + 16] += _mm(dst, qt, terms)
        at += n
    total = part[0]
    for z in range(1, hs):
        total = total + part[z]
    dk = (total[0, :, :, :Sk] * scale).transpose(1, 2)
    dv = total[1, :, :, :Sk].transpose(1, 2)
    return dq, dk, dv


#: the eight shapes of tests/test_torch_cuda.py's
#: test_flash_attention_bwd_kernel_matches_plain, sequences cut short
#: (masks, GQA groups, D, Sq != Sk, windows, rows that see no key kept)
EMU_CASES = [  # (B, Sq, Sk, H, KVH, D, causal, window)
    (2, 70, 70, 4, 4, 64, True, None),
    (1, 65, 65, 8, 4, 128, True, None),
    (1, 40, 67, 8, 2, 32, False, None),
    (1, 70, 70, 10, 2, 64, True, 16),
    (1, 50, 50, 6, 1, 256, True, 12),
    (1, 40, 17, 4, 2, 64, False, 8),
    (2, 67, 40, 12, 2, 128, False, 10),
    (2, 32, 32, 16, 16, 64, True, None),
]


@pytest.mark.parametrize("case", EMU_CASES)
def test_split_tf32_products_match_jax_grad(case):
    """The kernels' arithmetic, emulated in their tile order with three
    TF32 terms a product, lies within 1e-5 of each gradient's largest
    |value| of jax.grad of repro's attention_reference in float32; with
    hi.hi alone (one TF32 product) each gradient lands at least 10x
    further off."""
    B, Sq, Sk, H, KVH, D, causal, window = case
    rng = np.random.default_rng(Sq * Sk + D + H)
    q = rng.standard_normal((B, Sq, H, D)).astype(np.float32)
    k = rng.standard_normal((B, Sk, KVH, D)).astype(np.float32)
    v = rng.standard_normal((B, Sk, KVH, D)).astype(np.float32)
    do = rng.standard_normal((B, Sq, H, D)).astype(np.float32)
    seen = fa.visible(Sq, Sk, causal, window).any(dim=1).numpy()
    do[:, ~seen] = 0.0

    def f(q, k, v):
        return jnp.sum(attention_reference(q, k, v, causal=causal,
                                           window=window) * do)
    want = [np.asarray(g)
            for g in jax.jit(jax.grad(f, argnums=(0, 1, 2)))(q, k, v)]
    tq, tk, tv, tdo = (torch.from_numpy(x) for x in (q, k, v, do))
    o, lse = fa.flash_attention_plain(tq, tk, tv, causal, window,
                                      return_lse=True)
    three = _emulated_bwd(tq, tk, tv, o, tdo, lse, causal, window, 3)
    one = _emulated_bwd(tq, tk, tv, o, tdo, lse, causal, window, 1)
    for name, g3, g1, ref in zip(("dq", "dk", "dv"), three, one, want):
        scale = float(np.max(np.abs(ref)))
        err3 = float(np.max(np.abs(g3.numpy() - ref)))
        err1 = float(np.max(np.abs(g1.numpy() - ref)))
        assert err3 <= 1e-5 * scale, (name, err3, scale)
        assert err1 >= 10 * err3, (name, err1, err3)
