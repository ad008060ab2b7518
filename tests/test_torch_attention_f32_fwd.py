"""The split-TF32 attention forward's host side on the CPU: a mirror of
its tile plan (``f32_fwd_tiles``) against ``visible()``, and its
arithmetic emulated in its tile order against ``repro``'s Pallas
``flash_attention`` in interpret mode (at shapes its block asserts take)
and ``repro.kernels.ref.attention_reference`` (at ragged shapes), in
float32.

Inputs are drawn with numpy from a seed.  The emulation (S = Q K^T and O
+= P V as three TF32 terms a k-step of 8 of split operands, S's k-steps
each summed apart and then added, D halved and the halves' partial S
added at D = 256, the online softmax's exponents in log2 units over the
kernel's 32-key tiles, float32 throughout) lies within 1e-5 of
the largest |o| of the reference, and its lse within 1e-5 of the largest
|lse|; with hi.hi alone (one TF32 product) o lands at least 10x further
off, which is why every product is split.  A row that sees no key is 0
in the kernel and the mean of v in the reference: such rows are compared
with 0.
"""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis_compat import given, settings, st
import torch_threads  # noqa: F401  (one torch thread a module)

from repro.kernels.flash_attention import flash_attention as j_flash
from repro.kernels.ref import attention_reference
from repro_torch.kernels import flash_attention as fa
from test_torch_attention_f32_bwd_plan import _pad

one_torch_thread = torch_threads.one_torch_thread


@settings(max_examples=80, deadline=None)
@given(Sq=st.integers(1, 300), Sk=st.integers(1, 300),
       G=st.sampled_from([1, 2, 3, 4, 6, 16]), causal=st.booleans(),
       window=st.sampled_from([None, 1, 2, 7, 31, 32, 33, 64, 200]),
       D=st.sampled_from([32, 64, 128, 256]))
def test_f32_fwd_tiles_cover_each_visible_triple_once(Sq, Sk, G, causal,
                                                      window, D):
    """Every visible (query, head, key) triple of a (batch, kv head) is in
    exactly one tile the forward visits, and a tile computed unmasked
    holds only visible pairs inside the sequences; the blocks run in
    launch order, the last rows first under a causal mask."""
    plan = fa.f32_fwd_tiles(Sq, Sk, G, causal, window, D)
    rows, keys = plan["rows"], plan["keys"]
    assert (rows, keys, plan["stages"], plan["halves"]) == fa.F32_FWD_PLANS[D]
    assert rows == 16 * 8 // plan["halves"]      # 8 warps a block
    ok = fa.visible(Sq, Sk, causal, window).numpy()
    okr = np.repeat(ok, G, axis=0)               # row r: query r // G
    seen = np.zeros((Sq * G, Sk), np.int64)
    for row0, k0, masked in plan["tiles"]:
        rs = slice(row0, min(row0 + rows, Sq * G))
        ks = slice(k0, min(k0 + keys, Sk))
        if masked:
            seen[rs, ks] += okr[rs, ks]
        else:
            assert k0 + keys <= Sk and okr[rs, ks].all()
            seen[rs, ks] += 1
    assert np.array_equal(seen, okr.astype(np.int64))
    row0s = [row0 for row0, _, _ in plan["tiles"]]
    assert row0s == sorted(row0s, reverse=causal)


def test_f32_fwd_plan_at_the_served_shapes():
    """[serve-consistency]'s RecurrentGemma-9B (1, 4,097, 16, 1, 256),
    window 2,048: 1,025 blocks of 64 rows, 16 heads of 4 queries sharing
    every K/V tile, at most 65 tiles a block; [train]'s (8, 1,024, 16,
    16, 64) causal: 8 blocks of 128 rows a (batch, head), the last the
    heaviest, first."""
    plan = fa.f32_fwd_tiles(4097, 4097, 16, True, 2048, 256)
    blocks = sorted({row0 for row0, _, _ in plan["tiles"]})
    assert len(blocks) == 1025 and plan["rows"] == 64
    per_block = [sum(1 for r, _, _ in plan["tiles"] if r == row0)
                 for row0 in blocks]
    assert max(per_block) == 65 and min(per_block) == 1
    plan = fa.f32_fwd_tiles(1024, 1024, 1, True, None, 64)
    firsts = [row0 for row0, _, _ in plan["tiles"]]
    assert firsts[0] == 896 and len(set(firsts)) == 8
    assert firsts.count(896) == 32 and firsts.count(0) == 4


def _mm_into(out, a, b, terms, fresh=False):
    """out + a (..., M, K) b (..., K, N) as the kernel's mma.sync chains
    compute it: k-steps of 8 in order, each adding lo.hi, hi.lo and hi.hi
    (terms = 3) or hi.hi alone (terms = 1) of the split operands into the
    float32 accumulator, or (``fresh``, as S is formed) into a zero one
    that is then added to ``out``."""
    K = a.shape[-1]
    ah, al = (x.unflatten(-1, (K // 8, 8)) for x in fa.split_tf32(a))
    bh, bl = (x.unflatten(-2, (K // 8, 8)) for x in fa.split_tf32(b))
    steps = [torch.einsum("...mck,...ckn->...cmn", x, y) for x, y in (
        ((al, bh), (ah, bl), (ah, bh)) if terms == 3 else ((ah, bh),))]
    for c in range(K // 8):
        t = torch.zeros_like(out) if fresh else out
        for step in steps:
            t = t + step[..., c, :, :]
        out = out + t if fresh else t
    return out


def _emulated_fwd(q, k, v, causal, window, terms):
    """(o, lse) of float32 inputs as the split-TF32 forward computes them,
    in the order of ``f32_fwd_tiles``, every (batch, kv head) at once."""
    B, Sq, H, D = q.shape
    Sk, KVH = k.shape[1], k.shape[2]
    G = H // KVH
    plan = fa.f32_fwd_tiles(Sq, Sk, G, causal, window, D)
    R, KT, halves = plan["rows"], plan["keys"], plan["halves"]
    scale = torch.tensor(1.0 / math.sqrt(D), dtype=torch.float32)
    scale_log2 = torch.tensor(1.4426950408889634, dtype=torch.float32) * scale
    qr = q.reshape(B, Sq, KVH, G, D).transpose(1, 2).reshape(B, KVH, Sq * G, D)
    kr, vr = k.transpose(1, 2), v.transpose(1, 2)          # (B, KVH, Sk, D)
    okr = torch.repeat_interleave(fa.visible(Sq, Sk, causal, window), G,
                                  dim=0)                   # (Sq G, Sk)
    n_rows = -(-Sq * G // R) * R
    acc = torch.zeros(B, KVH, n_rows, D)
    m = torch.full((B, KVH, n_rows), -math.inf)    # raw scores' max
    m2 = torch.full((B, KVH, n_rows), -math.inf)   # m scale log2e
    l = torch.zeros(B, KVH, n_rows)  # noqa: E741
    cols = D // halves
    for row0, k0, _ in plan["tiles"]:
        at = slice(row0, row0 + R)
        qt = _pad(qr, row0, R, 2)
        kt, vt = _pad(kr, k0, KT, 2), _pad(vr, k0, KT, 2)
        vis = _pad(_pad(okr.float(), row0, R, 0), k0, KT, 1) > 0
        s = _mm_into(torch.zeros(B, KVH, R, KT), qt[..., :cols],
                     kt[..., :cols].transpose(-1, -2), terms, fresh=True)
        if halves == 2:
            s = s + _mm_into(torch.zeros(B, KVH, R, KT), qt[..., cols:],
                             kt[..., cols:].transpose(-1, -2), terms,
                             fresh=True)
        s = torch.where(vis, s, -math.inf)
        # fmaxf: a NaN score drops out of the max (and makes p NaN)
        mx = torch.fmax(m[..., at], torch.where(torch.isnan(s), -math.inf,
                                                s).amax(-1))
        mu = torch.where(mx == -math.inf, 0.0, mx * scale_log2)
        alpha = torch.exp2(m2[..., at] - mu)
        # p = 2^fma(s, scale log2e, -mu): one rounding, as the kernel's fmaf
        p = torch.exp2((s.double() * scale_log2.double()
                        - mu[..., None].double()).float())
        l[..., at] = l[..., at] * alpha + p.sum(-1)
        m[..., at] = mx
        m2[..., at] = torch.where(mx == -math.inf, -math.inf, mu)
        acc[..., at, :] = _mm_into(acc[..., at, :] * alpha[..., None], p, vt,
                                   terms)
    o = acc / torch.clamp_min(l, 1e-30)[..., None]
    o = o[:, :, :Sq * G].reshape(B, KVH, Sq, G, D).transpose(1, 2)
    lse = torch.where(l > 0, m * scale + torch.log(l), 0.0)
    lse = lse[:, :, :Sq * G].reshape(B, KVH, Sq, G).permute(0, 1, 3, 2)
    return o.reshape(B, Sq, H, D), lse.reshape(B, H, Sq)


def _reference_lse(q, k, causal, window):
    """m + log l over each row's visible keys in float64, 0 where none."""
    B, Sq, H, D = q.shape
    Sk, KVH = k.shape[1], k.shape[2]
    G = H // KVH
    s = np.einsum("bqhgd,bkhd->bhgqk",
                  q.reshape(B, Sq, KVH, G, D).astype(np.float64),
                  k.astype(np.float64)) / math.sqrt(D)
    ok = fa.visible(Sq, Sk, causal, window).numpy()
    s = np.where(ok, s, -np.inf)
    m = s.max(-1, keepdims=True)
    m = np.where(np.isfinite(m), m, 0.0)
    total = np.exp(s - m).sum(-1, keepdims=True)
    out = (m + np.log(np.where(total > 0, total, 1.0)))[..., 0]
    return out.reshape(B, H, Sq)


def _check(q, k, v, causal, window, want):
    """The emulation against ``want`` (the reference's o): o within 1e-5
    of its largest |value| and lse within 1e-5 of the largest |lse|; rows
    that see no key 0; the one-term product >= 10x further off."""
    Sq, Sk = q.shape[1], k.shape[1]
    seen = fa.visible(Sq, Sk, causal, window).any(dim=1).numpy()
    want = np.where(seen[None, :, None, None], want, 0.0)
    tq, tk, tv = (torch.from_numpy(x) for x in (q, k, v))
    o3, lse3 = _emulated_fwd(tq, tk, tv, causal, window, 3)
    o1, _ = _emulated_fwd(tq, tk, tv, causal, window, 1)
    scale = float(np.max(np.abs(want)))
    err3 = float(np.max(np.abs(o3.numpy() - want)))
    err1 = float(np.max(np.abs(o1.numpy() - want)))
    assert err3 <= 1e-5 * scale, (err3, scale)
    assert err1 >= 10 * err3, (err1, err3)
    assert np.all(o3.numpy()[:, ~seen] == 0)
    lse_want = _reference_lse(q, k, causal, window)
    lse_err = float(np.max(np.abs(lse3.numpy() - lse_want)))
    assert lse_err <= 1e-5 * float(np.max(np.abs(lse_want))), lse_err
    o_plain, lse_plain = fa.flash_attention_plain(tq, tk, tv, causal, window,
                                                  return_lse=True)
    assert float((lse_plain - lse3).abs().max()) <= 1e-5 * float(
        np.max(np.abs(lse_want)))


def _qkv(shape, seed):
    B, Sq, Sk, H, KVH, D = shape
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((B, Sq, H, D)).astype(np.float32),
            rng.standard_normal((B, Sk, KVH, D)).astype(np.float32),
            rng.standard_normal((B, Sk, KVH, D)).astype(np.float32))


#: shapes ``repro``'s Pallas kernel takes (Sq, Sk multiples of its 32-row
#: blocks): every D, GQA, a window, bidirectional
PALLAS_CASES = [  # (B, Sq, Sk, H, KVH, D, causal, window)
    (2, 128, 128, 4, 2, 64, True, None),
    (1, 96, 96, 16, 1, 256, True, 40),
    (1, 64, 64, 4, 4, 32, False, None),
    (1, 128, 128, 6, 2, 128, True, 17),
]


@pytest.mark.parametrize("case", PALLAS_CASES)
def test_split_tf32_forward_matches_pallas_kernel(case):
    """The forward's arithmetic, emulated in its tile order, against
    ``repro``'s Pallas kernel in interpret mode."""
    B, Sq, Sk, H, KVH, D, causal, window = case
    q, k, v = _qkv((B, Sq, Sk, H, KVH, D), Sq + D + H)
    want = np.asarray(j_flash(*(jnp.asarray(x) for x in (q, k, v)),
                              causal=causal, window=window, q_block=32,
                              kv_block=32, interpret=True))
    _check(q, k, v, causal, window, want)


#: ragged shapes: Sq != Sk, rows that see no key, keys no row sees, a
#: window of 1, GQA groups that split the 64- and 128-row blocks unevenly
RAGGED_CASES = [  # (B, Sq, Sk, H, KVH, D, causal, window)
    (1, 70, 45, 3, 1, 64, True, None),
    (2, 40, 67, 8, 2, 32, False, None),
    (1, 50, 50, 6, 1, 256, True, 12),
    (1, 40, 17, 4, 2, 128, False, 8),
    (1, 33, 33, 5, 5, 64, True, 1),
]


@pytest.mark.parametrize("case", RAGGED_CASES)
def test_split_tf32_forward_matches_reference(case):
    """The same at ragged shapes against ``attention_reference``."""
    B, Sq, Sk, H, KVH, D, causal, window = case
    q, k, v = _qkv((B, Sq, Sk, H, KVH, D), 7 * Sq + Sk + D)
    want = np.asarray(jax.jit(attention_reference, static_argnums=(3, 4))(
        q, k, v, causal, window))
    _check(q, k, v, causal, window, want)


@pytest.mark.parametrize("at", ["q", "k", "v"])
def test_split_tf32_forward_keeps_nan(at):
    """One NaN in q, k or v (the card's 0x7fffffff), through the
    forward's arithmetic emulated in tile order, makes NaN the outputs of
    every row that sees it (a NaN in v: that column), as in the plain
    version; the other batch entry stays finite."""
    B, Sq, H, KVH, D, causal, window = 2, 60, 4, 2, 64, True, 16
    q, k, v = (torch.from_numpy(x) for x in
               _qkv((B, Sq, Sq, H, KVH, D), 5))
    pos = 30
    (q if at == "q" else k if at == "k" else v).view(torch.int32)[
        0, pos, 0, 3] = 0x7FFFFFFF
    if at == "q":
        rows, heads = torch.zeros(Sq, dtype=torch.bool), slice(0, 1)
        rows[pos] = True
    else:
        rows, heads = fa.visible(Sq, Sq, causal, window)[:, pos], slice(0, 2)
    cols = 3 if at == "v" else slice(None)
    for o in (_emulated_fwd(q, k, v, causal, window, 3)[0],
              fa.flash_attention_plain(q, k, v, causal, window)):
        assert torch.isnan(o[0, rows, heads][..., cols]).all()
        assert torch.isfinite(o[1]).all()
