"""The tensor-core attention backward's host side on the CPU: its routing
rule (``bwd_route``), a mirror of its kernels' tile plans (``bwd_tiles``:
at D 64 / 128 the fused kernel's blocks, tiles, dq order and turns, at
D = 256 its column halves and head split; ``bwd_head_split``,
``tc_bwd_scratch``) against ``visible()``, an emulation of the fused
kernel's sums, and of the D = 256 kernels' sums, in their plans' order
against ``jax.grad`` of ``repro``'s ``attention_reference``, the plain
forward's lse against
``jax.nn.logsumexp`` of the masked scores ``attention_reference`` builds,
the plain backward given the forward's lse, and ``flash_attention``
asking the forward for lse only where a gradient is needed.

Inputs are drawn with numpy from a seed.  lse: within 1e-6 of each
row's |lse| (float32 logsumexp in another order); the plain backward
given lse: bit for bit the one that recomputes it; the emulation:
within 2e-5 of each gradient's largest |value| (float32 sums in another
order than jax's).
"""
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
@pytest.mark.parametrize("D", [32, 64, 96, 128, 256])
def test_bwd_route(dtype, D):
    """bf16 at D 64, 128 and 256 on the tensor cores; float32 at every
    built D and bf16 at 32 in split TF32; float16 and D = 96 raise."""
    if dtype == torch.float16:
        with pytest.raises(TypeError):
            fa.bwd_route(dtype, D)
    elif D == 96:
        with pytest.raises(ValueError):
            fa.bwd_route(dtype, D)
    elif dtype == torch.bfloat16 and D in (64, 128, 256):
        assert fa.bwd_route(dtype, D) == "tensor_core"
    else:
        assert fa.bwd_route(dtype, D) == "tf32x3"


def _covered(Sq, Sk, G, causal, window, D, B=1, KVH=1):
    """How often each (head, query, key) triple is computed by the dk/dv
    plan (the warpgroups of one column part) and by the dq plan (at D 64 /
    128 the same tiles' partials), and whether every unmasked tile holds
    only visible pairs inside the sequences."""
    ok = fa.visible(Sq, Sk, causal, window).numpy()
    plan = fa.bwd_tiles(Sq, Sk, G, causal, window, D, B, KVH)
    dkdv = np.zeros((G, Sq, Sk), np.int64)
    for kw0, g, q0, masked in plan["dkdv"]:
        qs = slice(q0, min(q0 + fa.TC_BWD_QUERIES, Sq))
        ks = slice(kw0, min(kw0 + fa.TC_BWD_KEYS, Sk))
        if masked:
            dkdv[g, qs, ks] += ok[qs, ks]
        else:
            assert q0 + fa.TC_BWD_QUERIES <= Sq
            assert kw0 + fa.TC_BWD_KEYS <= Sk
            assert ok[qs, ks].all()
            dkdv[g, qs, ks] += 1
    if D != 256:
        return ok, dkdv, dkdv.copy()
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


@settings(max_examples=60, deadline=None)
@given(Sq=st.integers(1, 300), Sk=st.integers(1, 300), G=st.integers(1, 6),
       causal=st.booleans(), window=st.sampled_from([None, 1, 2, 7, 64, 65,
                                                     100, 200]),
       D=st.sampled_from([64, 128]))
def test_bwd_tiles_cover_each_visible_triple_once(Sq, Sk, G, causal,
                                                  window, D):
    """Every visible (query, head, key) triple is computed exactly once by
    the fused kernel's tiles for dk and dv (by one warpgroup at D = 64,
    once for each column half at 128) and exactly once for dq (the same
    tiles' dq partials), no invisible one is (masked tiles zero them), and
    a tile the kernel does not mask holds only visible pairs."""
    ok, dkdv, dq = _covered(Sq, Sk, G, causal, window, D)
    want = np.broadcast_to(ok, (G, Sq, Sk)).astype(np.int64)
    assert np.array_equal(dkdv, want)
    assert np.array_equal(dq, want)


@pytest.mark.parametrize("G,D", [(1, 64), (2, 128)])
def test_bwd_tiles_train_shapes(G, D):
    """[train]'s qwen1.5-0.5b (G = 1, D = 64) and internlm2's heads (G =
    2, D = 128), causal at S = 1,024: the fused kernel masks only the
    diagonal tiles, one a key group and head, skips the tile of a block's
    first queries in its second key group (D = 64), and computes under 7%
    more pairs than the causal band holds."""
    S = 1024
    plan = fa.bwd_tiles(S, S, G, True, None, D)
    masked = sorted((kw0, g, q0) for kw0, g, q0, m in plan["dkdv"] if m)
    assert masked == sorted((kw0, g, kw0) for kw0 in range(0, S, 64)
                            for g in range(G))
    computed = len(plan["dkdv"]) * fa.TC_BWD_KEYS * fa.TC_BWD_QUERIES
    seen = int(fa.visible(S, S, True, None).sum()) * G
    assert seen < computed <= 1.07 * seen


@settings(max_examples=60, deadline=None)
@given(Sq=st.integers(1, 300), Sk=st.integers(1, 300),
       G=st.sampled_from([1, 2, 3, 4, 6, 16]), causal=st.booleans(),
       window=st.sampled_from([None, 1, 2, 7, 64, 65, 100, 200]),
       B=st.integers(1, 3), KVH=st.integers(1, 4))
def test_bwd_tiles_d256_cover_each_triple_once_per_column_half(
        Sq, Sk, G, causal, window, B, KVH):
    """At D = 256 the dk/dv kernel's two column halves, [0, 128) and
    [128, 256), each compute every visible (query, head, key) triple
    exactly once (a warpgroup a half and key group, each through the whole
    tile plan), the dq kernel's blocks of 128 rows and 48-key tiles once,
    and no invisible triple is computed unmasked.  The head split's parts
    are hs contiguous, equal runs of the group's heads; each block's tiles
    lie in its keys and its part's heads, and its partials are summed in
    the order z = 0 .. hs - 1."""
    plan = fa.bwd_tiles(Sq, Sk, G, causal, window, 256, B, KVH)
    assert plan["columns"] == [(0, 128), (128, 256)]
    assert (plan["dq_rows"], plan["dq_keys"]) == (128, 48)
    hs = plan["hs"]
    assert G % hs == 0
    assert plan["heads"] == [(z * G // hs, (z + 1) * G // hs)
                             for z in range(hs)]
    at = 0
    for n_block, (key0, z, n) in enumerate(plan["blocks"]):
        assert z == n_block % hs      # a key block's splits in order
        g0, g1 = plan["heads"][z]
        for kw0, g, q0, _ in plan["dkdv"][at:at + n]:
            assert key0 <= kw0 < key0 + fa.TC_BWD_KEYS and g0 <= g < g1
        at += n
    assert at == len(plan["dkdv"])
    ok, dkdv, dq = _covered(Sq, Sk, G, causal, window, 256, B, KVH)
    want = np.broadcast_to(ok, (G, Sq, Sk)).astype(np.int64)
    assert np.array_equal(dkdv, want)
    assert np.array_equal(dq, want)


@pytest.mark.parametrize("shape,hs", [
    ((1, 2048, 1, 16, 256), 8),     # [train-families]' RecurrentGemma-9B
    ((8, 1024, 16, 1, 64), 1),      # [train]'s qwen1.5-0.5b
    ((8, 1024, 8, 2, 128), 1),      # internlm2's heads
    ((1, 700, 1, 4, 256), 4),       # too few key blocks at any split
    ((1, 2048, 8, 4, 128), 2),      # [train-bf16-8b]'s Qwen3-8B
    ((1, 700, 1, 4, 128), 4),       # 11 key blocks
])
def test_bwd_head_split(shape, hs):
    """bwd_head_split: RecurrentGemma's 32 key blocks of 64 keys (B = 1,
    KVH = 1) reach 2 x 132 warpgroups at hs = 8 (2 x 32 x 4 = 256 fall
    short); [train]'s and internlm2's grids are large enough unsplit, so
    the kernel writes dk and dv directly there; Qwen3-8B's 256 blocks
    split in two, which halves its heaviest blocks (the first keys, which
    the fused grid starts last); a grid that no divisor fills splits
    every head."""
    B, Sk, KVH, G, D = shape
    assert fa.bwd_head_split(B, Sk, KVH, G, D) == hs
    plan = fa.bwd_tiles(Sk, Sk, G, True, None, D, B, KVH)
    assert plan["hs"] == hs and len(plan["heads"]) == hs


def test_bwd_tiles_heaviest_first():
    """Causal: at D = 256 the dk/dv blocks run first keys first, so the
    blocks with the most tiles start first, and the dq blocks (a block an
    SM, 128 rows) last rows first; at D 64 and 128 the fused kernel's blocks run
    last keys first (a block waits for its dq turns only on blocks
    launched before it), each walking its query tiles first first."""
    plan = fa.bwd_tiles(2048, 2048, 16, True, None, 256)
    per_key_block = [n for _, z, n in plan["blocks"] if z == 0]
    assert per_key_block == sorted(per_key_block, reverse=True)
    assert per_key_block[0] > per_key_block[-1]
    row0s = [row0 for row0, _, _ in plan["dq"]]
    assert row0s == sorted(row0s, reverse=True)
    for D in (64, 128):
        plan = fa.bwd_tiles(1024, 1024, 2, True, None, D)
        per_key_block = [n for _, z, n in plan["blocks"] if z == 0]
        assert per_key_block == sorted(per_key_block)
        at = 0
        for _, _, n in plan["blocks"]:
            q0s = [q0 for _, _, q0, _ in plan["dkdv"][at:at + n]]
            assert q0s == sorted(q0s)
            at += n


@settings(max_examples=60, deadline=None)
@given(Sq=st.integers(1, 300), Sk=st.integers(1, 300),
       G=st.sampled_from([1, 2, 3, 4, 6]), causal=st.booleans(),
       window=st.sampled_from([None, 1, 2, 7, 64, 65, 100, 200]),
       D=st.sampled_from([64, 128]), B=st.integers(1, 2),
       KVH=st.integers(1, 3))
def test_fused_dq_turns(Sq, Sk, G, causal, window, D, B, KVH):
    """The fused kernel's dq order: each (head, query tile)'s key blocks
    add in descending order; the turn each block's writer computes
    (dq_turn) is the block's index in that order, so a tile's turns are 0,
    1, ... without a gap; a block waits (turn k > 0) only on the block
    holding turn k - 1, launched before it, and under a causal mask that
    block computes the tile earlier in its own walk, so no turn waits on a
    tile still to be computed.  A block's entries lie in its keys and its
    split's heads; each step of its walk (a query tile and head) holds one
    entry for each of its key groups that sees a pair of the tile (at D =
    64 two groups, each a warpgroup's), in ascending order, and one
    turn."""
    plan = fa.bwd_tiles(Sq, Sk, G, causal, window, D, B, KVH)
    blocks, tiles, turns = plan["blocks"], plan["dkdv"], plan["turns"]
    keys = fa.TC_BWD_BLOCK_KEYS[D]
    assert len(turns) == len(tiles)
    where = {}   # (key0, g, q0) -> (launch index of its block, step in it)
    at = 0
    for index, (key0, z, n) in enumerate(blocks):
        g0, g1 = plan["heads"][z]
        steps = []   # (g, q0, the step's last kw0, its first entry)
        for i, (kw0, g, q0, _) in enumerate(tiles[at:at + n]):
            assert key0 <= kw0 < min(key0 + keys, Sk) and g0 <= g < g1
            assert kw0 % fa.TC_BWD_KEYS == 0
            if steps and steps[-1][:2] == (g, q0):
                assert kw0 > steps[-1][2]
                assert turns[at + i] == turns[steps[-1][3]]
                steps[-1] = (g, q0, kw0, steps[-1][3])
            else:
                assert (key0, g, q0) not in where
                where[(key0, g, q0)] = (index, len(steps))
                steps.append((g, q0, kw0, at + i))
        at += n
    assert at == len(tiles)
    if D == 64:
        assert plan["wg"] == [kw0 % keys // 64 for kw0, _, _, _ in tiles]
    else:
        assert plan["wg"] is None
    for order in plan["dq_order"].values():
        assert order == sorted(order, reverse=True)
    for (kw0, g, q0, _), turn in zip(tiles, turns):
        key0 = kw0 - kw0 % keys
        order = plan["dq_order"][(g, q0)]
        assert turn == order.index(key0)
        if turn:
            mine = where[(key0, g, q0)]
            prev = where[(order[turn - 1], g, q0)]
            assert prev[0] < mine[0]
            if causal:
                assert prev[1] < mine[1]


def test_tc_bwd_scratch():
    """tc_bwd_scratch: at D 64 / 128 dq's tiles (B, H, ceil(Sq / 64), 64
    D) float32 and their turn counters (B, H, ceil(Sq / 64)), then, from
    the next multiple of 4 floats, the head split's partials (hs, 2, B,
    Sk, KVH, D); at D = 256 the partials alone (none unsplit)."""
    B, Sq, Sk, H, KVH = 2, 130, 200, 12, 2
    for D in (64, 128):
        hs = fa.bwd_head_split(B, Sk, KVH, H // KVH, D, Sq)
        tiles = B * H * 3
        at = -(-(tiles * 64 * D + tiles) // 4) * 4
        part = 2 * hs * B * Sk * KVH * D if hs > 1 else 0
        assert fa.tc_bwd_scratch(B, Sq, Sk, H, KVH, D) == at + part
    assert fa.tc_bwd_scratch(8, 1024, 1024, 16, 16, 64) == 8 * 16 * 16 * (
        64 * 64 + 1)
    assert fa.tc_bwd_scratch(1, 2048, 2048, 16, 1, 256) == 2 * 8 * 2048 * 256
    assert fa.tc_bwd_scratch(8, 1024, 1024, 16, 16, 256) == 0


EMU_CASES = [  # (B, Sq, Sk, H, KVH, D, causal, window)
    (1, 200, 200, 2, 1, 64, True, None),      # 4 key blocks: heads split
    (2, 150, 130, 4, 2, 128, True, 70),       # Sq > Sk, a window, G = 2
    (1, 130, 190, 3, 1, 64, False, None),     # Sq < Sk, bidirectional, G = 3
    (1, 190, 150, 4, 1, 128, False, 50),      # rows that see no key
]


def _emulate_fused(q, k, v, do, causal, window):
    """(dq, dk, dv) of float32 q, k, v, dO summed as the fused kernel sums
    them: each tile's dq partial dS K over one block's keys (at D = 64 its
    first key group's plus its second's, of those that take the tile),
    added into the tile in the plan's dq order; dk and dv of a key group
    over its tiles in order, the head split's partials added in split
    order; 1 / sqrt(D) applied to dq and dk last."""
    B, Sq, H, D = q.shape
    Sk, KVH = k.shape[1], k.shape[2]
    G = H // KVH
    plan = fa.bwd_tiles(Sq, Sk, G, causal, window, D, B, KVH)
    scale = np.float32(1.0 / np.sqrt(D))
    dq, dk, dv = np.zeros_like(q), np.zeros_like(k), np.zeros_like(v)
    for b in range(B):
        for kvh in range(KVH):
            kk = k[b, :, kvh]
            P, dS = _p_ds(q, k, v, do, causal, window, b, kvh)
            keys = fa.TC_BWD_BLOCK_KEYS[D]
            groups = {}   # (key0, g, q0) -> the key groups that take it
            for kw0, g, q0, _ in plan["dkdv"]:
                groups.setdefault((kw0 - kw0 % keys, g, q0), []).append(kw0)
            for (g, q0), order in plan["dq_order"].items():
                qs = slice(q0, q0 + 64)
                acc = None
                for key0 in order:
                    part = None
                    for kw0 in groups[(key0, g, q0)]:
                        ks = slice(kw0, kw0 + 64)
                        p = dS[g][qs, ks] @ kk[ks]
                        part = p if part is None else part + p
                    acc = part if acc is None else acc + part
                dq[b, qs, kvh * G + g] = acc * scale
            _emulate_dkdv(plan, q, do, P, dS, b, kvh, dk, dv)
    return dq, dk, dv


def _p_ds(q, k, v, do, causal, window, b, kvh):
    """({g: p}, {g: ds}) (Sq, Sk) float32 of the heads g of kv head kvh of
    batch b: p = exp(s - lse) over the visible keys, ds = p (do v^T -
    delta)."""
    Sq, H, D = q.shape[1:]
    Sk, KVH = k.shape[1], k.shape[2]
    G = H // KVH
    ok = fa.visible(Sq, Sk, causal, window).numpy()
    scale = np.float32(1.0 / np.sqrt(D))
    kk, vv = k[b, :, kvh], v[b, :, kvh]
    P, dS = {}, {}
    for g in range(G):
        h = kvh * G + g
        s = np.where(ok, (q[b, :, h] @ kk.T) * scale, -np.inf)
        m = np.max(s, axis=1, keepdims=True)
        m = np.where(np.isfinite(m), m, 0.0)
        lse = m + np.log(np.maximum(np.sum(np.exp(s - m), axis=1,
                                           keepdims=True), 1e-30))
        p = np.where(ok, np.exp(s - lse), 0.0).astype(np.float32)
        delta = np.sum(do[b, :, h] * (p @ vv), axis=1, keepdims=True)
        P[g] = p
        dS[g] = (p * (do[b, :, h] @ vv.T - delta)).astype(np.float32)
    return P, dS


def _emulate_dkdv(plan, q, do, P, dS, b, kvh, dk, dv):
    """dk, dv of kv head kvh of batch b into ``dk``, ``dv`` as the plan sums
    them: each key group's over its tiles in order, the head split's
    partials added in split order, 1 / sqrt(D) applied to dk last."""
    Sk, D = dk.shape[1], dk.shape[3]
    G = len(P)
    at = 0
    sums = {}
    for key0, z, n in plan["blocks"]:
        parts = {}
        for kw0, g, q0, _ in plan["dkdv"][at:at + n]:
            qs, ks = slice(q0, q0 + 64), slice(kw0, kw0 + 64)
            w = parts.setdefault(kw0, np.zeros(
                (2, min(kw0 + 64, Sk) - kw0, D), np.float32))
            w[0] += dS[g][qs, ks].T @ q[b, qs, kvh * G + g]
            w[1] += P[g][qs, ks].T @ do[b, qs, kvh * G + g]
        at += n
        for kw0, part in parts.items():
            sums[kw0] = part if z == 0 else sums[kw0] + part
    scale = np.float32(1.0 / np.sqrt(D))
    for kw0, tot in sums.items():
        dk[b, kw0:kw0 + 64, kvh] = tot[0] * scale
        dv[b, kw0:kw0 + 64, kvh] = tot[1]


def _emulate_d256(q, k, v, do, causal, window):
    """(dq, dk, dv) of float32 q, k, v, dO summed as the D = 256 kernels sum
    them: dq of each block of (query, head) rows over its K/V tiles in the
    plan's order, dk and dv as the dk/dv kernel (:func:`_emulate_dkdv`);
    1 / sqrt(D) applied to dq and dk last."""
    B, Sq, H, D = q.shape
    Sk, KVH = k.shape[1], k.shape[2]
    G = H // KVH
    plan = fa.bwd_tiles(Sq, Sk, G, causal, window, D, B, KVH)
    rows, keys = plan["dq_rows"], plan["dq_keys"]
    scale = np.float32(1.0 / np.sqrt(D))
    dq, dk, dv = np.zeros_like(q), np.zeros_like(k), np.zeros_like(v)
    for b in range(B):
        for kvh in range(KVH):
            kk = k[b, :, kvh]
            P, dS = _p_ds(q, k, v, do, causal, window, b, kvh)
            # row r: query r // G of head kvh G + r % G
            ds_rows = np.stack([dS[g] for g in range(G)], axis=1).reshape(
                Sq * G, Sk)
            acc = {}
            for row0, k0, _ in plan["dq"]:
                rs = slice(row0, min(row0 + rows, Sq * G))
                ks = slice(k0, min(k0 + keys, Sk))
                part = ds_rows[rs, ks] @ kk[ks]
                acc[row0] = part if row0 not in acc else acc[row0] + part
            for row0, a in acc.items():
                r = np.arange(row0, row0 + a.shape[0])
                dq[b, r // G, kvh * G + r % G] = a * scale
            _emulate_dkdv(plan, q, do, P, dS, b, kvh, dk, dv)
    return dq, dk, dv


D256_EMU_CASES = [  # (B, Sq, Sk, H, KVH, D, causal, window)
    (1, 200, 200, 4, 1, 256, True, 48),       # the window binding, hs = 4
    (1, 190, 150, 4, 2, 256, False, 30),      # rows that see no key
]


def _jax_grad_check(case, emulate):
    """emulate's (dq, dk, dv) against jax.grad of repro's
    attention_reference: within 2e-5 of each gradient's largest |value|,
    and dq exactly 0 on rows that see no key."""
    B, Sq, Sk, H, KVH, D, causal, window = case
    rng = np.random.default_rng(Sq + Sk + D)
    q = rng.standard_normal((B, Sq, H, D)).astype(np.float32)
    k = rng.standard_normal((B, Sk, KVH, D)).astype(np.float32)
    v = rng.standard_normal((B, Sk, KVH, D)).astype(np.float32)
    do = rng.standard_normal((B, Sq, H, D)).astype(np.float32)
    seen = fa.visible(Sq, Sk, causal, window).any(dim=1).numpy()
    do[:, ~seen] = 0.0    # jax gives rows that see no key a uniform p

    def f(q, k, v):
        return jnp.sum(attention_reference(q, k, v, causal=causal,
                                           window=window) * do)
    want = jax.grad(f, argnums=(0, 1, 2))(q, k, v)
    got = emulate(q, k, v, do, causal, window)
    for g, w in zip(got, want):
        w = np.asarray(w)
        scale = max(float(np.max(np.abs(w))), 1e-6)
        assert float(np.max(np.abs(g - w))) <= 2e-5 * scale
    assert np.all(got[0][:, ~seen] == 0.0)


@pytest.mark.parametrize("case", D256_EMU_CASES)
def test_d256_sums_match_jax_grad(case):
    """The D = 256 kernels' plan, emulated in float32 in its order of sums
    (dq's K/V tiles block of rows by block, dk and dv tile by tile, per key
    block and head split), gives jax.grad of repro's attention_reference
    (:func:`_jax_grad_check`)."""
    _jax_grad_check(case, _emulate_d256)


@pytest.mark.parametrize("case", EMU_CASES)
def test_fused_sums_match_jax_grad(case):
    """The fused kernel's plan, emulated in float32 in its order of sums
    (dq's partials block by block in descending order, dk and dv tile by
    tile, per key group and head split), gives jax.grad of repro's
    attention_reference: within 2e-5 of each gradient's largest |value|,
    and dq exactly 0 on rows that see no key (:func:`_jax_grad_check`)."""
    _jax_grad_check(case, _emulate_fused)


LSE_CASES = [  # (B, Sq, Sk, H, KVH, D, causal, window)
    (2, 16, 16, 4, 4, 8, True, None),
    (1, 13, 20, 4, 2, 16, False, 5),
    (1, 10, 4, 2, 1, 8, False, 2),        # rows past Sk + window: no key
    (2, 9, 12, 6, 1, 8, True, 3),
    (1, 70, 70, 4, 1, 256, True, 30),     # D = 256, the window binding
    (1, 33, 20, 4, 2, 256, False, 5),     # D = 256, rows that see no key
]


@pytest.mark.parametrize("case", LSE_CASES)
def test_plain_lse_is_logsumexp_of_repros_masked_scores(case):
    """flash_attention_plain's lse is jax.nn.logsumexp of the scores
    masked with -1e30 as repro's attention_reference masks them, on every
    row that sees a key; a row that sees none gets 0 (the kernels' value)
    where the masked logsumexp is -1e30 + log Sk."""
    B, Sq, Sk, H, KVH, D, causal, window = case
    rng = np.random.default_rng(Sq * Sk + D)
    q = rng.standard_normal((B, Sq, H, D)).astype(np.float32)
    k = rng.standard_normal((B, Sk, KVH, D)).astype(np.float32)
    v = rng.standard_normal((B, Sk, KVH, D)).astype(np.float32)
    G = H // KVH
    s = jnp.einsum("bqhgd,bkhd->bqhgk", q.reshape(B, Sq, KVH, G, D), k) \
        / (D ** 0.5)
    dpos = jnp.arange(Sq)[:, None] - jnp.arange(Sk)[None, :]
    okj = jnp.ones(dpos.shape, bool)
    if causal:
        okj &= dpos >= 0
    if window is not None:
        okj &= dpos < window
    s = jnp.where(okj[None, :, None, None, :], s, -1e30)
    want = np.asarray(jax.nn.logsumexp(s, axis=-1))      # (B, Sq, KVH, G)
    want = want.reshape(B, Sq, H).transpose(0, 2, 1)     # (B, H, Sq)
    out, lse = fa.flash_attention_plain(*(torch.from_numpy(x)
                                          for x in (q, k, v)),
                                        causal, window, return_lse=True)
    assert lse.shape == (B, H, Sq) and lse.dtype == torch.float32
    assert torch.equal(out, fa.flash_attention_plain(
        *(torch.from_numpy(x) for x in (q, k, v)), causal, window))
    seen = fa.visible(Sq, Sk, causal, window).any(dim=1).numpy()
    got = lse.numpy()
    np.testing.assert_allclose(got[:, :, seen], want[:, :, seen],
                               rtol=1e-6, atol=1e-6)
    assert np.all(got[:, :, ~seen] == 0.0)
    assert np.all(want[:, :, ~seen] < -1e29)


def test_flash_attention_asks_for_lse_only_with_a_gradient(monkeypatch):
    """flash_attention asks the forward for lse where a gradient is
    needed, and not under no_grad or for inputs that need none (the
    serving path), whose output is the same either way."""
    calls = []
    plain = fa.flash_attention_plain

    def spy(*args, return_lse=False, **kwargs):
        calls.append(return_lse)
        return plain(*args, return_lse=return_lse, **kwargs)
    monkeypatch.setattr(fa, "flash_attention_plain", spy)
    rng = np.random.default_rng(3)
    q, k, v = (torch.from_numpy(rng.standard_normal(shape).astype(
        np.float32)) for shape in ((1, 9, 4, 8), (1, 9, 2, 8), (1, 9, 2, 8)))
    served = fa.flash_attention(q, k, v)
    leaf = q.clone().requires_grad_(True)
    with torch.no_grad():
        fa.flash_attention(leaf, k, v)
    trained = fa.flash_attention(leaf, k, v)
    assert calls == [False, False, True]
    assert torch.equal(served, trained.detach())
    trained.sum().backward()
    assert leaf.grad is not None and torch.isfinite(leaf.grad).all()
