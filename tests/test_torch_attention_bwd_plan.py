"""The tensor-core attention backward's host side on the CPU: its routing
rule (``bwd_route``), a mirror of its kernels' tile plans (``bwd_tiles``,
at D = 256 with its column halves and head split, ``bwd_head_split``)
against ``visible()``, the plain forward's lse against
``jax.nn.logsumexp`` of the masked scores ``repro``'s
``attention_reference`` builds, the plain backward given the forward's
lse, and ``flash_attention`` asking the forward for lse only where a
gradient is needed.

Inputs are drawn with numpy from a seed.  lse: within 1e-6 of each
row's |lse| (float32 logsumexp in another order); the plain backward
given lse: bit for bit the one that recomputes it.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis_compat import given, settings, st
import torch_threads  # noqa: F401  (one torch thread a module)

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
    plan (the warpgroups of one column part) and by the dq plan, and
    whether every unmasked tile holds only visible pairs inside the
    sequences."""
    ok = fa.visible(Sq, Sk, causal, window).numpy()
    plan = fa.bwd_tiles(Sq, Sk, G, causal, window, D, B, KVH)
    rows, keys = plan["dq_rows"], plan["dq_keys"]
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
    the dk/dv kernel's tiles (blocks of three warpgroups at D = 64, two at
    128) and exactly once by the dq kernel's, no invisible one is (masked
    tiles zero them), and a tile the kernels do not mask holds only
    visible pairs."""
    ok, dkdv, dq = _covered(Sq, Sk, G, causal, window, D)
    want = np.broadcast_to(ok, (G, Sq, Sk)).astype(np.int64)
    assert np.array_equal(dkdv, want)
    assert np.array_equal(dq, want)


@pytest.mark.parametrize("G,D", [(1, 64), (2, 128)])
def test_bwd_tiles_train_shapes(G, D):
    """[train]'s qwen1.5-0.5b (G = 1, D = 64) and internlm2's heads (G =
    2, D = 128), causal at S = 1,024: the dk/dv kernel masks only the
    diagonal tiles, one a warpgroup and head, skips the tiles below the
    diagonal in a block's later warpgroups, and computes under 7% more
    pairs than the causal band holds."""
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
    tile plan), the dq kernel's blocks of 64 rows and 64-key tiles once,
    and no invisible triple is computed unmasked.  The head split's parts
    are hs contiguous, equal runs of the group's heads; each block's tiles
    lie in its keys and its part's heads, and its partials are summed in
    the order z = 0 .. hs - 1."""
    plan = fa.bwd_tiles(Sq, Sk, G, causal, window, 256, B, KVH)
    assert plan["columns"] == [(0, 128), (128, 256)]
    assert (plan["dq_rows"], plan["dq_keys"]) == (64, 64)
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
])
def test_bwd_head_split(shape, hs):
    """bwd_head_split: RecurrentGemma's 32 key blocks of 64 keys (B = 1,
    KVH = 1) reach 2 x 132 warpgroups at hs = 8 (2 x 32 x 4 = 256 fall
    short); [train]'s and internlm2's grids are large enough unsplit, so
    the dk/dv kernel writes its gradients directly there; a grid that no
    divisor fills splits every head."""
    B, Sk, KVH, G, D = shape
    assert fa.bwd_head_split(B, Sk, KVH, G, D) == hs
    plan = fa.bwd_tiles(Sk, Sk, G, True, None, D, B, KVH)
    assert plan["hs"] == hs and len(plan["heads"]) == hs


def test_bwd_tiles_heaviest_first():
    """Causal: the dk/dv blocks run first keys first, so the blocks with
    the most tiles start first; the dq blocks at D = 256 (a block an SM)
    last rows first, at D 64 and 128 in row order."""
    plan = fa.bwd_tiles(2048, 2048, 16, True, None, 256)
    per_key_block = [n for _, z, n in plan["blocks"] if z == 0]
    assert per_key_block == sorted(per_key_block, reverse=True)
    assert per_key_block[0] > per_key_block[-1]
    row0s = [row0 for row0, _, _ in plan["dq"]]
    assert row0s == sorted(row0s, reverse=True)
    for D in (64, 128):
        row0s = [row0 for row0, _, _ in
                 fa.bwd_tiles(1024, 1024, 2, True, None, D)["dq"]]
        assert row0s == sorted(row0s)


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
