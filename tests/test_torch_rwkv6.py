"""Port parity for RWKV6: the WKV scan kernel's plain version against
``repro``'s Pallas kernel (interpret mode) and its jnp oracle, and the
time-mix / channel-mix blocks against ``repro``'s, from params that
``repro`` initialised and handed over through the weight bridge.

Tolerances: the scan's plain loop and both of ``repro``'s sum the same
float32 products over n in another order, so they agree within rtol =
atol = 1e-5 (the Pallas test's own 1e-4 leaves room the port does not
need); the blocks add float32 GEMMs summed in other orders, so 1e-5 in
float32.  In bfloat16 every op rounds in both packages, not always at
the same places: the time-mix output is a bf16 GEMM over a group norm
that was computed in float32 and rounded to bf16, so the two packages
may differ by two rounding steps of bf16 at magnitudes near 1, and the
bf16 cases hold 2e-2 (the bf16 tolerance of tests/test_kernels.py's
attention).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCHS as JARCHS
from repro.kernels import ref as jref
from repro.kernels.rwkv6_scan import rwkv6_scan as j_scan
from repro.models import rwkv6 as JR
from repro_torch.configs.registry import ARCHS as TARCHS
from repro_torch.kernels import ops, ref
from repro_torch.kernels import rwkv6_scan as twk
from repro_torch.models import params as TP
from repro_torch.models import rwkv6 as TR

TOL = dict(rtol=1e-5, atol=1e-5)
BF16_TOL = dict(rtol=2e-2, atol=2e-2)


def _wkv(B, S, H, N, seed=0):
    """r, k, v, w, u, state0 as float32 numpy, decays near 1 (the inputs
    of tests/test_kernels.py's WKV cases)."""
    rng = np.random.default_rng(seed)

    def randn(*shape, scale=1.0):
        return (rng.standard_normal(shape) * scale).astype(np.float32)
    r, k, v = (randn(B, S, H, N, scale=0.5) for _ in range(3))
    w = (1.0 / (1.0 + np.exp(-(randn(B, S, H, N) + 2.0)))).astype(np.float32)
    return r, k, v, w, randn(H, N, scale=0.3), randn(B, H, N, N, scale=0.1)


def _torch(arrays):
    return tuple(torch.from_numpy(a) for a in arrays)


def _jax(arrays):
    return tuple(jnp.asarray(a) for a in arrays)


# the shapes of tests/test_kernels.py
@pytest.mark.parametrize("B,S,H,N", [(1, 32, 2, 8), (2, 64, 2, 16),
                                     (1, 128, 4, 32)])
def test_scan_plain_matches_pallas_kernel(B, S, H, N):
    args = _wkv(B, S, H, N, seed=S + N)
    y_want, s_want = j_scan(*_jax(args), t_block=16, interpret=True)
    y, st = ops.rwkv6(*_torch(args))
    np.testing.assert_allclose(y.numpy(), np.asarray(y_want), **TOL)
    np.testing.assert_allclose(st.numpy(), np.asarray(s_want), **TOL)


@pytest.mark.parametrize("B,S,H,N", [(1, 32, 2, 8), (2, 64, 2, 16),
                                     (1, 128, 4, 32), (2, 16, 2, 64)])
def test_scan_plain_matches_reference(B, S, H, N):
    args = _wkv(B, S, H, N, seed=B * S + N)
    y_want, s_want = jref.rwkv6_reference(*_jax(args))
    y, st = ops.rwkv6(*_torch(args))
    np.testing.assert_allclose(y.numpy(), np.asarray(y_want), **TOL)
    np.testing.assert_allclose(st.numpy(), np.asarray(s_want), **TOL)


@pytest.mark.parametrize("t_block", [8, 64])
def test_scan_time_block_carry(t_block):
    """One pass of the port's scan equals the Pallas kernel however it
    cuts time into blocks (its state carried in scratch across them)."""
    r, k, v, w, u, _ = _wkv(1, 64, 2, 8, seed=9)
    s0 = np.zeros((1, 2, 8, 8), np.float32)
    args = (r, k, v, w, u, s0)
    y_want, s_want = j_scan(*_jax(args), t_block=t_block, interpret=True)
    y, st = ops.rwkv6(*_torch(args))
    np.testing.assert_allclose(y.numpy(), np.asarray(y_want), **TOL)
    np.testing.assert_allclose(st.numpy(), np.asarray(s_want), **TOL)


def test_scan_state_chaining():
    """Two halves with the state carried equal one full pass (decode
    chunking correctness), against repro's oracle."""
    args = _wkv(1, 64, 2, 8, seed=10)
    r, k, v, w, u, s0 = _torch(args)
    y_want, s_want = jref.rwkv6_reference(*_jax(args))
    half = 32
    y1, s_mid = ops.rwkv6(*(t[:, :half].contiguous() for t in (r, k, v, w)),
                          u, s0)
    y2, s_end = ops.rwkv6(*(t[:, half:].contiguous() for t in (r, k, v, w)),
                          u, s_mid)
    np.testing.assert_allclose(torch.cat([y1, y2], 1).numpy(),
                               np.asarray(y_want), **TOL)
    np.testing.assert_allclose(s_end.numpy(), np.asarray(s_want), **TOL)


@pytest.mark.parametrize("S", [33, 1])
def test_scan_ragged_matches_reference(S):
    """Lengths the Pallas kernel cannot tile (33) and a decode step (1):
    the oracle only.  The plain version is the port's oracle's loop, bit
    for bit, and leaves state0 as it was."""
    args = _wkv(2, S, 3, 16, seed=S)
    y_want, s_want = jref.rwkv6_reference(*_jax(args))
    t_args = _torch(args)
    s0_in = t_args[-1].clone()
    y, st = ops.rwkv6(*t_args)
    np.testing.assert_allclose(y.numpy(), np.asarray(y_want), **TOL)
    np.testing.assert_allclose(st.numpy(), np.asarray(s_want), **TOL)
    y_ref, s_ref = ref.rwkv6_reference(*t_args)
    assert torch.equal(y, y_ref) and torch.equal(st, s_ref)
    assert torch.equal(t_args[-1], s0_in)


# the shapes of tests/test_kernels.py
@pytest.mark.parametrize("B,S,H,N", [(1, 32, 2, 8), (2, 64, 2, 16),
                                     (1, 128, 4, 32)])
def test_factored_bonus_matches_pallas_kernel(B, S, H, N):
    """The identity the Hopper kernel computes, y_t = sum_n r_n S[n] +
    v (sum_n r_n u_n k_n) with the bonus as one scalar per (t, h), written
    out here in torch, against repro's Pallas kernel in interpret mode."""
    args = _wkv(B, S, H, N, seed=2 * S + N)
    y_want, s_want = j_scan(*_jax(args), t_block=16, interpret=True)
    r, k, v, w, u, state = _torch(args)
    ys = []
    for t in range(S):
        beta = (r[:, t] * u * k[:, t]).sum(-1, keepdim=True)       # (B, H, 1)
        ys.append(torch.einsum("bhn,bhnm->bhm", r[:, t], state)
                  + v[:, t] * beta)
        state = w[:, t, :, :, None] * state + (k[:, t, :, :, None]
                                               * v[:, t, :, None, :])
    np.testing.assert_allclose(torch.stack(ys, 1).numpy(),
                               np.asarray(y_want), **TOL)
    np.testing.assert_allclose(state.numpy(), np.asarray(s_want), **TOL)


@pytest.mark.parametrize("N", twk.HEAD_SIZES)
def test_kernel_plan_owns_each_state_entry_once(N):
    """Every (n, m) of a head's state sits in exactly one register of one
    thread, every column comes out of the sum over row groups in some
    lane, and the ring fits the card's shared memory for a block (232,448
    bytes on an H100) at every head size the card tests use."""
    plan = twk.plan(N)
    owners = twk.tile_owners(N)
    assert len(owners) == plan["threads"] == 32 * plan["warps"]
    held = [(n, m) for o in owners for n in o["rows"] for m in o["cols"]]
    assert sorted(held) == [(n, m) for n in range(N) for m in range(N)]
    assert all(len(o["rows"]) == plan["rows"]
               and len(o["cols"]) == plan["cols"] for o in owners)
    assert {o["col"] for o in owners} == set(range(N))
    assert plan["smem_bytes"] <= 232_448
    assert {case[3] for case in twk.CARD_CASES} <= set(twk.HEAD_SIZES)


def _emulate_kernel(r, k, v, w, u, state):
    """The kernel's arithmetic per thread, in torch over every thread at
    once: each thread's tile of the state (``tile_owners``), its partial
    y over its rows, the shuffle sum over the 8 row groups that halves the
    live registers, and the bonus added once after it.  Returns y as
    written by every lane (lanes that share a column must agree)."""
    B, S, H, N = r.shape
    owners = twk.tile_owners(N)
    C = twk.plan(N)["cols"]
    rows = torch.tensor([o["rows"] for o in owners])          # (T, A)
    cols = torch.tensor([o["cols"] for o in owners])          # (T, C)
    col = torch.tensor([o["col"] for o in owners])            # (T,)
    lanes = torch.arange(len(owners))
    st = state[:, :, rows[:, :, None], cols[:, None, :]]       # (B, H, T, A, C)
    y = torch.full((B, S, H, N), float("nan"))
    for t in range(S):
        rr, kk, ww = (x[:, t][:, :, rows] for x in (r, k, w))  # (B, H, T, A)
        vv = v[:, t][:, :, cols]                               # (B, H, T, C)
        p = (rr[..., None] * st).sum(3)                        # (B, H, T, C)
        st = ww[..., None] * st + kk[..., None] * vv[..., None, :]
        live = C
        for mask in (4, 2, 1):
            other = p[:, :, lanes ^ mask]
            if live > 1:
                live //= 2
                p = torch.cat([p[..., :live] + other[..., live:2 * live],
                               p[..., live:]], -1)
            else:
                p = torch.cat([p[..., :1] + other[..., :1], p[..., 1:]], -1)
        beta = (r[:, t] * u * k[:, t]).sum(-1)                 # (B, H)
        out = p[..., 0] + vv[..., 0] * beta[..., None]         # (B, H, T)
        for lane in range(len(owners)):   # every lane of a column agrees
            prev = y[:, t, :, col[lane]]
            torch.testing.assert_close(
                torch.where(torch.isnan(prev), out[..., lane], prev),
                out[..., lane], rtol=1e-6, atol=1e-6)
            y[:, t, :, col[lane]] = out[..., lane]
    final = torch.empty_like(state)
    final[:, :, rows[:, :, None], cols[:, None, :]] = st
    return y, final


@pytest.mark.parametrize("N", twk.HEAD_SIZES)
def test_kernel_tile_layout_matches_plain(N):
    """The kernel's tile layout and shuffle sum, emulated over every
    thread, give the plain version's y and final state."""
    args = _torch(_wkv(2, 5, 2, N, seed=N))
    y, st = _emulate_kernel(*args)
    y_want, st_want = twk.rwkv6_scan_plain(*args)
    torch.testing.assert_close(y, y_want, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(st, st_want, rtol=1e-5, atol=1e-5)


def test_scan_in_calls_carries_the_state():
    """``in_calls`` (the card tests' chained case) over the plain version
    equals one call."""
    args = _torch(_wkv(2, 37, 2, 8, seed=4))
    y, st = twk.in_calls(twk.rwkv6_scan_plain, 3, *args)
    y_want, st_want = twk.rwkv6_scan_plain(*args)
    torch.testing.assert_close(y, y_want, rtol=1e-6, atol=1e-6)
    torch.testing.assert_close(st, st_want, rtol=1e-6, atol=1e-6)


def test_scan_rejects_bad_input():
    r, k, v, w, u, s0 = _torch(_wkv(2, 8, 2, 8))
    with pytest.raises(TypeError):
        ops.rwkv6(r.double(), k, v, w, u, s0)
    with pytest.raises(TypeError):
        ops.rwkv6(r, k, v, w, u, s0.bfloat16())
    with pytest.raises(ValueError, match="state0"):
        ops.rwkv6(r, k, v, w, u, s0[:1])
    with pytest.raises(ValueError, match="u must"):
        ops.rwkv6(r, k, v, w, u[:, :4], s0)
    with pytest.raises(ValueError, match="w must"):
        ops.rwkv6(r, k, v, w[:, :4], u, s0)
    with pytest.raises(ValueError, match=r"\(B, S, H, N\)"):
        ops.rwkv6(r[0], k[0], v[0], w[0], u, s0)
    with pytest.raises(ValueError, match=r"\(B, S, H, N\)"):
        ops.rwkv6(*(t[:, :0] for t in (r, k, v, w)), u, s0)
    bad = _torch(_wkv(1, 4, 2, 12))
    with pytest.raises(ValueError, match="head size"):
        ops.rwkv6(*bad)
    with pytest.raises(ValueError, match="CUDA"):
        twk.rwkv6_scan_cuda(r, k, v, w, u, s0)


# ---------------------------------------------------------------------------
# time-mix / channel-mix blocks
# ---------------------------------------------------------------------------
def _layer_params(which, seed=0):
    jcfg = JARCHS["rwkv6-7b"].reduced()
    init = JR.timemix_init if which == "timemix" else JR.channelmix_init
    jp, _ = init(jax.random.PRNGKey(seed), jcfg)
    tp = TP.from_numpy_tree(jax.tree.map(np.asarray, jp), device="cpu")
    return jcfg, TARCHS["rwkv6-7b"].reduced(), jp, tp


def _dtypes(dtype):
    return jnp.dtype(dtype), getattr(torch, dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("S,with_state", [(64, False), (64, True),
                                          (1, True)])
def test_timemix_apply_matches(dtype, S, with_state):
    jcfg, tcfg, jp, tp = _layer_params("timemix", seed=S)
    jdt, tdt = _dtypes(dtype)
    H, N, d = jcfg.recurrent.num_heads, jcfg.recurrent.head_size, \
        jcfg.d_model
    rng = np.random.default_rng(S + with_state)
    x = rng.standard_normal((2, S, d)).astype(np.float32)
    st = {"shift": rng.standard_normal((2, d)).astype(np.float32),
          "wkv": (rng.standard_normal((2, H, N, N)) * 0.1).astype(
              np.float32)}
    jst = ({"shift": jnp.asarray(st["shift"], jdt),
            "wkv": jnp.asarray(st["wkv"])} if with_state else None)
    tst = ({"shift": torch.from_numpy(st["shift"]).to(tdt),
            "wkv": torch.from_numpy(st["wkv"])} if with_state else None)
    # repro's decode runs the WKV step through its lax.scan, its prefill
    # through the Pallas kernel (which needs S % 64 == 0 here)
    jout, jnew = JR.timemix_apply(jp, jnp.asarray(x, jdt), jcfg, state=jst,
                                  use_pallas=S > 1)
    tout, tnew = TR.timemix_apply(tp, torch.from_numpy(x).to(tdt), tcfg,
                                  state=tst)
    assert tout.dtype == tdt and tnew["shift"].dtype == tdt
    assert tnew["wkv"].dtype == torch.float32
    tol = TOL if dtype == "float32" else BF16_TOL
    np.testing.assert_allclose(tout.float().numpy(),
                               np.asarray(jout, np.float32), **tol)
    np.testing.assert_allclose(tnew["shift"].float().numpy(),
                               np.asarray(jnew["shift"], np.float32), **tol)
    np.testing.assert_allclose(tnew["wkv"].numpy(), np.asarray(jnew["wkv"]),
                               **tol)
    if with_state:   # the state passed in is left as it was
        assert np.array_equal(tst["wkv"].numpy(), st["wkv"])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("S,with_state", [(40, False), (40, True),
                                          (1, True)])
def test_channelmix_apply_matches(dtype, S, with_state):
    jcfg, _, jp, tp = _layer_params("channelmix", seed=S)
    jdt, tdt = _dtypes(dtype)
    rng = np.random.default_rng(S)
    x = rng.standard_normal((2, S, jcfg.d_model)).astype(np.float32)
    st = rng.standard_normal((2, jcfg.d_model)).astype(np.float32)
    jout, jnew = JR.channelmix_apply(
        jp, jnp.asarray(x, jdt), jnp.asarray(st, jdt) if with_state else None)
    tout, tnew = TR.channelmix_apply(
        tp, torch.from_numpy(x).to(tdt),
        torch.from_numpy(st).to(tdt) if with_state else None)
    assert tout.dtype == tdt and tnew.dtype == tdt
    tol = TOL if dtype == "float32" else BF16_TOL
    np.testing.assert_allclose(tout.float().numpy(),
                               np.asarray(jout, np.float32), **tol)
    np.testing.assert_array_equal(tnew.float().numpy(),
                                  np.asarray(jnew, np.float32))


def test_timemix_init_has_repros_tree():
    """Same keys and shapes as repro's init (stacked dims in front), all
    float32; a head layout that does not cover d_model raises."""
    jcfg, tcfg, _, _ = _layer_params("timemix")
    for init_j, init_t in ((JR.timemix_init, TR.timemix_init),
                           (JR.channelmix_init, TR.channelmix_init)):
        want = jax.eval_shape(lambda key: init_j(key, jcfg)[0],
                              jax.random.PRNGKey(0))
        got = init_t(torch.Generator().manual_seed(0), tcfg, "cpu",
                     lead=(3,))
        jitems, titems = TP.tree_items(want), TP.tree_items(got)
        assert [p for p, _ in jitems] == [p for p, _ in titems]
        for (_, a), (_, b) in zip(jitems, titems):
            assert (3, *a.shape) == tuple(b.shape)
            assert b.dtype == torch.float32
    import dataclasses
    bad = dataclasses.replace(tcfg, d_model=128)
    with pytest.raises(ValueError, match="d_model"):
        TR.timemix_init(torch.Generator(), bad, "cpu")
