"""The WKV backward kernel's plan on the CPU (``csrc/rwkv6_scan_bwd.cu``
cannot run here): its launch plan (``rwkv6_scan.bwd_plan``,
``bwd_tile_owners``) owns every entry of a head's state once and fits a
block's shared memory; its ring's order (``bwd_items``) is the one the
kernel's closed form gives; and an emulation of the kernel's order of
work, in torch over every thread at once, gives the gradient of
``rwkv6_scan_backward_plain`` and of ``jax.grad`` through ``repro``'s
``rwkv6_reference``.

The emulation follows the kernel: the first forward walk keeps the state
every 64 steps; the reverse takes the chunks from the last, walks each
one keeping its 16-step sub-chunks' entry states, and for each sub-chunk
from the last recomputes its states, walks them backward with each
thread's partial sums over its tile, adds them across lanes as the
shuffles do (halving the live registers at each level, every lane
storing), and, after the sub-chunk, sums the warps' row sums in order
and the cluster's dv partials in rank order.  Tolerance: 1e-5 x each
gradient's largest |value| (float32 sums in other orders; no fused
multiply-adds here)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.ref import rwkv6_reference
from repro_torch.kernels import rwkv6_scan as wk
from torch_threads import one_torch_thread  # noqa: F401

#: (B, S, H, N, with_state0, with_dstate): every head size; S shorter than
#: a sub-chunk, ragged against 16 and 64, over several chunks
CASES = [(1, 5, 2, 8, True, True), (2, 37, 1, 8, False, True),
         (1, 70, 2, 16, True, False), (2, 13, 1, 16, True, True),
         (1, 130, 1, 32, True, True), (1, 9, 2, 32, False, False),
         (1, 83, 1, 64, True, True), (2, 150, 1, 64, False, True)]


@pytest.mark.parametrize("N", wk.HEAD_SIZES)
def test_bwd_plan_owns_each_state_entry_once(N):
    """Every (n, m) of a head sits in exactly one register of one thread of
    one block of the cluster; after the shuffle sums each of a block's rows
    is held in some lane of every warp and each column in some lane of
    the block; the shared memory fits a block (232,448 bytes on an H100)."""
    p = wk.bwd_plan(N)
    owners = wk.bwd_tile_owners(N)
    assert p["rows"] * p["cluster"] == N
    assert p["rows"] == 8 * p["tile_rows"]
    assert len(owners) == p["cluster"] * p["threads"]
    held = [(n, m) for o in owners for n in o["rows"] for m in o["cols"]]
    assert sorted(held) == [(n, m) for n in range(N) for m in range(N)]
    for rank in range(p["cluster"]):
        block = [o for o in owners if o["rank"] == rank]
        mine = set(range(rank * p["rows"], (rank + 1) * p["rows"]))
        assert {n for o in block for n in o["rows"]} == mine
        assert {o["col"] for o in block} == set(range(N))
        for warp in range(p["warps"]):
            assert {o["row"] for o in block if o["warp"] == warp} == mine
    assert p["smem_bytes"] <= 232_448


def test_bwd_plan_fills_the_card_at_the_training_shape():
    """At RWKV6-7B's (1, 2,048, 64, 64) the 64 heads make 128 blocks in
    clusters of 2: one wave on the H100's 132 SMs (one block an SM)."""
    p = wk.bwd_plan(64)
    assert p["cluster"] == 2 and 1 * 64 * p["cluster"] <= 132
    assert 2 * p["smem_bytes"] > 232_448   # one block an SM


def _item_at(j, np1, nq):
    """``item_at`` of the kernel, as written there."""
    Q = wk.BWD_CHUNK // wk.BWD_SUB
    if j < np1:
        return j, False
    j -= np1
    nc = (nq + Q - 1) // Q
    last = nq - (nc - 1) * Q
    if j < 2 * last - 1:
        c, idx, nqc = nc - 1, j, last
    else:
        j -= 2 * last - 1
        c, idx, nqc = nc - 2 - j // (2 * Q - 1), j % (2 * Q - 1), Q
    full = idx >= nqc - 1
    return c * Q + (nqc - 1 - (idx - (nqc - 1)) if full else idx), full


@pytest.mark.parametrize("S", [1, 15, 16, 17, 63, 64, 65, 100, 128, 129,
                               2048, 2047])
def test_bwd_ring_order_matches_the_kernels_closed_form(S):
    """The kernel's closed form of its ring's order gives ``bwd_items``,
    as many items as the kernel counts, and every sub-chunk once with
    every input."""
    Q = wk.BWD_CHUNK // wk.BWD_SUB
    nq = -(-S // wk.BWD_SUB)
    nc = -(-nq // Q)
    np1 = (nc - 1) * Q
    last = nq - (nc - 1) * Q
    n_items = np1 + (2 * last - 1) + (nc - 1) * (2 * Q - 1)
    items = wk.bwd_items(S)
    assert len(items) == n_items
    assert [_item_at(j, np1, nq) for j in range(n_items)] == items
    assert sorted(q for q, full in items if full) == list(range(nq))


def _halve(x, masks):
    """Xor-shuffle sums of x (..., threads, registers) over the lane bits
    of ``masks``, as the kernel's loops take them: while several registers
    are live a lane keeps the upper half where its bit is set (the lower
    one elsewhere), sends the other half and adds what its partner sent;
    then it adds its partner's last register.  Returns register 0 of every
    thread."""
    lanes = torch.arange(x.shape[-2])
    live = x.shape[-1]
    for mask in masks:
        hi = ((lanes & mask) != 0)[:, None]
        other = x[..., lanes ^ mask, :]
        if live > 1:
            live //= 2
            lo_half, hi_half = x[..., :live], x[..., live:2 * live]
            keep = torch.where(hi, hi_half, lo_half)
            # the partner's bit is the other: it sent the half this lane keeps
            sent = torch.where(hi, other[..., live:2 * live],
                               other[..., :live])
            x = torch.cat([keep + sent, x[..., live:]], -1)
        else:
            x = torch.cat([x[..., :1] + other[..., :1], x[..., 1:]], -1)
    return x[..., 0]


def _store(buf, index, vals):
    """Every lane stores its value at its index (lanes that share an index
    must hold the same bits)."""
    buf[..., index] = vals
    assert torch.equal(buf[..., index], vals)


def _emulate_bwd(r, k, v, w, u, s0, dy, dsT):
    """The kernel's order of work over every thread of every block at
    once: (dr, dk, dv, dw, du, dS0)."""
    B, S, H, N = r.shape
    p = wk.bwd_plan(N)
    owners = wk.bwd_tile_owners(N)
    R, K, W, T = p["rows"], p["cluster"], p["warps"], p["threads"]
    L, Q = wk.BWD_SUB, wk.BWD_CHUNK // wk.BWD_SUB
    rows = torch.tensor([o["rows"] for o in owners])          # (TT, A)
    cols = torch.tensor([o["cols"] for o in owners])          # (TT, C)
    rank = torch.tensor([o["rank"] for o in owners])
    warp = torch.tensor([o["warp"] for o in owners])
    row0 = torch.tensor([o["row"] for o in owners]) - rank * R
    col0 = torch.tensor([o["col"] for o in owners])

    def tile(x):                                              # (B, H, TT, A, C)
        return x[:, :, rows[:, :, None], cols[:, None, :]]

    def step(s, t):
        kk, ww = (x[:, t][:, :, rows] for x in (k, w))
        vv = v[:, t][:, :, cols]
        return ww[..., None] * s + kk[..., None] * vv[..., None, :]

    items = iter(wk.bwd_items(S))

    def use(q, full):   # the ring brings what the walk needs next
        assert next(items) == (q, full)

    nq = -(-S // L)
    nc = -(-nq // Q)
    s, ck = tile(s0), {}
    for q in range((nc - 1) * Q):
        if q % Q == 0:
            ck[q // Q] = s
        use(q, False)
        for t in range(q * L, q * L + L):
            s = step(s, t)
    e = [s] + [None] * (Q - 1)
    ds = tile(dsT) if dsT is not None else torch.zeros_like(s)
    dr, dk, dv, dw = (torch.full_like(r, float("nan")) for _ in range(4))
    du_acc = torch.zeros((B, H, K, T))
    tid = torch.arange(T)
    for c in range(nc - 1, -1, -1):
        nqc = nq - c * Q if c == nc - 1 else Q
        for qq in range(nqc - 1):
            use(c * Q + qq, False)
            s = e[qq]
            for t in range((c * Q + qq) * L, (c * Q + qq + 1) * L):
                s = step(s, t)
            e[qq + 1] = s
        for qq in range(nqc - 1, -1, -1):
            q = c * Q + qq
            use(q, True)
            s = e[qq]
            if qq == 0 and c > 0:
                e[0] = ck[c - 1]
            t0, steps = q * L, min(L, S - q * L)
            states = []
            for t in range(steps):
                states.append(s)
                s = step(s, t0 + t)
            rowbuf = torch.full((B, H, L, 3, K * W * R), float("nan"))
            dvb = torch.full((B, H, L, K * N), float("nan"))
            for t in range(steps - 1, -1, -1):
                tt, sp = t0 + t, states[t]
                rr, kk, ww = (x[:, tt][:, :, rows] for x in (r, k, w))
                vv, dd = (x[:, tt][:, :, cols] for x in (v, dy))
                part = torch.stack([(sp * dd[..., None, :]).sum(-1),
                                    (ds * vv[..., None, :]).sum(-1),
                                    (ds * sp).sum(-1)], 2)    # (B, H, 3, TT, A)
                pv = (ds * kk[..., None]).sum(-2)            # (B, H, TT, C)
                ds = ww[..., None] * ds + rr[..., None] * dd[..., None, :]
                _store(rowbuf[:, :, t], (rank * W + warp) * R + row0,
                       _halve(part, (16, 8)))
                _store(dvb[:, :, t], rank * N + col0, _halve(pv, (4, 2, 1)))
            assert not bool(torch.isnan(rowbuf[:, :, :steps]).any())
            assert not bool(torch.isnan(dvb[:, :, :steps]).any())
            rowbuf = rowbuf.view(B, H, L, 3, K, W, R)
            dvb = dvb.view(B, H, L, K, N)
            ts = slice(t0, t0 + steps)
            vdy = (v[:, ts] * dy[:, ts]).sum(-1)              # (B, steps, H)
            for rk in range(K):
                n = slice(rk * R, (rk + 1) * R)
                sums = [torch.zeros((B, H, steps, R)) for _ in range(3)]
                for wp in range(W):                           # warps in order
                    for i in range(3):
                        sums[i] = sums[i] + rowbuf[:, :, :steps, i, rk, wp]
                rn, kn, un = r[:, ts, :, n], k[:, ts, :, n], u[:, n]
                bonus = (un * vdy[..., None]).transpose(1, 2)  # (B, H, steps, R)
                dr[:, ts, :, n] = (sums[0] + bonus * kn.transpose(1, 2)
                                   ).transpose(1, 2)
                dk[:, ts, :, n] = (sums[1] + bonus * rn.transpose(1, 2)
                                   ).transpose(1, 2)
                dw[:, ts, :, n] = sums[2].transpose(1, 2)
                # thread tid keeps row tid % R's share, steps tid // R + j T / R
                share = (rn * kn * vdy[..., None]).transpose(1, 2)
                for j in range(L * R // T):
                    at = tid + j * T
                    live = at // R < steps
                    du_acc[:, :, rk, live] += share[:, :, (at // R)[live],
                                                    (at % R)[live]]
            beta = torch.stack([(r[:, ts, :, rk * R:(rk + 1) * R]
                                 * u[:, rk * R:(rk + 1) * R]
                                 * k[:, ts, :, rk * R:(rk + 1) * R]).sum(-1)
                                for rk in range(K)], 2)   # (B, steps, K, H)
            out = torch.zeros((B, steps, H, N))
            for rk in range(K):                           # ranks in order
                out = out + (dvb[:, :, :steps, rk].transpose(1, 2)
                             + beta[:, :, rk, :, None] * dy[:, ts])
            dv[:, ts] = out
    assert next(items, None) is None
    du_part = torch.zeros((B, H, N))
    for g in range(T // R):
        du_part = du_part + du_acc[..., g * R:(g + 1) * R].reshape(B, H, N)
    du = torch.zeros_like(u)
    for b in range(B):
        du = du + du_part[b]
    ds0 = torch.empty_like(s0)
    ds0[:, :, rows[:, :, None], cols[:, None, :]] = ds
    return dr, dk, dv, dw, du, ds0


def _inputs(B, S, H, N, seed):
    rng = np.random.default_rng(seed)

    def randn(*shape, scale=1.0):
        return (rng.standard_normal(shape) * scale).astype(np.float32)
    r, k, v = (randn(B, S, H, N, scale=0.5) for _ in range(3))
    w = (1 / (1 + np.exp(-(randn(B, S, H, N) + 2.0)))).astype(np.float32)
    return (r, k, v, w, randn(H, N, scale=0.3), randn(B, H, N, N, scale=0.1),
            randn(B, S, H, N), randn(B, H, N, N))


@pytest.mark.parametrize("B,S,H,N,with_s0,with_ds", CASES)
def test_kernel_order_matches_plain_and_jax_grad(B, S, H, N, with_s0,
                                                 with_ds):
    r, k, v, w, u, s0, dy, ds = _inputs(B, S, H, N, 7 * S + N)
    if not with_s0:
        s0 = np.zeros_like(s0)
    ts = [torch.from_numpy(x) for x in (r, k, v, w, u, s0, dy)]
    dst = torch.from_numpy(ds) if with_ds else None
    got = _emulate_bwd(*ts, dst)
    plain = wk.rwkv6_scan_backward_plain(*ts, dst)

    def f(*xs):
        y, st = rwkv6_reference(*xs)
        return jnp.sum(y * dy) + (jnp.sum(st * ds) if with_ds else 0.0)
    ref = jax.grad(f, argnums=tuple(range(6)))(r, k, v, w, u, s0)
    for name, g, pl, jr in zip(("dr", "dk", "dv", "dw", "du", "ds0"), got,
                               plain, ref):
        jr = np.asarray(jr)
        scale = max(float(np.max(np.abs(jr))), 1e-6)
        assert not bool(torch.isnan(g).any()), name
        assert float((g - pl).abs().max()) <= 1e-5 * scale, name
        assert float(np.max(np.abs(g.numpy() - jr))) <= 1e-5 * scale, name
