"""RWKV6 (Finch) WKV recurrence: the Hopper kernel and its plain PyTorch
version.

Port of ``repro.kernels.rwkv6_scan`` (a Pallas TPU kernel).  The kernel
is hand-written CUDA C++ for ``sm_90a``, ``repro_torch/csrc/rwkv6_scan.cu``:
one block per (batch, head), each consumer thread holding an A x C tile
of the state in registers (:func:`plan`, :func:`tile_owners`), the bonus
factored out into one scalar per step, and r, k, v, w streamed through a
ring of shared-memory stages by TMA.  Its bound is the bytes it moves (r,
k, v, w read and y written once); its float32 issue floor is nearly as
high.  It agrees with the plain version within float32 rounding (FMA
contraction, the factored bonus and another order of the sum over n).
It takes any S >= 1, and N in {8, 16, 32, 64}.

:func:`rwkv6_scan` launches the kernel for CUDA tensors and runs
:func:`rwkv6_scan_plain` for CPU tensors; there is no fallback from one
to the other.  ``LAUNCHES`` counts kernel launches.

The gradient (:class:`WKVScanFn`) is a second hand-written kernel,
``repro_torch/csrc/rwkv6_scan_bwd.cu`` (:func:`bwd_plan`,
:func:`bwd_tile_owners`): a block takes one (batch, head) and 32 of its
state rows (a cluster of 2 blocks a head at N = 64), each thread an A x C
tile of the state and of its gradient in registers; the inputs come
through a ring of TMA stages of ``BWD_SUB`` steps; the states are
recomputed, not stored, from checkpoints every ``BWD_CHUNK`` steps and,
within a chunk, from each sub-chunk's entry state; dr, dk, dw and dv are
summed by shuffles into shared memory and added up once a sub-chunk,
dv across the cluster in rank order.  Its bound is the float32
operations (12 a (b, t, h, n, m)); the bytes are nearly as high.  On CPU
tensors the gradient is :func:`rwkv6_scan_backward_plain`, written out
(not autograd through the plain loop).  ``BWD_LAUNCHES`` counts the
backward's launches.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Dict, List, Optional, Tuple

import torch

from repro_torch.kernels import _build, ref
from repro_torch.sharding import logical as L

#: kernel launches in this process (one per :func:`rwkv6_scan_cuda`)
LAUNCHES = 0
#: backward launches (one per :func:`rwkv6_scan_bwd_cuda`)
BWD_LAUNCHES = 0
#: the backward kernel's sub-chunk (the steps of a ring stage, and of the
#: states it keeps in shared memory), its steps between state checkpoints
#: and its ring's stages (``csrc/rwkv6_scan_bwd.cu``)
BWD_SUB, BWD_CHUNK, BWD_STAGES = 16, 64, 4
#: the head sizes the kernel is built for
HEAD_SIZES = (8, 16, 32, 64)
#: (B, S, H, N, with_state0, calls) at which the kernel is held to its
#: plain version on the card, the kernel run as ``calls`` calls over S /
#: calls steps each, every call after the first starting from the state
#: the one before it left: rwkv6-7b's prefill (64 heads of 64) from a zero
#: and from a carried state, a ragged S, a prefill cut in two, S shorter
#: than one ring stage, a decode step, and one small case for each other
#: head size
CARD_CASES = [(4, 4096, 64, 64, False, 1), (4, 4096, 64, 64, True, 1),
              (3, 1000, 64, 64, True, 1), (2, 1000, 64, 64, True, 2),
              (4, 3, 64, 64, True, 1), (4, 1, 64, 64, True, 1),
              (2, 33, 2, 8, True, 1), (1, 70, 3, 16, True, 1),
              (2, 64, 4, 32, True, 1)]
#: steps a ring stage holds, stages in the ring, and the lanes that share
#: a state column (``csrc/rwkv6_scan.cu``)
CHUNK, STAGES, ROW_GROUPS = 32, 3, 8


def random_inputs(B: int, S: int, H: int, N: int, with_state0: bool,
                  generator: torch.Generator) -> Tuple[torch.Tensor, ...]:
    """Seeded (r, k, v, w, u, state0) on ``generator``'s device, with
    decays near 1 (the RWKV kernel tests'); state0 is zero unless
    ``with_state0``."""
    dev = generator.device

    def randn(*shape, scale=1.0):
        return torch.randn(shape, generator=generator, device=dev) * scale
    r, k, v = (randn(B, S, H, N, scale=0.5) for _ in range(3))
    w = torch.sigmoid(randn(B, S, H, N) + 2.0)
    u = randn(H, N, scale=0.3)
    s0 = (randn(B, H, N, N, scale=0.1) if with_state0
          else torch.zeros((B, H, N, N), device=dev))
    return r, k, v, w, u, s0


def rwkv6_scan_plain(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     w: torch.Tensor, u: torch.Tensor, state0: torch.Tensor
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The sequential loop of ``ref.rwkv6_reference``.  r, k, v, w
    (B, S, H, N) f32; u (H, N); state0 (B, H, N, N) -> (y (B, S, H, N),
    final state (B, H, N, N))."""
    return ref.rwkv6_reference(r, k, v, w, u, state0)


def rwkv6_scan_backward_plain(r: torch.Tensor, k: torch.Tensor,
                              v: torch.Tensor, w: torch.Tensor,
                              u: torch.Tensor, state0: torch.Tensor,
                              dy: torch.Tensor,
                              dstate: Optional[torch.Tensor] = None
                              ) -> Tuple[torch.Tensor, ...]:
    """(dr, dk, dv, dw, du, dstate0) of :func:`rwkv6_scan_plain` given the
    output's gradient dy and the final state's (None: zero), written out
    as the backward kernel computes it.  With dS the gradient of the state
    after step t, for t = S - 1 down to 0: dr_t = (S_{t-1} + diag(u) k_t
    v_t^T) dy_t, du += r_t o k_t (v_t . dy_t), dk_t = dS v_t + u o r_t
    (v_t . dy_t), dv_t = dS^T k_t + (r_t . (u o k_t)) dy_t, dw_t =
    rowsum(dS o S_{t-1}), dS <- diag(w_t) dS + r_t dy_t^T; dstate0 is the
    last dS."""
    S = r.shape[1]
    states, st = [], state0
    for t in range(S):
        states.append(st)
        st = (w[:, t, ..., None] * st
              + k[:, t, ..., None] * v[:, t, ..., None, :])
    ds = torch.zeros_like(state0) if dstate is None else dstate
    dr, dk, dv, dw = (torch.empty_like(r) for _ in range(4))
    du = torch.zeros_like(u)
    for t in range(S - 1, -1, -1):
        rt, kt, vt, wt, dyt = (x[:, t] for x in (r, k, v, w, dy))
        sp = states[t]
        vdy = torch.sum(vt * dyt, dim=-1, keepdim=True)
        dr[:, t] = torch.einsum("bhnm,bhm->bhn", sp, dyt) + u * kt * vdy
        du = du + torch.sum(rt * kt * vdy, dim=0)
        dk[:, t] = torch.einsum("bhnm,bhm->bhn", ds, vt) + u * rt * vdy
        beta = torch.sum(rt * u * kt, dim=-1, keepdim=True)
        dv[:, t] = torch.einsum("bhnm,bhn->bhm", ds, kt) + beta * dyt
        dw[:, t] = torch.sum(ds * sp, dim=-1)
        ds = wt[..., None] * ds + rt[..., None] * dyt[..., None, :]
    return dr, dk, dv, dw, du, ds


def in_calls(fn, calls: int, r: torch.Tensor, k: torch.Tensor,
             v: torch.Tensor, w: torch.Tensor, u: torch.Tensor,
             state0: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """``fn`` (a scan) over S cut into ``calls`` consecutive parts, each
    starting from the state the one before it left: as a server carries
    the state from one prompt piece to the next."""
    S = r.shape[1]
    cuts = [S * i // calls for i in range(calls + 1)]
    ys, state = [], state0
    for lo, hi in zip(cuts, cuts[1:]):
        y, state = fn(*(t[:, lo:hi].contiguous() for t in (r, k, v, w)), u,
                      state)
        ys.append(y)
    return torch.cat(ys, dim=1), state


def plan(N: int) -> Dict[str, int]:
    """The kernel's launch plan at head size N, as ``csrc/rwkv6_scan.cu``
    sets it: each thread holds ``rows`` x ``cols`` of the state, ``warps``
    warps of 4 column groups x 8 row groups, and ``smem_bytes`` of dynamic
    shared memory (beta for each stage, u, the ring's mbarriers and
    release counters, padded to 128 bytes, then the ring of ``STAGES`` x 4
    tensors x ``CHUNK`` steps x N floats, and 128 bytes of alignment; the
    short path asks for one stage)."""
    if N not in HEAD_SIZES:
        raise ValueError(f"head size N = {N} is not one of {HEAD_SIZES}")
    rows, cols = N // ROW_GROUPS, 2 if N == 8 else 4
    warps = N // cols // 4
    head = -(-(STAGES * CHUNK + N + 2 * STAGES + STAGES) // 32) * 32
    return {"rows": rows, "cols": cols, "warps": warps,
            "threads": 32 * warps,
            "smem_bytes": (head + STAGES * 4 * CHUNK * N) * 4 + 128}


def tile_owners(N: int) -> List[Dict]:
    """Each thread's share of the state, as the kernel lays it out:
    ``rows[i]`` and ``cols[j]`` are the state row and column of its
    register (i, j); after the sum over the 8 row groups (shuffles across
    lane bits 2, 1, 0 that halve the live registers while there are
    several) its register 0 holds column ``col``, which it writes to y.
    Row group rg = lane % 8 owns rows A rg .. A rg + A - 1 (the two halves
    of them in the other order where rg >= 4 at N = 64, so that the row
    groups read distinct shared-memory banks), and register j holds
    column cbase + (j ^ sigma), sigma from the row group's high bits, so
    that each level of the sum keeps and sends the same registers in
    every lane."""
    p = plan(N)
    A, C = p["rows"], p["cols"]
    levels = C.bit_length() - 1
    out = []
    for warp in range(p["warps"]):
        for lane in range(32):
            rg = lane % ROW_GROUPS
            n0 = rg * A
            swap = (rg >> 2) & 1 if A == 8 else 0
            rows = [n0 + 4 * ((i >> 2) ^ swap) + (i & 3) if A == 8
                    else n0 + i for i in range(A)]
            sigma = rg >> (3 - levels)
            cbase = (warp * 4 + lane // ROW_GROUPS) * C
            out.append({"warp": warp, "lane": lane, "rows": rows,
                        "cols": [cbase + (j ^ sigma) for j in range(C)],
                        "col": cbase + sigma})
    return out


def bwd_plan(N: int) -> Dict[str, int]:
    """The backward kernel's launch plan at head size N, as
    ``csrc/rwkv6_scan_bwd.cu`` sets it: a block takes ``rows`` = min(N,
    32) state rows of one (batch, head), ``cluster`` = N / rows blocks a
    head; each of its ``threads`` (``warps`` warps of 8 row groups x 4
    column groups) holds ``tile_rows`` x ``tile_cols`` of the state and
    of its gradient; ``smem_bytes`` of dynamic shared memory: the ring of
    ``BWD_STAGES`` stages (r, k, w of the block's rows, v, dy of all N
    columns, ``BWD_SUB`` steps each), a sub-chunk's states (``BWD_SUB``
    x rows x N), the warps' row sums (``BWD_SUB`` x warps x 3 x rows), two
    dv slots (each rank's partial of the block's N / cluster columns and
    its betas, ``BWD_SUB`` steps each, and dy of those columns), v . dy
    (``BWD_SUB``), u of the block's rows, the ring's mbarriers, and 128
    bytes of alignment."""
    if N not in HEAD_SIZES:
        raise ValueError(f"head size N = {N} is not one of {HEAD_SIZES}")
    rows = min(N, 32)
    A, C = rows // ROW_GROUPS, 2 if N == 8 else 4
    warps = N // C // 4
    ring = BWD_STAGES * BWD_SUB * (3 * rows + 2 * N)
    cluster = N // rows
    slot = BWD_SUB * N + cluster * BWD_SUB + BWD_SUB * N // cluster
    floats = (ring + BWD_SUB * rows * N + BWD_SUB * warps * 3 * rows
              + 2 * slot + BWD_SUB + rows)
    floats = -(-floats // 2) * 2 + 2 * BWD_STAGES
    return {"rows": rows, "cluster": cluster, "tile_rows": A,
            "tile_cols": C, "warps": warps, "threads": 32 * warps,
            "smem_bytes": floats * 4 + 128}


def bwd_tile_owners(N: int) -> List[Dict]:
    """Each thread's share of a head in the backward kernel: block
    ``rank`` of the cluster, its ``rows[i]`` (of the head) and ``cols[j]``
    are the state row and column of its register (i, j).  Lane bits 0-2
    are the row group rg (rows rg A .. rg A + A - 1 of the block's), lane
    bits 3-4 with the warp the column group cg (columns cg C .. cg C + C
    - 1).  The shuffle sums (row sums over lane bits 4, 3; column sums
    over 2, 1, 0) halve the live registers at each level while several
    are left, a lane keeping the upper half where its bit is set; after
    them its register 0 holds the row ``row`` (its dr, dk and dw over the
    warp's columns) and the column ``col`` (its dv over the block's
    rows)."""
    p = bwd_plan(N)
    A, C = p["tile_rows"], p["tile_cols"]
    h_a, h_c = A.bit_length() - 1, C.bit_length() - 1
    out = []
    for rank in range(p["cluster"]):
        for warp in range(p["warps"]):
            for lane in range(32):
                rg, cgw = lane % 8, lane // 8
                r0 = rank * p["rows"] + rg * A
                c0 = (warp * 4 + cgw) * C
                out.append({"rank": rank, "warp": warp, "lane": lane,
                            "rows": [r0 + i for i in range(A)],
                            "cols": [c0 + j for j in range(C)],
                            "row": r0 + (cgw >> (2 - h_a)),
                            "col": c0 + (rg >> (3 - h_c))})
    return out


def bwd_items(S: int) -> List[Tuple[int, bool]]:
    """The backward kernel's ring, in the order it brings sub-chunks in
    (``item_at`` in ``csrc/rwkv6_scan_bwd.cu``): (sub-chunk, whether it
    brings every input or only k, w and v).  The first forward walk takes
    every sub-chunk before the last chunk; then each chunk from the last
    takes its sub-chunks but the last for the walk over the chunk, and all
    of them from the last for the reverse."""
    Q = BWD_CHUNK // BWD_SUB
    nq = -(-S // BWD_SUB)
    nc = -(-nq // Q)
    items = [(q, False) for q in range((nc - 1) * Q)]
    for c in range(nc - 1, -1, -1):
        nqc = nq - c * Q if c == nc - 1 else Q
        items += [(c * Q + i, False) for i in range(nqc - 1)]
        items += [(c * Q + i, True) for i in range(nqc - 1, -1, -1)]
    return items


@functools.lru_cache(maxsize=None)
def _entry():
    fn = _build.load("rwkv6_scan").rwkv6_scan_f32
    fn.argtypes = ([ctypes.c_void_p] * 8 + [ctypes.c_int] * 4
                   + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def _check(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
           w: torch.Tensor, u: torch.Tensor, state0: torch.Tensor) -> None:
    if r.dim() != 4 or min(r.shape) < 1:
        raise ValueError(f"r must be a non-empty (B, S, H, N), got "
                         f"{tuple(r.shape)}")
    B, _, H, N = r.shape
    if N not in HEAD_SIZES:
        raise ValueError(f"head size N = {N} is not one of {HEAD_SIZES}")
    for name, t, shape in (("k", k, r.shape), ("v", v, r.shape),
                           ("w", w, r.shape), ("u", u, (H, N)),
                           ("state0", state0, (B, H, N, N))):
        if tuple(t.shape) != tuple(shape):
            raise ValueError(f"{name} must be {tuple(shape)}, got "
                             f"{tuple(t.shape)}")
    for name, t in (("r", r), ("k", k), ("v", v), ("w", w), ("u", u),
                    ("state0", state0)):
        if t.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {t.dtype}")
        if t.device != r.device:
            raise ValueError(f"{name} on {t.device}, r on {r.device}")


def rwkv6_scan_cuda(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    w: torch.Tensor, u: torch.Tensor, state0: torch.Tensor
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch the CUDA kernel on PyTorch's current stream."""
    global LAUNCHES
    _check(r, k, v, w, u, state0)
    if r.device.type != "cuda":
        raise ValueError(f"rwkv6_scan_cuda needs CUDA tensors, got "
                         f"{r.device}")
    if not all(t.is_contiguous() for t in (r, k, v, w, u, state0)):
        raise ValueError("r, k, v, w, u and state0 must be contiguous")
    B, S, H, N = r.shape
    y = torch.empty_like(r)
    state = torch.empty_like(state0)
    with torch.cuda.device(r.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = _entry()(r.data_ptr(), k.data_ptr(), v.data_ptr(),
                       w.data_ptr(), u.data_ptr(), state0.data_ptr(),
                       y.data_ptr(), state.data_ptr(), B, S, H, N, stream)
    if err != 0:
        raise RuntimeError(f"rwkv6_scan kernel launch failed: CUDA error "
                           f"{err}")
    LAUNCHES += 1
    return y, state


@functools.lru_cache(maxsize=None)
def _bwd_entry():
    fn = _build.load("rwkv6_scan_bwd").rwkv6_scan_bwd_f32
    fn.argtypes = ([ctypes.c_void_p] * 16 + [ctypes.c_int] * 4
                   + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def rwkv6_scan_bwd_cuda(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        w: torch.Tensor, u: torch.Tensor,
                        state0: torch.Tensor, dy: torch.Tensor,
                        dstate: Optional[torch.Tensor] = None
                        ) -> Tuple[torch.Tensor, ...]:
    """Launch the backward kernel on PyTorch's current stream: (dr, dk, dv,
    dw, du, dstate0); ``dstate`` None means a zero gradient of the final
    state."""
    global BWD_LAUNCHES
    _check(r, k, v, w, u, state0)
    _check(r, dy, dy, dy, u, state0 if dstate is None else dstate)
    ts = (r, k, v, w, u, state0, dy) + (() if dstate is None else (dstate,))
    if r.device.type != "cuda":
        raise ValueError(f"rwkv6_scan_bwd_cuda needs CUDA tensors, got "
                         f"{r.device}")
    if not all(t.is_contiguous() for t in ts):
        raise ValueError("every input of the WKV backward must be "
                         "contiguous")
    B, S, H, N = r.shape
    # TMA reads r, k, v, w and dy, and 16-byte loads the states, from
    # 16-byte-aligned addresses
    r, k, v, w, dy, state0 = (t if t.data_ptr() % 16 == 0 else t.clone()
                              for t in (r, k, v, w, dy, state0))
    if dstate is not None and dstate.data_ptr() % 16 != 0:
        dstate = dstate.clone()
    dr, dk, dv, dw = (torch.empty_like(r) for _ in range(4))
    du, ds0 = torch.empty_like(u), torch.empty_like(state0)
    ckpt = torch.empty((B, H, -(-S // BWD_CHUNK), N, N), dtype=torch.float32,
                       device=r.device)
    du_part = torch.empty((B, H, N), dtype=torch.float32, device=r.device)
    with torch.cuda.device(r.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = _bwd_entry()(
            r.data_ptr(), k.data_ptr(), v.data_ptr(), w.data_ptr(),
            u.data_ptr(), state0.data_ptr(), dy.data_ptr(),
            None if dstate is None else dstate.data_ptr(), dr.data_ptr(),
            dk.data_ptr(), dv.data_ptr(), dw.data_ptr(), du.data_ptr(),
            ds0.data_ptr(), ckpt.data_ptr(), du_part.data_ptr(), B, S, H, N,
            stream)
    if err != 0:
        raise RuntimeError(f"rwkv6_scan backward kernel launch failed: CUDA "
                           f"error {err}")
    BWD_LAUNCHES += 1
    return dr, dk, dv, dw, du, ds0


class WKVScanFn(torch.autograd.Function):
    """The WKV scan and its gradient: the kernels on CUDA tensors, the
    plain versions on CPU ones.  Saves the inputs; the states are
    recomputed in the backward."""

    @staticmethod
    def forward(ctx, r, k, v, w, u, state0):
        ctx.set_materialize_grads(False)
        if r.device.type == "meta":
            y, state = torch.empty_like(r), torch.empty_like(state0)
        elif r.device.type == "cuda":
            y, state = rwkv6_scan_cuda(r, k, v, w, u, state0)
        else:
            _check(r, k, v, w, u, state0)
            y, state = rwkv6_scan_plain(r, k, v, w, u, state0)
        ctx.save_for_backward(r, k, v, w, u, state0)
        return y, state

    @staticmethod
    def backward(ctx, dy, dstate):
        r, k, v, w, u, state0 = ctx.saved_tensors
        dy = torch.zeros_like(r) if dy is None else dy.contiguous()
        dstate = None if dstate is None else dstate.contiguous()
        if r.device.type == "meta":
            return tuple(torch.empty_like(t) for t in (r, k, v, w, u, state0))
        if r.device.type == "cuda":
            return rwkv6_scan_bwd_cuda(r, k, v, w, u, state0, dy, dstate)
        return rwkv6_scan_backward_plain(r, k, v, w, u, state0, dy, dstate)


def rwkv6_scan(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
               w: torch.Tensor, u: torch.Tensor, state0: torch.Tensor
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """WKV6 over axis 1 from state0.  r, k, v, w (B, S, H, N) f32; u (H, N)
    f32; state0 (B, H, N, N) f32.  Returns (y (B, S, H, N), final state
    (B, H, N, N)); state0 is left as it was.

    The one entry point of the WKV kernels (``ops.rwkv6`` re-exports it),
    differentiable through :class:`WKVScanFn`: CUDA tensors launch the
    kernels or raise; CPU tensors run the plain versions; ``meta`` tensors
    give the outputs' shapes alone (the plain version's per-step loop
    would issue millions of meta ops at 32k tokens).  DTensors run on
    their local shards, the batch and the heads sharded, the sequence
    and head-size dims gathered."""
    if L.any_dtensor(r, k, v, w, u, state0):
        seq = ("b", None, "h", None)
        return L.local_call(
            WKVScanFn.apply, (r, k, v, w, u, state0),
            (seq, seq, seq, seq, ("h", None), ("b", "h", None, None)),
            ("b", "h"), (seq, ("b", "h", None, None)))
    return WKVScanFn.apply(r, k, v, w, u, state0)
