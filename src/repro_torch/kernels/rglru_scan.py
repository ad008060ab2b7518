"""RG-LRU diagonal linear recurrence: the Hopper kernels and their plain
PyTorch versions, forward and backward.

Port of ``repro.kernels.rglru_scan`` (a Pallas TPU kernel).  The kernels
are hand-written CUDA C++ for ``sm_90a``, ``repro_torch/csrc/rglru_scan.cu``:
one warp walks time for 32 channel slots (32 channels of a row, or two
rows of 16 channels when W <= 16), h in a register of each lane, while
the inputs stream through a ring of shared-memory stages by ``cp.async``
with mbarrier completion, so bytes are in flight all the time.  The
blocks of every row lie along one grid axis, so the batch B has no limit
below 2**31 blocks.  A backward of few chains (at most 264 such blocks,
as RecurrentGemma's training step at (1, 2048, 4096)) runs a kernel of
its own inside the same C entry point: TMA boxes into a deeper ring and
out of staging buffers, so the warp's time goes to the chain.  Both
directions are bound by memory traffic: the forward moves
``3 * B * S * W * 4`` bytes (a, b read, h written), the backward
``5 * B * S * W * 4`` (a, h, dh read, da, db written).  On the card each
equals its plain version bit for bit.

The backward walks time backwards from g_S = 0::

    g_t = dh_t + a_{t+1} * g_{t+1},  da_t = g_t * h_{t-1},  db_t = g_t,
    dh0 = a_0 * g_0,                 h_{-1} = h0 (or 0).

``repro`` differentiates the recurrence through
``jax.lax.associative_scan``; the port's gradient is
:class:`RGLRUScanFn`, whose backward is that kernel.

:func:`rglru_scan` (differentiable) launches the forward kernel for CUDA
tensors and runs :func:`rglru_scan_plain` for CPU tensors; its backward
launches :func:`rglru_scan_bwd_cuda` or runs
:func:`rglru_scan_backward_plain` likewise.  There is no fallback from
one to the other.  ``LAUNCHES`` counts forward launches, ``BWD_LAUNCHES``
backward ones.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Optional, Tuple

import torch

from repro_torch.kernels import _build, ref
from repro_torch.sharding import logical as L

#: forward kernel launches in this process (one per :func:`rglru_scan_cuda`)
LAUNCHES = 0
#: backward kernel launches (one per :func:`rglru_scan_bwd_cuda`)
BWD_LAUNCHES = 0


def rglru_scan_plain(a_t: torch.Tensor, b_t: torch.Tensor,
                     h0: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The sequential loop of ``ref.rglru_reference``: per step a multiply
    then an add, each rounded, in the kernel's order.  a_t, b_t (B, S, W)
    f32; h0 (B, W) f32 or None -> h (B, S, W) f32."""
    return ref.rglru_reference(a_t, b_t, h0)


def rglru_scan_backward_plain(a_t: torch.Tensor, h: torch.Tensor,
                              h0: Optional[torch.Tensor], dh: torch.Tensor
                              ) -> Tuple[torch.Tensor, torch.Tensor,
                                         Optional[torch.Tensor]]:
    """The backward's sequential loop, in the kernel's order (a multiply
    then an add, each rounded): a_t, the forward's h and dh (B, S, W), h0
    (B, W) or None -> (da, db, dh0), dh0 None without h0."""
    S = a_t.shape[1]
    da, db = torch.empty_like(a_t), torch.empty_like(a_t)
    g = dh[:, S - 1]
    for t in range(S - 1, -1, -1):
        if t < S - 1:
            g = dh[:, t] + a_t[:, t + 1] * g
        h_prev = (h[:, t - 1] if t > 0 else
                  torch.zeros_like(g) if h0 is None else h0)
        da[:, t] = g * h_prev
        db[:, t] = g
    return da, db, (None if h0 is None else a_t[:, 0] * g)


@functools.lru_cache(maxsize=None)
def _entry():
    fn = _build.load("rglru_scan").rglru_scan_f32
    fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 3
                   + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


@functools.lru_cache(maxsize=None)
def _bwd_entry():
    fn = _build.load("rglru_scan").rglru_scan_bwd_f32
    fn.argtypes = ([ctypes.c_void_p] * 7 + [ctypes.c_int] * 3
                   + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def _check(a_t: torch.Tensor, b_t: torch.Tensor,
           h0: Optional[torch.Tensor]) -> None:
    if a_t.dim() != 3 or b_t.shape != a_t.shape or min(a_t.shape) < 1:
        raise ValueError(f"a_t, b_t must be one non-empty (B, S, W) shape, "
                         f"got {tuple(a_t.shape)} and {tuple(b_t.shape)}")
    B, _, W = a_t.shape
    if h0 is not None and tuple(h0.shape) != (B, W):
        raise ValueError(f"h0 must be ({B}, {W}), got {tuple(h0.shape)}")
    for name, t in (("a_t", a_t), ("b_t", b_t), ("h0", h0)):
        if t is None:
            continue
        if t.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {t.dtype}")
        if t.device != a_t.device:
            raise ValueError(f"{name} on {t.device}, a_t on {a_t.device}")


def _check_cuda(name: str, *ts: Optional[torch.Tensor]) -> None:
    if ts[0].device.type != "cuda":
        raise ValueError(f"{name} needs CUDA tensors, got {ts[0].device}")
    if not all(t is None or t.is_contiguous() for t in ts):
        raise ValueError(f"{name}: every tensor must be contiguous")


def _ptr(t: Optional[torch.Tensor]):
    return None if t is None else t.data_ptr()


def rglru_scan_cuda(a_t: torch.Tensor, b_t: torch.Tensor,
                    h0: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Launch the forward kernel on PyTorch's current stream."""
    global LAUNCHES
    _check(a_t, b_t, h0)
    _check_cuda("rglru_scan_cuda", a_t, b_t, h0)
    B, S, W = a_t.shape
    out = torch.empty_like(a_t)
    with torch.cuda.device(a_t.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = _entry()(a_t.data_ptr(), b_t.data_ptr(), _ptr(h0),
                       out.data_ptr(), B, S, W, stream)
    if err != 0:
        raise RuntimeError(f"rglru_scan kernel launch failed: CUDA error "
                           f"{err}")
    LAUNCHES += 1
    return out


def rglru_scan_bwd_cuda(a_t: torch.Tensor, h: torch.Tensor,
                        h0: Optional[torch.Tensor], dh: torch.Tensor
                        ) -> Tuple[torch.Tensor, torch.Tensor,
                                   Optional[torch.Tensor]]:
    """Launch the backward kernel on PyTorch's current stream: (da, db,
    dh0), dh0 None without h0."""
    global BWD_LAUNCHES
    _check(a_t, h, h0)
    _check(a_t, dh, None)
    _check_cuda("rglru_scan_bwd_cuda", a_t, h, h0, dh)
    B, S, W = a_t.shape
    da, db = torch.empty_like(a_t), torch.empty_like(a_t)
    dh0 = None if h0 is None else torch.empty_like(h0)
    with torch.cuda.device(a_t.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = _bwd_entry()(a_t.data_ptr(), h.data_ptr(), _ptr(h0),
                           dh.data_ptr(), da.data_ptr(), db.data_ptr(),
                           _ptr(dh0), B, S, W, stream)
    if err != 0:
        raise RuntimeError(f"rglru_scan backward kernel launch failed: CUDA "
                           f"error {err}")
    BWD_LAUNCHES += 1
    return da, db, dh0


class RGLRUScanFn(torch.autograd.Function):
    """The scan and its backward: the kernels on CUDA tensors, the plain
    versions on CPU ones.  Saves a, h and h0."""

    @staticmethod
    def forward(ctx, a_t, b_t, h0):
        if a_t.device.type == "meta":
            h = torch.empty_like(a_t)
        elif a_t.device.type == "cuda":
            h = rglru_scan_cuda(a_t, b_t, h0)
        else:
            _check(a_t, b_t, h0)
            h = rglru_scan_plain(a_t, b_t, h0)
        ctx.save_for_backward(a_t, h, h0)
        return h

    @staticmethod
    def backward(ctx, dh):
        a_t, h, h0 = ctx.saved_tensors
        dh = dh.contiguous()
        if a_t.device.type == "meta":
            da, db = torch.empty_like(a_t), torch.empty_like(a_t)
            dh0 = None if h0 is None else torch.empty_like(h0)
        elif a_t.device.type == "cuda":
            da, db, dh0 = rglru_scan_bwd_cuda(a_t, h, h0, dh)
        else:
            _check(a_t, dh, h0)
            da, db, dh0 = rglru_scan_backward_plain(a_t, h, h0, dh)
        return da, db, dh0


def rglru_scan(a_t: torch.Tensor, b_t: torch.Tensor,
               h0: Optional[torch.Tensor] = None) -> torch.Tensor:
    """h_t = a_t * h_{t-1} + b_t over axis 1, from h0 (or 0).  a_t, b_t
    (B, S, W) f32; h0 (B, W) f32 or None.  Returns h (B, S, W).

    The one entry point of the scan kernels (``ops.rglru`` re-exports it),
    differentiable through :class:`RGLRUScanFn`: CUDA tensors launch the
    kernels or raise; CPU tensors run the plain versions; ``meta`` tensors
    give h's shape alone.  DTensors run on their local shards, the batch
    and the channels sharded, the sequence gathered."""
    if L.any_dtensor(a_t, b_t, h0):
        seq = ("b", None, "w")
        return L.local_call(
            lambda a, b, h: RGLRUScanFn.apply(a, b, h), (a_t, b_t, h0),
            (seq, seq, ("b", "w")), ("b", "w"), (seq,))
    return RGLRUScanFn.apply(a_t, b_t, h0)
