"""RG-LRU diagonal linear recurrence: the Hopper kernel and its plain
PyTorch version.

Port of ``repro.kernels.rglru_scan`` (a Pallas TPU kernel).  The kernel
is hand-written CUDA C++ for ``sm_90a``, ``repro_torch/csrc/rglru_scan.cu``:
one warp walks time for 32 channels of a batch row, h in a register of
each lane, while a and b stream through a ring of shared-memory stages
by ``cp.async`` with mbarrier completion, so bytes are in flight all the
time; a, b and h each cross memory once.  It is bound by memory traffic,
``3 * B * S * W * 4`` bytes, and on the card it equals the plain version
bit for bit.

:func:`rglru_scan` launches the kernel for CUDA tensors and runs
:func:`rglru_scan_plain` for CPU tensors; there is no fallback from one
to the other.  ``LAUNCHES`` counts kernel launches.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch

from repro_torch.kernels import _build, ref

#: kernel launches in this process (one per :func:`rglru_scan_cuda`)
LAUNCHES = 0


def rglru_scan_plain(a_t: torch.Tensor, b_t: torch.Tensor,
                     h0: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The sequential loop of ``ref.rglru_reference``: per step a multiply
    then an add, each rounded, in the kernel's order.  a_t, b_t (B, S, W)
    f32; h0 (B, W) f32 or None -> h (B, S, W) f32."""
    return ref.rglru_reference(a_t, b_t, h0)


@functools.lru_cache(maxsize=None)
def _entry():
    fn = _build.load("rglru_scan").rglru_scan_f32
    fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 3
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


def rglru_scan_cuda(a_t: torch.Tensor, b_t: torch.Tensor,
                    h0: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Launch the CUDA kernel on PyTorch's current stream."""
    global LAUNCHES
    _check(a_t, b_t, h0)
    if a_t.device.type != "cuda":
        raise ValueError(f"rglru_scan_cuda needs CUDA tensors, got "
                         f"{a_t.device}")
    if not (a_t.is_contiguous() and b_t.is_contiguous()
            and (h0 is None or h0.is_contiguous())):
        raise ValueError("a_t, b_t and h0 must be contiguous")
    B, S, W = a_t.shape
    out = torch.empty_like(a_t)
    with torch.cuda.device(a_t.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = _entry()(a_t.data_ptr(), b_t.data_ptr(),
                       None if h0 is None else h0.data_ptr(),
                       out.data_ptr(), B, S, W, stream)
    if err != 0:
        raise RuntimeError(f"rglru_scan kernel launch failed: CUDA error "
                           f"{err}")
    LAUNCHES += 1
    return out


def rglru_scan(a_t: torch.Tensor, b_t: torch.Tensor,
               h0: Optional[torch.Tensor] = None) -> torch.Tensor:
    """h_t = a_t * h_{t-1} + b_t over axis 1, from h0 (or 0).  a_t, b_t
    (B, S, W) f32; h0 (B, W) f32 or None.  Returns h (B, S, W).

    The one entry point of the scan kernel (``ops.rglru`` re-exports it):
    CUDA tensors launch the kernel or raise; CPU tensors run the plain
    version."""
    if a_t.device.type == "cuda":
        return rglru_scan_cuda(a_t, b_t, h0)
    _check(a_t, b_t, h0)
    return rglru_scan_plain(a_t, b_t, h0)
