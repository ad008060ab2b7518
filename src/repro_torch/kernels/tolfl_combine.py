"""Tol-FL streaming weighted-mean combine: the Hopper kernel and its
plain PyTorch version.

Port of ``repro.kernels.tolfl_combine`` (a Pallas TPU kernel).  The
kernel is hand-written CUDA C++ for ``sm_90a``,
``repro_torch/csrc/tolfl_combine.cu``: one pass over the (k, P) stacked
cluster gradients, each read once, the k-step recurrence in registers.
It is bound by memory traffic, ``(k + 1) * P * 4`` bytes.

:func:`tolfl_combine` launches the kernel on a CUDA device and runs
:func:`tolfl_combine_plain` on the CPU; there is no fallback from one to
the other.  ``LAUNCHES`` counts kernel launches, so a run can show that
its combine went through the kernel.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch import DeviceLike, resolve_device
from repro_torch.kernels import _build

#: kernel launches in this process (one per :func:`tolfl_combine_cuda`)
LAUNCHES = 0


def tolfl_combine_plain(gs: torch.Tensor, ns: torch.Tensor) -> torch.Tensor:
    """The k-step loop of ``combine_pair`` on tensors, with the kernel's
    exact order of rounded operations: on the card the kernel equals it
    bit for bit.  gs: (k, P) f32; ns: (k,) f32 -> (P,) f32."""
    tot = torch.zeros((), dtype=torch.float32, device=gs.device)
    acc = torch.zeros(gs.shape[1:], dtype=torch.float32, device=gs.device)
    for i in range(gs.shape[0]):
        tot = tot + ns[i]
        r = torch.where(tot > 0, ns[i] / torch.clamp_min(tot, 1e-30),
                        torch.zeros_like(tot))
        acc = (1.0 - r) * acc + r * gs[i]
    return acc


@functools.lru_cache(maxsize=None)
def _entry():
    fn = _build.load("tolfl_combine").tolfl_combine_f32
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.c_int, ctypes.c_longlong, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _check(gs: torch.Tensor, ns: torch.Tensor) -> None:
    if gs.dim() != 2:
        raise ValueError(f"gs must be (k, P), got shape {tuple(gs.shape)}")
    k, P = gs.shape
    if k < 1 or P < 1:
        raise ValueError(f"gs must have k >= 1 and P >= 1, got {(k, P)}")
    if tuple(ns.shape) != (k,):
        raise ValueError(f"ns must be ({k},), got {tuple(ns.shape)}")
    for name, t in (("gs", gs), ("ns", ns)):
        if t.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {t.dtype}")
    if gs.device != ns.device:
        raise ValueError(f"gs on {gs.device} but ns on {ns.device}")


def tolfl_combine_cuda(gs: torch.Tensor, ns: torch.Tensor) -> torch.Tensor:
    """Launch the CUDA kernel on PyTorch's current stream."""
    global LAUNCHES
    _check(gs, ns)
    if gs.device.type != "cuda":
        raise ValueError(f"tolfl_combine_cuda needs CUDA tensors, got "
                         f"{gs.device}")
    if not (gs.is_contiguous() and ns.is_contiguous()):
        raise ValueError("gs and ns must be contiguous")
    k, P = gs.shape
    out = torch.empty((P,), dtype=torch.float32, device=gs.device)
    with torch.cuda.device(gs.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = _entry()(gs.data_ptr(), ns.data_ptr(), out.data_ptr(), k, P,
                       stream)
    if err != 0:
        raise RuntimeError(f"tolfl_combine kernel launch failed: CUDA "
                           f"error {err}")
    LAUNCHES += 1
    return out


def tolfl_combine(gs: torch.Tensor, ns: torch.Tensor,
                  device: DeviceLike = None) -> torch.Tensor:
    """gs: (k, P) stacked flattened cluster gradients (f32); ns: (k,)
    sample counts.  Returns the Tol-FL combined gradient (P,).

    The one entry point of the combine (``ops.tolfl_combine`` re-exports
    it).  ``device=None`` means CUDA, where the kernel launches or the
    call raises; ``device="cpu"`` runs the plain version.  The tensors
    must already lie on that device."""
    dev = resolve_device(device)
    for name, t in (("gs", gs), ("ns", ns)):
        if t.device.type != dev.type or (dev.index is not None
                                         and t.device.index != dev.index):
            raise ValueError(f"{name} is on {t.device}, expected {dev}")
    if dev.type == "cuda":
        return tolfl_combine_cuda(gs, ns)
    _check(gs, ns)
    return tolfl_combine_plain(gs, ns)


def tolfl_combine_tree(gs_tree, ns: torch.Tensor,
                       device: DeviceLike = None):
    """Apply the combine leaf-wise over a stacked gradient tree (leaves
    (k, ...)); returns a tree of (...) leaves."""
    if isinstance(gs_tree, dict):
        return {key: tolfl_combine_tree(v, ns, device)
                for key, v in gs_tree.items()}
    k = gs_tree.shape[0]
    flat = gs_tree.reshape(k, -1).to(torch.float32).contiguous()
    return tolfl_combine(flat, ns, device).reshape(gs_tree.shape[1:]).to(
        gs_tree.dtype)
