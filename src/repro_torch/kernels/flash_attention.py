"""Flash attention: the Hopper kernel and its plain PyTorch version.

Port of ``repro.kernels.flash_attention`` (a Pallas TPU kernel).  The
kernel is hand-written CUDA C++ for ``sm_90a``,
``repro_torch/csrc/flash_attention.cu``: online-softmax GQA attention
with a causal and a sliding-window mask, float32 scores and
accumulators, output in the inputs' dtype (float32 or bfloat16), ragged
sequence lengths masked.  It is bound by its operations (4 B H D flops
per visible (query, key) pair).

:func:`flash_attention` launches the kernel for CUDA tensors and runs
:func:`flash_attention_plain` for CPU tensors; there is no fallback from
one to the other.  ``LAUNCHES`` counts kernel launches, so a run can show
that its attention went through the kernel.
"""
from __future__ import annotations

import ctypes
import functools
import math
from typing import Optional

import torch

from repro_torch.kernels import _build

#: kernel launches in this process (one per :func:`flash_attention_cuda`)
LAUNCHES = 0
#: head dims the kernel is built for
HEAD_DIMS = (32, 64, 128, 256)
NEG_INF = -1e30


def visible(Sq: int, Sk: int, causal: bool, window: Optional[int],
            device=None) -> torch.Tensor:
    """(Sq, Sk) bool: key j is visible from query i (d = i - j; d >= 0
    when causal, d < window when windowed)."""
    d = (torch.arange(Sq, device=device)[:, None]
         - torch.arange(Sk, device=device)[None, :])
    ok = torch.ones((Sq, Sk), dtype=torch.bool, device=device)
    if causal:
        ok &= d >= 0
    if window is not None:
        ok &= d < window
    return ok


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          causal: bool = True, window: Optional[int] = None
                          ) -> torch.Tensor:
    """Masked softmax attention in float32, output in ``q.dtype``; a row
    with no visible key is 0, as in the kernel.  q (B, Sq, H, D); k, v
    (B, Sk, KVH, D)."""
    B, Sq, H, D = q.shape
    _, Sk, KVH, _ = k.shape
    G = H // KVH
    qg = q.reshape(B, Sq, KVH, G, D).to(torch.float32)
    s = torch.einsum("bqhgd,bkhd->bhgqk", qg, k.to(torch.float32)) * (
        1.0 / math.sqrt(D))
    ok = visible(Sq, Sk, causal, window, q.device)
    s = torch.where(ok, s, NEG_INF)
    m = torch.amax(s, dim=-1, keepdim=True)
    p = torch.where(ok, torch.exp(s - m), 0.0)
    l = torch.sum(p, dim=-1, keepdim=True)  # noqa: E741
    out = torch.einsum("bhgqk,bkhd->bhgqd", p, v.to(torch.float32))
    out = out / torch.clamp_min(l, 1e-30)
    return out.permute(0, 3, 1, 2, 4).reshape(B, Sq, H, D).to(q.dtype)


@functools.lru_cache(maxsize=None)
def _entry(dtype: torch.dtype):
    name = {torch.float32: "flash_attention_f32",
            torch.bfloat16: "flash_attention_bf16"}[dtype]
    fn = getattr(_build.load("flash_attention"), name)
    fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 8
                   + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> None:
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError("q, k, v must be (B, S, heads, D)")
    B, Sq, H, D = q.shape
    if k.shape[0] != B or k.shape[3] != D or v.shape != k.shape:
        raise ValueError(f"k, v must be (B, Sk, KVH, D) matching q "
                         f"{tuple(q.shape)}, got {tuple(k.shape)} and "
                         f"{tuple(v.shape)}")
    KVH = k.shape[2]
    if min(B, Sq, k.shape[1], H, KVH) < 1 or H % KVH:
        raise ValueError(f"need H % KVH == 0 and non-empty shapes, got "
                         f"q {tuple(q.shape)}, k {tuple(k.shape)}")
    if not (q.dtype == k.dtype == v.dtype):
        raise TypeError(f"q, k, v dtypes differ: {q.dtype}, {k.dtype}, "
                        f"{v.dtype}")
    if not (q.device == k.device == v.device):
        raise ValueError(f"q, k, v on {q.device}, {k.device}, {v.device}")


def flash_attention_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         causal: bool = True, window: Optional[int] = None
                         ) -> torch.Tensor:
    """Launch the CUDA kernel on PyTorch's current stream."""
    global LAUNCHES
    _check(q, k, v)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention_cuda needs CUDA tensors, got "
                         f"{q.device}")
    if q.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"the kernel takes float32 or bfloat16, got "
                        f"{q.dtype}")
    B, Sq, H, D = q.shape
    Sk, KVH = k.shape[1], k.shape[2]
    if D not in HEAD_DIMS:
        raise ValueError(f"the kernel is built for head dims {HEAD_DIMS}, "
                         f"got {D}")
    if window is not None and window < 1:
        raise ValueError(f"window must be >= 1 or None, got {window}")
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError("q, k, v must be contiguous")
    out = torch.empty_like(q)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = _entry(q.dtype)(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                              out.data_ptr(), B, Sq, Sk, H, KVH, D,
                              int(causal), -1 if window is None else window,
                              stream)
    if err != 0:
        raise RuntimeError(f"flash_attention kernel launch failed: CUDA "
                           f"error {err}")
    LAUNCHES += 1
    return out


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = True, window: Optional[int] = None
                    ) -> torch.Tensor:
    """q: (B, S, H, D); k, v: (B, Sk, KVH, D); H % KVH == 0.  Returns
    (B, S, H, D) in q's dtype.

    The one entry point of the attention kernel (``ops.attention``
    re-exports it): CUDA tensors launch the kernel or raise; CPU tensors
    run the plain version."""
    if q.device.type == "cuda":
        return flash_attention_cuda(q, k, v, causal, window)
    _check(q, k, v)
    return flash_attention_plain(q, k, v, causal, window)
