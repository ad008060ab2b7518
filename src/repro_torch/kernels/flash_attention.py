"""Flash attention: the Hopper kernels and their plain PyTorch version.

Port of ``repro.kernels.flash_attention`` (a Pallas TPU kernel):
online-softmax GQA attention with a causal and a sliding-window mask,
float32 scores and accumulators, output in the inputs' dtype, ragged
sequence lengths masked.  It is bound by its operations (4 B H D flops
per visible (query, key) pair).  Two hand-written CUDA C++ kernels for
``sm_90a`` compute it; :func:`route` picks one from the dtype and the
head dim D, with no fallback from one to the other:

- ``"tensor_core"``, ``repro_torch/csrc/flash_attention_wgmma.cu``:
  bfloat16 at D in {64, 128, 256}.  wgmma on the bf16 tensor cores, K/V
  tiles brought by TMA into a two-stage ring, two warpgroups of 64
  (query, head) rows each.
- ``"cuda_core"``, ``repro_torch/csrc/flash_attention.cu``: float32 at D
  in {32, 64, 128, 256} and bfloat16 at D = 32.  Both products in float32
  on the CUDA cores; float32 inputs stay off the bf16 tensor cores, whose
  inputs would round them.

Any other dtype or D raises.  :func:`flash_attention` launches the
routed kernel for CUDA tensors and runs :func:`flash_attention_plain` for
CPU tensors.  ``LAUNCHES`` counts every attention kernel launch and
``TC_LAUNCHES`` the tensor-core kernel's, so a run can show which kernel
served it.

The gradient (:class:`FlashAttentionFn`) is a third hand-written kernel,
``repro_torch/csrc/flash_attention_bwd.cu``: float32 or bfloat16 at D in
``HEAD_DIMS``, every product in float32 on the CUDA cores, lse
recomputed from q and k so the forward kernels stay as they are.  On CPU
tensors the gradient is :func:`flash_attention_backward_plain`, written
out (not autograd through the plain forward).  ``BWD_LAUNCHES`` counts
the backward kernel's launches.
"""
from __future__ import annotations

import ctypes
import functools
import math
from typing import List, Optional, Tuple

import torch

from repro_torch.kernels import _build

#: kernel launches in this process (one per :func:`flash_attention_cuda`)
LAUNCHES = 0
#: launches of the tensor-core kernel among them
TC_LAUNCHES = 0
#: backward kernel launches (one per :func:`flash_attention_bwd_cuda`)
BWD_LAUNCHES = 0
#: head dims the CUDA-core kernel is built for
HEAD_DIMS = (32, 64, 128, 256)
#: head dims the tensor-core kernel is built for (bfloat16 only)
TC_HEAD_DIMS = (64, 128, 256)
#: the tensor-core kernel's tiles: (query, head) rows a block, keys a K/V tile
TC_ROWS, TC_KEYS = 128, 80
NEG_INF = -1e30
#: the library and C entry point of each (route, dtype)
_ENTRIES = {
    ("tensor_core", torch.bfloat16): ("flash_attention_wgmma",
                                      "flash_attention_wgmma_bf16"),
    ("cuda_core", torch.bfloat16): ("flash_attention", "flash_attention_bf16"),
    ("cuda_core", torch.float32): ("flash_attention", "flash_attention_f32"),
}


def route(dtype: torch.dtype, D: int) -> str:
    """The kernel that serves (dtype, D): ``"tensor_core"`` for bfloat16 at
    D in ``TC_HEAD_DIMS``, ``"cuda_core"`` for float32 at D in
    ``HEAD_DIMS`` and bfloat16 at D = 32; raises for anything else."""
    if dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"the kernels take float32 or bfloat16, got {dtype}")
    if dtype == torch.bfloat16 and D in TC_HEAD_DIMS:
        return "tensor_core"
    if D in HEAD_DIMS:
        return "cuda_core"
    raise ValueError(f"the kernels are built for head dims {HEAD_DIMS}, "
                     f"got {D}")


def wgmma_tiles(Sq: int, Sk: int, G: int, causal: bool,
                window: Optional[int]) -> List[Tuple[int, int]]:
    """The key tiles each block of the tensor-core kernel visits, as the
    kernel computes them: block x owns rows [128 x, 128 x + 128) of the
    Sq G (query, head) rows of a (batch, kv head), row r being query r // G,
    and visits ``count`` tiles of ``TC_KEYS`` keys from tile ``first``.
    Returns [(first, count)] per block."""
    rows = Sq * G
    plan = []
    for row0 in range(0, rows, TC_ROWS):
        q_lo, q_hi = row0 // G, (min(row0 + TC_ROWS, rows) - 1) // G
        k_lo = max(0, q_lo - window + 1) if window is not None else 0
        k_hi = min(q_hi, Sk - 1) if causal else Sk - 1
        first = k_lo // TC_KEYS
        plan.append((first, k_hi // TC_KEYS - first + 1 if k_hi >= k_lo
                     else 0))
    return plan


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


def flash_attention_backward_plain(q: torch.Tensor, k: torch.Tensor,
                                   v: torch.Tensor, o: torch.Tensor,
                                   do: torch.Tensor, causal: bool = True,
                                   window: Optional[int] = None
                                   ) -> Tuple[torch.Tensor, torch.Tensor,
                                              torch.Tensor]:
    """(dq, dk, dv) of :func:`flash_attention_plain` given its output o and
    the output's gradient do, written out in float32 as the backward
    kernel computes it: lse = m + log l over the visible keys, p =
    exp(s - lse), delta = rowsum(do * o), ds = p (do v^T - delta), dq =
    ds k / sqrt(D), dk = ds^T q / sqrt(D) and dv = p^T do summed over each
    kv head's G query heads.  A row with no visible key has zero
    gradient.  Returned in the inputs' dtype."""
    B, Sq, H, D = q.shape
    _, Sk, KVH, _ = k.shape
    G = H // KVH
    f32 = torch.float32
    scale = 1.0 / math.sqrt(D)
    qg = q.reshape(B, Sq, KVH, G, D).to(f32)
    dog = do.reshape(B, Sq, KVH, G, D).to(f32)
    kf, vf = k.to(f32), v.to(f32)
    ok = visible(Sq, Sk, causal, window, q.device)
    s = torch.where(ok, torch.einsum("bqhgd,bkhd->bhgqk", qg, kf) * scale,
                    NEG_INF)
    m = torch.amax(s, dim=-1, keepdim=True)
    l = torch.sum(torch.where(ok, torch.exp(s - m), 0.0), dim=-1,  # noqa: E741
                  keepdim=True)
    lse = torch.where(l > 0, m + torch.log(l), 0.0)
    p = torch.where(ok, torch.exp(s - lse), 0.0)
    delta = torch.sum(dog * o.reshape(B, Sq, KVH, G, D).to(f32), dim=-1)
    dp = torch.einsum("bqhgd,bkhd->bhgqk", dog, vf)
    ds = p * (dp - delta.permute(0, 2, 3, 1)[..., None])
    dq = torch.einsum("bhgqk,bkhd->bqhgd", ds, kf) * scale
    dk = torch.einsum("bhgqk,bqhgd->bkhd", ds, qg) * scale
    dv = torch.einsum("bhgqk,bqhgd->bkhd", p, dog)
    return (dq.reshape(B, Sq, H, D).to(q.dtype), dk.to(k.dtype),
            dv.to(v.dtype))


@functools.lru_cache(maxsize=None)
def _entry(kernel: str, dtype: torch.dtype):
    lib, name = _ENTRIES[(kernel, dtype)]
    fn = getattr(_build.load(lib), name)
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
                         causal: bool = True, window: Optional[int] = None,
                         kernel: Optional[str] = None) -> torch.Tensor:
    """Launch a CUDA kernel on PyTorch's current stream: the one
    :func:`route` picks, or ``kernel`` ("tensor_core" or "cuda_core") where
    that kernel takes the inputs' dtype and D."""
    global LAUNCHES, TC_LAUNCHES
    _check(q, k, v)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention_cuda needs CUDA tensors, got "
                         f"{q.device}")
    B, Sq, H, D = q.shape
    Sk, KVH = k.shape[1], k.shape[2]
    kernel = kernel or route(q.dtype, D)
    if (kernel, q.dtype) not in _ENTRIES or D not in (
            TC_HEAD_DIMS if kernel == "tensor_core" else HEAD_DIMS):
        raise ValueError(f"no {kernel} kernel for {q.dtype} at D = {D}")
    if window is not None and window < 1:
        raise ValueError(f"window must be >= 1 or None, got {window}")
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError("q, k, v must be contiguous")
    if kernel == "tensor_core" and any(x.data_ptr() % 16
                                       for x in (q, k, v)):
        raise ValueError("the tensor-core kernel needs q, k, v on 16-byte "
                         "boundaries")
    out = torch.empty_like(q)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = _entry(kernel, q.dtype)(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), B, Sq,
            Sk, H, KVH, D, int(causal), -1 if window is None else window,
            stream)
    if err != 0:
        raise RuntimeError(f"flash_attention {kernel} kernel launch failed: "
                           f"error {err}")
    LAUNCHES += 1
    if kernel == "tensor_core":
        TC_LAUNCHES += 1
    return out


@functools.lru_cache(maxsize=None)
def _bwd_entry(dtype: torch.dtype):
    lib = _build.load("flash_attention_bwd")
    fn = (lib.flash_attention_bwd_f32 if dtype == torch.float32
          else lib.flash_attention_bwd_bf16)
    fn.argtypes = ([ctypes.c_void_p] * 10 + [ctypes.c_int] * 8
                   + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def flash_attention_bwd_cuda(q: torch.Tensor, k: torch.Tensor,
                             v: torch.Tensor, o: torch.Tensor,
                             do: torch.Tensor, causal: bool = True,
                             window: Optional[int] = None
                             ) -> Tuple[torch.Tensor, torch.Tensor,
                                        torch.Tensor]:
    """Launch the backward kernel on PyTorch's current stream: (dq, dk,
    dv) in the inputs' dtype.  float32 or bfloat16 at D in
    ``HEAD_DIMS``; raises for anything else."""
    global BWD_LAUNCHES
    _check(q, k, v)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention_bwd_cuda needs CUDA tensors, got "
                         f"{q.device}")
    B, Sq, H, D = q.shape
    Sk, KVH = k.shape[1], k.shape[2]
    if q.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"the backward kernel takes float32 or bfloat16, "
                        f"got {q.dtype}")
    if D not in HEAD_DIMS:
        raise ValueError(f"the backward kernel is built for head dims "
                         f"{HEAD_DIMS}, got {D}")
    for name, t in (("o", o), ("do", do)):
        if tuple(t.shape) != tuple(q.shape) or t.dtype != q.dtype \
                or t.device != q.device:
            raise ValueError(f"{name} must match q: {tuple(q.shape)} "
                             f"{q.dtype} on {q.device}, got "
                             f"{tuple(t.shape)} {t.dtype} on {t.device}")
    if window is not None and window < 1:
        raise ValueError(f"window must be >= 1 or None, got {window}")
    if not all(t.is_contiguous() for t in (q, k, v, o, do)):
        raise ValueError("q, k, v, o and do must be contiguous")
    dq, dk, dv = (torch.empty_like(t) for t in (q, k, v))
    lse = torch.empty((B, H, Sq), dtype=torch.float32, device=q.device)
    delta = torch.empty_like(lse)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = _bwd_entry(q.dtype)(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
            do.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
            lse.data_ptr(), delta.data_ptr(), B, Sq, Sk, H, KVH, D,
            int(causal), -1 if window is None else window, stream)
    if err != 0:
        raise RuntimeError(f"flash_attention backward kernel launch failed: "
                           f"error {err}")
    BWD_LAUNCHES += 1
    return dq, dk, dv


class FlashAttentionFn(torch.autograd.Function):
    """Attention and its gradient: the kernels on CUDA tensors, the plain
    versions on CPU ones.  Saves q, k, v and the output."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window):
        if q.device.type == "cuda":
            o = flash_attention_cuda(q, k, v, causal, window)
        else:
            _check(q, k, v)
            o = flash_attention_plain(q, k, v, causal, window)
        ctx.save_for_backward(q, k, v, o)
        ctx.causal, ctx.window = causal, window
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o = ctx.saved_tensors
        do = do.contiguous()
        if q.device.type == "cuda":
            dq, dk, dv = flash_attention_bwd_cuda(q, k, v, o, do, ctx.causal,
                                                  ctx.window)
        else:
            dq, dk, dv = flash_attention_backward_plain(
                q, k, v, o, do, ctx.causal, ctx.window)
        return dq, dk, dv, None, None


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = True, window: Optional[int] = None
                    ) -> torch.Tensor:
    """q: (B, S, H, D); k, v: (B, Sk, KVH, D); H % KVH == 0.  Returns
    (B, S, H, D) in q's dtype.

    The one entry point of the attention kernels (``ops.attention``
    re-exports it), differentiable through :class:`FlashAttentionFn`:
    CUDA tensors launch the kernels or raise; CPU tensors run the plain
    versions."""
    return FlashAttentionFn.apply(q, k, v, causal, window)
