"""Row-stable dense product for the anomaly service's score path: the
Hopper kernel and its plain PyTorch version.

``y = x @ w + b`` with x (M, K), w (K, N), b (N,) or None, float32.  The
kernel (``repro_torch/csrc/row_dense.cu``) sums every output over k in
order with one FMA a step, so a row's result does not depend on M or on
where the row sits: a window scored alone equals the same window in a
padded bucket bit for bit, ``repro``'s contract for its score core
(``tests/test_serving_anomaly.py``), which cuBLAS breaks by picking
another GEMM for another row count.  It replaces no Pallas kernel:
``repro``'s score core leaves the products to XLA
(``src/repro/serving/anomaly/engine.py:55``).

:func:`row_dense` launches the kernel for CUDA tensors and runs
:func:`row_dense_plain` for CPU ones; there is no fallback.  The plain
version is ``params.dense_apply``'s arithmetic (one product, then the
bias), so on the CPU the score path computes what ``anomaly_scores``
computes.  On the card kernel and plain version agree within
:func:`error_bound`, not bit for bit (cuBLAS sums in another order).
``LAUNCHES`` counts kernel launches, a CUDA graph's capture included (its
replays launch without Python).

The kernel is built against latency, which bounds every service product
(each is under a microsecond of work on either the memory or the CUDA
cores): 128 threads a block, 2 x 4 outputs a thread, blocks of BM x BN
with BN = 16 for N <= 16 and 32 otherwise, so the service's products
give two blocks an SM; all of K in shared memory at once, copied by
``cp.async`` in slabs of 64 k steps (one commit group each, so the first
slab's FMAs start while the second is in flight); K a template constant
for the service's K (``ROW_DENSE_KS``), a runtime value in chunks of 128
otherwise.  :func:`row_dense_plan` mirrors the plan and
:func:`row_dense_tiles` the outputs each thread owns.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Dict, List, Optional, Tuple

import torch

from repro_torch.kernels import _build
from repro_torch.models.params import Params

#: kernel launches in this process (one per :func:`row_dense_cuda`)
LAUNCHES = 0
#: the kernel's launch plan (csrc/row_dense.cu): threads a block, rows and
#: columns a thread, k steps a cp.async group, k steps in shared memory at
#: once where K is a runtime value, and the K the kernel is built for as a
#: constant
ROW_DENSE_THREADS = 128
ROW_DENSE_TILE = (2, 4)
ROW_DENSE_SLAB = 64
ROW_DENSE_CHUNK = 128
ROW_DENSE_KS = (16, 32, 64, 112, 128)


def row_dense_plan(M: int, K: int, N: int) -> Dict[str, object]:
    """The kernel's plan for x (M, K) @ w (K, N), as ``row_dense_f32``
    launches it: ``"BM"`` x ``"BN"`` outputs a block (BN 16 for N <= 16,
    else 32), ``"grid"`` (row blocks, column blocks), ``"k_fixed"`` (K
    where the kernel has it as a constant, else 0) and ``"chunks"``: for
    each chunk of k steps held in shared memory at once, its slabs (k0,
    k1), one cp.async group each, in the order the FMAs run them."""
    if min(M, K, N) < 1:
        raise ValueError(f"row_dense needs M, K, N >= 1, got {(M, K, N)}")
    rows, cols = ROW_DENSE_TILE
    BN = 16 if N <= 16 else 32
    BM = ROW_DENSE_THREADS * rows * cols // BN
    KC = K if K in ROW_DENSE_KS else ROW_DENSE_CHUNK
    chunks = [[(k0, min(k0 + ROW_DENSE_SLAB, c0 + KC, K))
               for k0 in range(c0, min(c0 + KC, K), ROW_DENSE_SLAB)]
              for c0 in range(0, K, KC)]
    return {"BM": BM, "BN": BN, "threads": ROW_DENSE_THREADS,
            "grid": (-(-M // BM), -(-N // BN)),
            "k_fixed": K if K in ROW_DENSE_KS else 0, "chunks": chunks}


def row_dense_tiles(M: int, K: int, N: int
                    ) -> List[Tuple[int, int, int, int]]:
    """(block x, block y, thread, (m, n) of its first output) for every
    thread of :func:`row_dense_plan`'s grid: thread t of block (bx, by)
    owns rows m, m + 1 and columns n .. n + 3 (those inside (M, N)), m =
    bx BM + 2 (t // (BN / 4)), n = by BN + 4 (t % (BN / 4))."""
    plan = row_dense_plan(M, K, N)
    BM, BN = plan["BM"], plan["BN"]
    rows, cols = ROW_DENSE_TILE
    tx = BN // cols
    gx, gy = plan["grid"]
    return [(bx, by, t, (bx * BM + rows * (t // tx), by * BN + cols * (t % tx)))
            for bx in range(gx) for by in range(gy)
            for t in range(ROW_DENSE_THREADS)]


def row_dense_plain(x: torch.Tensor, w: torch.Tensor,
                    b: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``x @ w``, then ``+ b``: x (M, K), w (K, N), b (N,) or None."""
    y = x @ w
    return y if b is None else y + b


def error_bound(x: torch.Tensor, w: torch.Tensor,
                b: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Elementwise bound on |kernel - plain| for float32 sums of K
    products in two orders: each is within K·2^-24 of the exact sum
    relative to ``|x| @ |w|`` (plus the bias add's half-ulp), so their
    difference is within twice that."""
    K = x.shape[-1]
    mag = x.abs().double() @ w.abs().double()
    if b is not None:
        mag = mag + b.abs().double()
    return 2.0 * (K + 1) * 2.0 ** -24 * mag


@functools.lru_cache(maxsize=None)
def _entry():
    fn = _build.load("row_dense").row_dense_f32
    fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 3
                   + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def _check(x: torch.Tensor, w: torch.Tensor,
           b: Optional[torch.Tensor]) -> None:
    if x.dim() != 2 or w.dim() != 2 or x.shape[1] != w.shape[0] \
            or min(*x.shape, w.shape[1]) < 1:
        raise ValueError(f"x (M, K) and w (K, N), non-empty, got "
                         f"{tuple(x.shape)} and {tuple(w.shape)}")
    if b is not None and tuple(b.shape) != (w.shape[1],):
        raise ValueError(f"b must be ({w.shape[1]},), got {tuple(b.shape)}")
    for name, t in (("x", x), ("w", w), ("b", b)):
        if t is None:
            continue
        if t.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {t.dtype}")
        if t.device != x.device:
            raise ValueError(f"{name} on {t.device}, x on {x.device}")


def row_dense_cuda(x: torch.Tensor, w: torch.Tensor,
                   b: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Launch the kernel on PyTorch's current stream."""
    global LAUNCHES
    _check(x, w, b)
    if x.device.type != "cuda":
        raise ValueError(f"row_dense_cuda needs CUDA tensors, got "
                         f"{x.device}")
    x, w = x.contiguous(), w.contiguous()
    b = None if b is None else b.contiguous()
    (M, K), N = x.shape, w.shape[1]
    y = torch.empty((M, N), dtype=torch.float32, device=x.device)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = _entry()(x.data_ptr(), w.data_ptr(),
                       None if b is None else b.data_ptr(), y.data_ptr(),
                       M, K, N, stream)
    if err != 0:
        raise RuntimeError(f"row_dense kernel launch failed: CUDA error "
                           f"{err}")
    LAUNCHES += 1
    return y


def row_dense(x: torch.Tensor, w: torch.Tensor,
              b: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``x @ w + b``, row-stable on the card: CUDA tensors launch the
    kernel or raise; CPU tensors run the plain version."""
    if x.device.type == "cuda":
        return row_dense_cuda(x, w, b)
    _check(x, w, b)
    return row_dense_plain(x, w, b)


def dense_apply(p: Params, x: torch.Tensor,
                compute_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """``params.dense_apply`` for the score path: unbatched params
    (``w`` (K, N), ``b`` (N,)), x (..., K) float32 flattened to rows for
    :func:`row_dense`.  ``compute_dtype``, if given, must be float32."""
    if compute_dtype not in (None, torch.float32):
        raise TypeError(f"row_dense computes in float32, got {compute_dtype}")
    lead = x.shape[:-1]
    y = row_dense(x.reshape(-1, x.shape[-1]), p["w"], p.get("b"))
    return y.reshape(*lead, y.shape[-1])
