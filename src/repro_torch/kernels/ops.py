"""Public entry points for the port's kernels.

Port of ``repro.kernels.ops``.  Where ``repro`` switches between the
Pallas kernel and its jnp reference with a ``backend`` argument, the port
decides by device: CUDA tensors (or ``device=None``, meaning CUDA, for
the combine) launch the hand-written kernel or raise; CPU tensors run
the kernel's plain PyTorch version.  Each entry point is the kernel
module's own, re-exported here.
"""
from __future__ import annotations

from repro_torch.kernels.flash_attention import flash_attention as attention
from repro_torch.kernels.rglru_scan import rglru_scan as rglru
from repro_torch.kernels.rwkv6_scan import rwkv6_scan as rwkv6
from repro_torch.kernels.tolfl_combine import (tolfl_combine,
                                               tolfl_round_update)

__all__ = ["attention", "rglru", "rwkv6", "tolfl_combine",
           "tolfl_round_update"]
