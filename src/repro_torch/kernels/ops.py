"""Public entry points for the port's kernels.

Port of ``repro.kernels.ops``.  Where ``repro`` switches between the
Pallas kernel and its jnp reference with a ``backend`` argument, the port
decides by device: ``device=None`` means ``"cuda"``, where the
hand-written kernel launches (or the call raises); ``device="cpu"`` runs
the kernel's plain PyTorch version.  Each entry point is the kernel
module's own, re-exported here.
"""
from __future__ import annotations

from repro_torch.kernels.tolfl_combine import tolfl_combine

__all__ = ["tolfl_combine"]
