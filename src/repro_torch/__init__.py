"""PyTorch/CUDA port of the Tol-FL reproduction (``repro``), for Hopper.

Mirrors ``repro``'s module paths: ``repro_torch.core.simulate`` is the
counterpart of ``repro.core.simulate`` and so on.  The package imports
torch and numpy only, never jax or ``repro``.

Every entry point takes ``device=None``, which means ``"cuda"``; with no
CUDA device it raises instead of carrying on quietly on the CPU.  Pass
``device="cpu"`` to run the plain PyTorch path on the CPU.  ``"meta"``
lays out shapes and dtypes with no storage (the dry-run's device).
"""
from __future__ import annotations

from typing import Union

import torch

DeviceLike = Union[str, torch.device, None]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """``None`` means ``"cuda"``; a CUDA device that is not there raises."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "repro_torch: no CUDA device is available; pass device='cpu' "
            "to run the plain PyTorch path on the CPU")
    if dev.type not in ("cuda", "cpu", "meta"):
        raise ValueError(f"repro_torch: unsupported device {dev}")
    return dev

