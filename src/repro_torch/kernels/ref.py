"""Plain PyTorch oracles for the port's kernels (the allclose targets).

Port of ``repro.kernels.ref``; each oracle arrives with its kernel's
slice, so this one holds the Tol-FL combine only.
"""
from __future__ import annotations

import torch


def tolfl_combine_reference(gs: torch.Tensor, ns: torch.Tensor
                            ) -> torch.Tensor:
    """Streaming weighted mean over the leading axis of a stacked gradient
    block.  gs: (K, ...) f32; ns: (K,) f32.  Equals the direct weighted
    mean (the paper's k-invariance)."""
    n = torch.zeros((), dtype=torch.float32, device=gs.device)
    g = torch.zeros_like(gs[0])
    for i in range(gs.shape[0]):
        n_new = n + ns[i]
        r = torch.where(n_new > 0, ns[i] / torch.clamp_min(n_new, 1e-30),
                        torch.zeros_like(n_new))
        g = (1 - r) * g + r * gs[i]
        n = n_new
    return g
