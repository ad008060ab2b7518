"""Dense MLP, optionally gated (GLU).

Port of ``repro.models.mlp`` (without its sharding constraints).  Params
are float32 and are cast to the activation dtype per call.
"""
from __future__ import annotations

from typing import Tuple

import torch

from repro_torch import DeviceLike
from repro_torch.models import params as P


def mlp_init(generator: torch.Generator, d_model: int, d_ff: int, glu: bool,
             device: DeviceLike = None, lead: Tuple[int, ...] = ()
             ) -> P.Params:
    p = {"up": P.dense_init(generator, d_model, d_ff, device=device,
                            lead=lead)}
    if glu:
        p["gate"] = P.dense_init(generator, d_model, d_ff, device=device,
                                 lead=lead)
    p["down"] = P.dense_init(generator, d_ff, d_model, device=device,
                             lead=lead)
    return p


def mlp_apply(p: P.Params, x: torch.Tensor, act: str, glu: bool
              ) -> torch.Tensor:
    f = P.activation(act)
    h = P.dense_apply(p["up"], x, x.dtype)
    if glu:
        h = f(P.dense_apply(p["gate"], x, x.dtype)) * h
    else:
        h = f(h)
    return P.dense_apply(p["down"], h, x.dtype)
