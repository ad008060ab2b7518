"""Dense MLP, optionally gated (GLU).

Port of ``repro.models.mlp``, with its sharding constraints.  Params
are in the config's ``param_dtype`` (float32 by default) and are cast to
the activation dtype per call.
"""
from __future__ import annotations

from typing import Tuple

import torch

from repro_torch import DeviceLike
from repro_torch.models import params as P
from repro_torch.sharding import logical as L


def mlp_init(generator: torch.Generator, d_model: int, d_ff: int, glu: bool,
             device: DeviceLike = None, lead: Tuple[int, ...] = (),
             dtype: torch.dtype = torch.float32) -> P.Params:
    kw = dict(device=device, lead=lead, dtype=dtype)
    p = {"up": P.dense_init(generator, d_model, d_ff, **kw)}
    if glu:
        p["gate"] = P.dense_init(generator, d_model, d_ff, **kw)
    p["down"] = P.dense_init(generator, d_ff, d_model, **kw)
    return p


def mlp_axes(glu: bool) -> P.Axes:
    """:func:`mlp_init`'s logical axes (``repro``'s)."""
    a = {"up": P.dense_axes("embed", "ff")}
    if glu:
        a["gate"] = P.dense_axes("embed", "ff")
    a["down"] = P.dense_axes("ff", "embed")
    return a


def mlp_apply(p: P.Params, x: torch.Tensor, act: str, glu: bool
              ) -> torch.Tensor:
    f = P.activation(act)
    h = P.dense_apply(p["up"], x, x.dtype)
    if glu:
        h = f(P.dense_apply(p["gate"], x, x.dtype)) * h
    else:
        h = f(h)
    h = L.constrain(h, ("batch", "seq", "ff"))
    return L.constrain(P.dense_apply(p["down"], h, x.dtype),
                       ("batch", "seq", "embed"))
