"""RG-LRU recurrent block (RecurrentGemma / Griffin) [arXiv:2402.19427].

    r_t = sigmoid(W_a x_t)                    (recurrence gate)
    i_t = sigmoid(W_x x_t)                    (input gate)
    a_t = a ** (c * r_t),  a = sigmoid(lambda)   (c = 8)
    h_t = a_t * h_{t-1} + sqrt(1 - a_t^2) * (i_t * x_t)

Port of ``repro.models.rglru`` (without its sharding constraints).  Over
a sequence the recurrence runs in ``ops.rglru`` (the CUDA scan kernel on
the card, its plain loop on the CPU); :func:`rglru_decode` takes one step
with the formula itself, as ``repro``'s decode does.  The block wraps the
LRU with the Griffin residual structure: gelu gate branch x conv1d + LRU
branch, then an output projection.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch import DeviceLike, resolve_device
from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import ops
from repro_torch.models import params as P

C_EXP = 8.0


def rglru_init(generator: torch.Generator, cfg: ModelConfig,
               device: DeviceLike = None, lead: Tuple[int, ...] = ()
               ) -> P.Params:
    d = cfg.d_model
    w = cfg.recurrent.lru_width or d
    cw = cfg.recurrent.conv1d_width
    dev = resolve_device(device)
    # lambda init so that a = sigmoid(lambda) lies in [0.9, 0.999]
    u = torch.rand((*lead, w), generator=generator, dtype=torch.float32,
                   device=generator.device) * (0.999 - 0.9) + 0.9
    return {
        "in_x": P.dense_init(generator, d, w, device=dev, lead=lead),
        "in_gate": P.dense_init(generator, d, w, device=dev, lead=lead),
        "conv_w": P.normal_init(generator, (*lead, cw, w), 0.02, dev),
        "conv_b": torch.zeros((*lead, w), dtype=torch.float32, device=dev),
        "gate_a": P.dense_init(generator, w, w, device=dev, scale=0.02,
                               lead=lead),
        "gate_x": P.dense_init(generator, w, w, device=dev, scale=0.02,
                               lead=lead),
        "lam": torch.log(u / (1 - u)).to(dev),
        "out": P.dense_init(generator, w, d, device=dev, lead=lead),
    }


def _causal_conv1d(xw: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                   state: Optional[torch.Tensor]
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Depthwise causal conv over time.  xw: (B,S,W); w: (cw,W); state:
    (B, cw-1, W) trailing context from the previous segment.  Returns the
    output and the new trailing context."""
    B, S, W = xw.shape
    cw = w.shape[0]
    pad = (torch.zeros((B, cw - 1, W), dtype=xw.dtype, device=xw.device)
           if state is None else state.to(xw.dtype))
    xp = torch.cat([pad, xw], dim=1)
    out = torch.zeros_like(xw)
    for i in range(cw):
        out = out + xp[:, i:i + S, :] * w[i].to(xw.dtype)
    out = out + b.to(xw.dtype)
    return out, xp[:, xp.shape[1] - (cw - 1):, :]


def _lru_scan(a_t: torch.Tensor, b_t: torch.Tensor,
              h0: Optional[torch.Tensor]) -> torch.Tensor:
    """h_t = a_t * h_{t-1} + b_t over axis 1.  a_t, b_t: (B,S,W) float32.
    The one call of the scan kernel."""
    return ops.rglru(a_t.contiguous(), b_t.contiguous(),
                     None if h0 is None else h0.contiguous())


def _gates(p: P.Params, x: torch.Tensor, state: Optional[dict]):
    """The LRU's inputs: (a_t, b_t) float32, the gelu gate branch and the
    new conv context."""
    gate_branch = F.gelu(P.dense_apply(p["in_gate"], x, x.dtype),
                         approximate="tanh")
    xw = P.dense_apply(p["in_x"], x, x.dtype)
    xw, new_conv = _causal_conv1d(xw, p["conv_w"], p["conv_b"],
                                  None if state is None else state["conv"])
    xw32 = xw.to(torch.float32)   # repro's bf16 @ f32 promotes x exactly
    r = torch.sigmoid(P.dense_apply(p["gate_a"], xw32, torch.float32))
    i = torch.sigmoid(P.dense_apply(p["gate_x"], xw32, torch.float32))
    log_a = C_EXP * r * F.logsigmoid(p["lam"].to(torch.float32))
    a_t = torch.exp(log_a)
    # sqrt(1 - a^2) normaliser, clamped for stability
    norm = torch.sqrt(torch.clamp_min(1.0 - torch.square(a_t), 1e-12))
    b_t = norm * (i * xw32)
    return a_t, b_t, gate_branch, new_conv


def rglru_apply(p: P.Params, x: torch.Tensor, cfg: ModelConfig,
                state: Optional[dict] = None) -> Tuple[torch.Tensor, dict]:
    """x: (B,S,d) -> (out, new_state), the recurrence through the scan
    kernel.  state: {'h': (B,W) f32, 'conv': (B,cw-1,W)} or None."""
    a_t, b_t, gate_branch, new_conv = _gates(p, x, state)
    h = _lru_scan(a_t, b_t, None if state is None else state["h"])
    out = P.dense_apply(p["out"], h.to(x.dtype) * gate_branch, x.dtype)
    # copies, so the cache does not hold the whole (B, S, W) h alive
    return out, {"h": h[:, -1, :].clone(), "conv": new_conv.clone()}


def rglru_decode(p: P.Params, x: torch.Tensor, cfg: ModelConfig,
                 state: dict) -> Tuple[torch.Tensor, dict]:
    """Single-token step: x (B,1,d).  One step of the recurrence, h =
    a * h0 + b, computed here: a decode step launches no scan."""
    a_t, b_t, gate_branch, new_conv = _gates(p, x, state)
    h = a_t * state["h"][:, None, :] + b_t
    out = P.dense_apply(p["out"], h.to(x.dtype) * gate_branch, x.dtype)
    return out, {"h": h[:, -1, :], "conv": new_conv}
