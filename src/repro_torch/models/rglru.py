"""RG-LRU recurrent block (RecurrentGemma / Griffin) [arXiv:2402.19427].

    r_t = sigmoid(W_a x_t)                    (recurrence gate)
    i_t = sigmoid(W_x x_t)                    (input gate)
    a_t = a ** (c * r_t),  a = sigmoid(lambda)   (c = 8)
    h_t = a_t * h_{t-1} + sqrt(1 - a_t^2) * (i_t * x_t)

Port of ``repro.models.rglru``, with its sharding constraints.  Over
a sequence the recurrence runs in ``ops.rglru`` (the CUDA scan kernel on
the card, its plain loop on the CPU); :func:`rglru_decode` takes one step
with the formula itself, as ``repro``'s decode does.  The block wraps the
LRU with the Griffin residual structure: gelu gate branch x conv1d + LRU
branch, then an output projection.  :func:`rglru_block` runs the same
body for the sequence detector (``models/detector.py``): params with
leading scenario / device axes, no carried state, and a gradient through
the scan kernel's backward.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch import DeviceLike, resolve_device
from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import ops
from repro_torch.models import params as P
from repro_torch.sharding import logical as L

C_EXP = 8.0


def rglru_init(generator: torch.Generator, cfg: ModelConfig,
               device: DeviceLike = None, lead: Tuple[int, ...] = ()
               ) -> P.Params:
    """Every leaf in ``cfg.param_dtype`` (``lam`` and ``conv_b`` too, as
    ``repro``'s)."""
    d = cfg.d_model
    w = cfg.recurrent.lru_width or d
    cw = cfg.recurrent.conv1d_width
    dev = resolve_device(device)
    dt = getattr(torch, cfg.param_dtype)
    # lambda init so that a = sigmoid(lambda) lies in [0.9, 0.999]
    u = (torch.full((*lead, w), 0.95, device=dev) if dev.type == "meta"
         else torch.rand((*lead, w), generator=generator,
                         dtype=torch.float32, device=generator.device)
         * (0.999 - 0.9) + 0.9)
    kw = dict(device=dev, lead=lead, dtype=dt)
    return {
        "in_x": P.dense_init(generator, d, w, **kw),
        "in_gate": P.dense_init(generator, d, w, **kw),
        "conv_w": P.normal_init(generator, (*lead, cw, w), 0.02, dev, dt),
        "conv_b": torch.zeros((*lead, w), dtype=dt, device=dev),
        "gate_a": P.dense_init(generator, w, w, scale=0.02, **kw),
        "gate_x": P.dense_init(generator, w, w, scale=0.02, **kw),
        "lam": torch.log(u / (1 - u)).to(dev, dt),
        "out": P.dense_init(generator, w, d, **kw),
    }


def rglru_axes() -> P.Axes:
    """:func:`rglru_init`'s logical axes (``repro``'s)."""
    return {"in_x": P.dense_axes("embed", "state"),
            "in_gate": P.dense_axes("embed", "state"),
            "conv_w": ("conv", "state"), "conv_b": ("state",),
            "gate_a": P.dense_axes("state", None),
            "gate_x": P.dense_axes("state", None),
            "lam": ("state",), "out": P.dense_axes("state", "embed")}


def _col(t: torch.Tensor) -> torch.Tensor:
    """(*lead, W) -> (*lead, 1, 1, W): a per-channel vector that
    broadcasts against (*L, n, seq, W) activations."""
    return t[..., None, None, :]


def dense_tokens(p: P.Params, x: torch.Tensor,
                 compute_dtype: Optional[torch.dtype] = None,
                 dense: P.DenseFn = P.dense_apply) -> torch.Tensor:
    """``dense`` (``dense_apply``) over the (n, seq) token axes of x (*L,
    n, seq, in): one product per leading index, whose params broadcast
    against L."""
    *lead, n, s, d = x.shape
    y = dense(p, x.reshape(*lead, n * s, d), compute_dtype)
    return y.reshape(*y.shape[:-2], n, s, y.shape[-1])


def _causal_conv1d(xw: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                   state: Optional[torch.Tensor]
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Depthwise causal conv over time.  xw: (*L, n, S, W); w: (*lead,
    cw, W) and b: (*lead, W), whose leading axes broadcast against L;
    state: (*L, n, cw-1, W) trailing context from the previous segment,
    or None for zeros.  Returns the output and the new trailing
    context."""
    S, cw = xw.shape[-2], w.shape[-2]
    xp = (L.shardwise(lambda t: F.pad(t, (0, 0, cw - 1, 0)), xw)
          if state is None
          else torch.cat([state.to(xw.dtype), xw], dim=-2))
    out = torch.zeros_like(xw)
    for i in range(cw):
        out = out + xp[..., i:i + S, :] * _col(w[..., i, :]).to(xw.dtype)
    out = out + _col(b).to(xw.dtype)
    return out, xp[..., xp.shape[-2] - (cw - 1):, :]


def _lru_scan(a_t: torch.Tensor, b_t: torch.Tensor,
              h0: Optional[torch.Tensor]) -> torch.Tensor:
    """h_t = a_t * h_{t-1} + b_t over axis -2.  a_t, b_t: (..., S, W)
    float32, run as one (prod(...), S, W) batch; h0: (prod(...), W) or
    None.  The one call of the scan kernel."""
    S, W = a_t.shape[-2:]
    h = ops.rglru(a_t.reshape(-1, S, W).contiguous(),
                  b_t.reshape(-1, S, W).contiguous(),
                  None if h0 is None else h0.contiguous())
    return h.reshape(a_t.shape)


def _gates(p: P.Params, x: torch.Tensor, conv: Optional[torch.Tensor],
           dense: P.DenseFn = P.dense_apply):
    """The LRU's inputs from x (*L, n, seq, d): (a_t, b_t) float32, the
    gelu gate branch and the new conv context (``conv``: the trailing
    context, or None)."""
    gate_branch = F.gelu(dense_tokens(p["in_gate"], x, x.dtype, dense),
                         approximate="tanh")
    xw = L.constrain(dense_tokens(p["in_x"], x, x.dtype, dense),
                     ("batch", "seq", "state"))
    xw, new_conv = _causal_conv1d(xw, p["conv_w"], p["conv_b"], conv)
    xw32 = xw.to(torch.float32)   # repro's bf16 @ f32 promotes x exactly
    r = torch.sigmoid(dense_tokens(p["gate_a"], xw32, torch.float32, dense))
    i = torch.sigmoid(dense_tokens(p["gate_x"], xw32, torch.float32, dense))
    log_a = C_EXP * r * L.shardwise(F.logsigmoid,
                                    _col(p["lam"]).to(torch.float32))
    a_t = torch.exp(log_a)
    # sqrt(1 - a^2) normaliser, clamped for stability
    norm = torch.sqrt(torch.clamp_min(1.0 - torch.square(a_t), 1e-12))
    return a_t, norm * (i * xw32), gate_branch, new_conv


def _out(p: P.Params, h: torch.Tensor, gate_branch: torch.Tensor,
         dtype: torch.dtype, dense: P.DenseFn = P.dense_apply
         ) -> torch.Tensor:
    return dense_tokens(p["out"], h.to(dtype) * gate_branch, dtype, dense)


def rglru_apply(p: P.Params, x: torch.Tensor, cfg: ModelConfig,
                state: Optional[dict] = None) -> Tuple[torch.Tensor, dict]:
    """x: (B,S,d) -> (out, new_state), the recurrence through the scan
    kernel.  state: {'h': (B,W) f32, 'conv': (B,cw-1,W)} or None."""
    a_t, b_t, gate_branch, new_conv = _gates(
        p, x, None if state is None else state["conv"])
    h = L.constrain(_lru_scan(a_t, b_t, None if state is None
                              else state["h"]), ("batch", "seq", "state"))
    out = L.constrain(_out(p, h, gate_branch, x.dtype),
                      ("batch", "seq", "embed"))
    # copies, so the cache does not hold the whole (B, S, W) h alive
    return out, {"h": h[:, -1, :].clone(), "conv": new_conv.clone()}


def rglru_block(p: P.Params, x: torch.Tensor,
                dense: P.DenseFn = P.dense_apply) -> torch.Tensor:
    """The block over x (*L, n, seq, d) from a zero state, for params
    whose leaves carry leading axes that broadcast against L: none, (S, N)
    a device in the round loop, (S, M, 1) in IFCA's probe of every model
    on every device.  The detector's form of :func:`rglru_apply`, with
    the same body; its recurrence goes through the scan kernel as one
    (prod(L') * n, seq, W) batch, differentiable.  Returns (*L', n, seq,
    d), L' the broadcast of L and the params' axes.  ``dense`` computes
    the products (the score path passes the row-stable kernel's)."""
    a_t, b_t, gate_branch, _ = _gates(p, x, None, dense)
    return _out(p, _lru_scan(a_t, b_t, None), gate_branch, x.dtype, dense)


def rglru_decode(p: P.Params, x: torch.Tensor, cfg: ModelConfig,
                 state: dict) -> Tuple[torch.Tensor, dict]:
    """Single-token step: x (B,1,d).  One step of the recurrence, h =
    a * h0 + b, computed here: a decode step launches no scan."""
    a_t, b_t, gate_branch, new_conv = _gates(p, x, state["conv"])
    h = a_t * state["h"][:, None, :] + b_t
    return _out(p, h, gate_branch, x.dtype), {"h": h[:, -1, :],
                                              "conv": new_conv}
