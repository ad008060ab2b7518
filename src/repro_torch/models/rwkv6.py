"""RWKV6 "Finch" time-mix / channel-mix blocks [arXiv:2404.05892].

Attention-free: per-head matrix-valued state S (N x N) with data-dependent
diagonal decay w_t:

    y_t = r_t^T (S_{t-1} + diag(u) k_t v_t^T)
    S_t = diag(w_t) S_{t-1} + k_t v_t^T

Port of ``repro.models.rwkv6``, with its sharding constraints.
Token-shift interpolation (ddlerp) uses learned mus plus LoRA adapters on
the shifted mix.  The recurrence runs in ``ops.rwkv6`` over a prompt and
over a decode step alike (the CUDA kernel on the card, its plain loop on
the CPU), so a decode step launches the kernel once per layer.
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

DDLERP_RANK = 32
DECAY_RANK = 64
MIX_NAMES = ("w", "k", "v", "r", "g")
GROUP_NORM_EPS = 1e-5


def timemix_init(generator: torch.Generator, cfg: ModelConfig,
                 device: DeviceLike = None, lead: Tuple[int, ...] = ()
                 ) -> P.Params:
    """``repro``'s time-mix params (keys and shapes) in
    ``cfg.param_dtype``, each leaf with the stacked dims ``lead`` in
    front."""
    d = cfg.d_model
    H, N = cfg.recurrent.num_heads, cfg.recurrent.head_size
    if H * N != d:
        raise ValueError(f"num_heads * head_size = {H} * {N} != d_model {d}")
    dev = resolve_device(device)
    dt = getattr(torch, cfg.param_dtype)
    nmix = len(MIX_NAMES)

    def dense(i, o, scale=None):
        return P.dense_init(generator, i, o, device=dev, scale=scale,
                            lead=lead, dtype=dt)

    # token-shift base mus: one per mix target + the ddlerp input mix
    p = {"mu": P.normal_init(generator, (*lead, nmix + 1, d), 0.02, dev,
                             dt),
         # ddlerp LoRA: (d -> rank -> 5*d)
         "ddlerp_a": dense(d, DDLERP_RANK * nmix, 0.02),
         "ddlerp_b": dense(DDLERP_RANK * nmix, nmix * d, 0.02)}
    for nm in ("r", "k", "v", "g"):
        p[nm] = dense(d, d)
    p["o"] = dense(d, d)
    # data-dependent decay: w_t = exp(-exp(decay_base + lora(x_w)))
    p["decay_base"] = P.normal_init(generator, (*lead, d), 0.02, dev, dt)
    p["decay_a"] = dense(d, DECAY_RANK, 0.02)
    p["decay_b"] = dense(DECAY_RANK, d, 0.02)
    p["bonus"] = P.normal_init(generator, (*lead, d), 0.02, dev, dt)  # u
    # group-norm over heads on the output
    p["ln_x"] = {"scale": torch.ones((*lead, d), dtype=dt, device=dev),
                 "bias": torch.zeros((*lead, d), dtype=dt, device=dev)}
    return p


def timemix_axes() -> P.Axes:
    """:func:`timemix_init`'s logical axes (``repro``'s)."""
    a = {"mu": (None, "embed"),
         "ddlerp_a": P.dense_axes("embed", None),
         "ddlerp_b": P.dense_axes(None, "embed")}
    for nm in ("r", "k", "v", "g"):
        a[nm] = P.dense_axes("embed", "heads")
    a["o"] = P.dense_axes("heads", "embed")
    a["decay_base"] = ("embed",)
    a["decay_a"] = P.dense_axes("embed", None)
    a["decay_b"] = P.dense_axes(None, "embed")
    a["bonus"] = ("embed",)
    a["ln_x"] = {"scale": ("embed",), "bias": ("embed",)}
    return a


def _ddlerp(p: P.Params, x: torch.Tensor, sx: torch.Tensor):
    """Finch data-dependent token-shift: returns dict name -> mixed input,
    in x's dtype."""
    B, S, d = x.shape
    diff = sx - x
    xx = x + diff * p["mu"][len(MIX_NAMES)].to(x.dtype)
    lora = torch.tanh(P.dense_apply(p["ddlerp_a"], xx, x.dtype))
    lora = P.dense_apply(p["ddlerp_b"], lora, x.dtype)
    lora = lora.reshape(B, S, len(MIX_NAMES), d)
    return {nm: x + diff * (p["mu"][i].to(x.dtype) + lora[:, :, i])
            for i, nm in enumerate(MIX_NAMES)}


def _shifted(x: torch.Tensor, shift0: torch.Tensor) -> torch.Tensor:
    """The previous token of each position: shift0, then x[:, :-1]."""
    return torch.cat([shift0[:, None, :].to(x.dtype), x[:, :-1, :]], dim=1)


def timemix_apply(p: P.Params, x: torch.Tensor, cfg: ModelConfig,
                  state: Optional[dict] = None
                  ) -> Tuple[torch.Tensor, dict]:
    """x: (B,S,d).  state: {'shift': (B,d), 'wkv': (B,H,N,N) f32} or
    None.  Returns (out (B,S,d), new state); the given state is left as
    it was."""
    B, S, d = x.shape
    H, N = cfg.recurrent.num_heads, cfg.recurrent.head_size
    if state is None:
        shift0 = torch.zeros((B, d), dtype=x.dtype, device=x.device)
        wkv0 = torch.zeros((B, H, N, N), dtype=torch.float32,
                           device=x.device)
    else:
        shift0, wkv0 = state["shift"], state["wkv"]
    mixed = _ddlerp(p, x, _shifted(x, shift0))
    r = P.dense_apply(p["r"], mixed["r"], x.dtype).reshape(B, S, H, N)
    k = P.dense_apply(p["k"], mixed["k"], x.dtype).reshape(B, S, H, N)
    v = P.dense_apply(p["v"], mixed["v"], x.dtype).reshape(B, S, H, N)
    g = F.silu(P.dense_apply(p["g"], mixed["g"], x.dtype))
    # the decay LoRA in float32 on the mixed input: repro's bf16 @ f32
    # promotes x exactly, as this cast does
    xw32 = mixed["w"].to(torch.float32)
    decay = (p["decay_base"].to(torch.float32)
             + P.dense_apply(p["decay_b"],
                             torch.tanh(P.dense_apply(p["decay_a"], xw32,
                                                      torch.float32)),
                             torch.float32))
    w = torch.exp(-torch.exp(decay)).reshape(B, S, H, N)
    u = p["bonus"].to(torch.float32).reshape(H, N)
    y, wkv = ops.rwkv6(*(t.to(torch.float32).contiguous()
                         for t in (r, k, v, w, u, wkv0)))
    # group-norm per head (population variance, eps 1e-5)
    mu = torch.mean(y, dim=-1, keepdim=True)
    var = torch.var(y, dim=-1, keepdim=True, unbiased=False)
    y = ((y - mu) * torch.rsqrt(var + GROUP_NORM_EPS)).reshape(B, S, d)
    y = (y * p["ln_x"]["scale"].to(torch.float32)
         + p["ln_x"]["bias"].to(torch.float32)).to(x.dtype)
    out = L.constrain(P.dense_apply(p["o"], y * g, x.dtype),
                      ("batch", "seq", "embed"))
    # a copy, so the cache does not hold the whole (B, S, d) x alive
    return out, {"shift": x[:, -1, :].clone(), "wkv": wkv}


def channelmix_init(generator: torch.Generator, cfg: ModelConfig,
                    device: DeviceLike = None, lead: Tuple[int, ...] = ()
                    ) -> P.Params:
    d, f = cfg.d_model, cfg.d_ff
    dev = resolve_device(device)
    dt = getattr(torch, cfg.param_dtype)
    return {"mu": P.normal_init(generator, (*lead, 2, d), 0.02, dev, dt),
            "key": P.dense_init(generator, d, f, device=dev, lead=lead,
                                dtype=dt),
            "value": P.dense_init(generator, f, d, device=dev, lead=lead,
                                  dtype=dt)}


def channelmix_axes() -> P.Axes:
    """:func:`channelmix_init`'s logical axes (``repro``'s)."""
    return {"mu": (None, "embed"), "key": P.dense_axes("embed", "ff"),
            "value": P.dense_axes("ff", "embed")}


def channelmix_apply(p: P.Params, x: torch.Tensor,
                     state: Optional[torch.Tensor] = None
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """RWKV channel-mix: squared-relu MLP with token shift.  state: (B, d)
    previous token (decode) or None (prefill).  Returns (out, new
    state)."""
    B, _, d = x.shape
    shift0 = (torch.zeros((B, d), dtype=x.dtype, device=x.device)
              if state is None else state)
    diff = _shifted(x, shift0) - x
    xk = x + diff * p["mu"][0].to(x.dtype)
    k = torch.square(torch.relu(P.dense_apply(p["key"], xk, x.dtype)))
    k = L.constrain(k, ("batch", "seq", "ff"))
    out = L.constrain(P.dense_apply(p["value"], k, x.dtype),
                      ("batch", "seq", "embed"))
    return out, x[:, -1, :].clone()
