"""Attention for the serving path: GQA projections, RoPE, the prefill
attention through the flash-attention kernel, and one-token decode
against a circular KV cache.

Port of ``repro.models.attention``, its sharding constraints at
``repro``'s places (the identity without an active mesh).
Prefill and full-sequence attention go through ``ops.attention`` (the
CUDA kernel on the card, its plain version on the CPU); ``repro``'s
pure-XLA ``blocked_attention`` has no counterpart, since the kernel takes
its place.  Masks: causal and sliding-window.  Optional QKV bias
(Qwen1.5) and qk-norm (Qwen3).
"""
from __future__ import annotations

import math
from typing import Optional, Tuple

import torch

from repro_torch import DeviceLike
from repro_torch.configs.base import AttentionConfig
from repro_torch.kernels import ops
from repro_torch.models import params as P
from repro_torch.sharding import logical as L

NEG_INF = -1e30


# ---------------------------------------------------------------------------
# RoPE
# ---------------------------------------------------------------------------
def rope_freqs(head_dim: int, theta: float, positions: torch.Tensor
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """cos/sin tables: positions (...,) -> (..., head_dim//2)."""
    inv = 1.0 / (theta ** (torch.arange(0, head_dim, 2, dtype=torch.float32,
                                        device=positions.device) / head_dim))
    ang = positions[..., None].to(torch.float32) * inv
    return torch.cos(ang), torch.sin(ang)


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor
               ) -> torch.Tensor:
    """x: (B, S, H, D); cos/sin: (B, S, D//2) or (S, D//2).  Rotates the
    two halves of the head dim in float32; returns x's dtype."""
    x1, x2 = torch.chunk(x.to(torch.float32), 2, dim=-1)
    if cos.dim() == 2:
        cos, sin = cos[None, :, None, :], sin[None, :, None, :]
    else:
        cos, sin = cos[:, :, None, :], sin[:, :, None, :]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin],
                     dim=-1).to(x.dtype)


# ---------------------------------------------------------------------------
# Projections
# ---------------------------------------------------------------------------
def attn_init(generator: torch.Generator, d_model: int, cfg: AttentionConfig,
              device: DeviceLike = None, lead: Tuple[int, ...] = (),
              dtype: torch.dtype = torch.float32) -> P.Params:
    """The projections in ``dtype``; Qwen3's qk-norm scales stay float32,
    as ``repro`` builds them (``jnp.ones`` with no dtype)."""
    q_dim = cfg.num_heads * cfg.head_dim
    kv_dim = cfg.num_kv_heads * cfg.head_dim
    kw = dict(bias=cfg.qkv_bias, device=device, lead=lead, dtype=dtype)
    return {"q": P.dense_init(generator, d_model, q_dim, **kw),
            "k": P.dense_init(generator, d_model, kv_dim, **kw),
            "v": P.dense_init(generator, d_model, kv_dim, **kw),
            "o": P.dense_init(generator, q_dim, d_model, device=device,
                              lead=lead, dtype=dtype),
            **({"q_norm": P.rmsnorm_init(cfg.head_dim, device, lead),
                "k_norm": P.rmsnorm_init(cfg.head_dim, device, lead)}
               if cfg.qk_norm else {})}


def attn_axes(cfg: AttentionConfig) -> P.Axes:
    """:func:`attn_init`'s logical axes (``repro``'s)."""
    a = {"q": P.dense_axes("embed", "heads", cfg.qkv_bias),
         "k": P.dense_axes("embed", "kv_heads", cfg.qkv_bias),
         "v": P.dense_axes("embed", "kv_heads", cfg.qkv_bias),
         "o": P.dense_axes("heads", "embed")}
    if cfg.qk_norm:
        a["q_norm"] = {"scale": ("head_dim",)}
        a["k_norm"] = {"scale": ("head_dim",)}
    return a


def project_qkv(p: P.Params, x: torch.Tensor, cfg: AttentionConfig,
                positions: torch.Tensor, norm_eps: float = 1e-6,
                compute_dtype: Optional[torch.dtype] = None):
    """x: (B,S,E) -> q (B,S,H,D), k/v (B,S,KVH,D) with RoPE on q and k,
    after the per-head RMS norm of q and k (Qwen3's qk-norm: float32 over
    the head dim, ``norm_eps``, times the scale, cast back) where
    ``cfg.qk_norm``."""
    B, S, _ = x.shape

    def heads(name, n):
        y = L.even_view(P.dense_apply(p[name], x, compute_dtype), -1, n)
        return y.reshape(B, S, n, cfg.head_dim)
    q = heads("q", cfg.num_heads)
    k = heads("k", cfg.num_kv_heads)
    v = heads("v", cfg.num_kv_heads)
    if cfg.qk_norm:
        q = P.rmsnorm_apply(p["q_norm"], q, norm_eps)
        k = P.rmsnorm_apply(p["k_norm"], k, norm_eps)
    if cfg.rope_theta > 0:
        cos, sin = rope_freqs(cfg.head_dim, cfg.rope_theta, positions)
        q = apply_rope(q, cos, sin)
        k = apply_rope(k, cos, sin)
    q = L.constrain(q, ("batch", "seq", "heads", None))
    k = L.constrain(k, ("batch", "seq", "kv_heads", None))
    v = L.constrain(v, ("batch", "seq", "kv_heads", None))
    return q, k, v


def attn_apply(p: P.Params, x: torch.Tensor, cfg: AttentionConfig,
               norm_eps: float = 1e-6, window: Optional[int] = None,
               causal: Optional[bool] = None,
               positions: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Full self-attention block for prefill: x (B,S,E) -> (B,S,E),
    through ``ops.attention``."""
    B, S, _ = x.shape
    if positions is None:
        positions = torch.arange(S, device=x.device)
    causal = cfg.causal if causal is None else causal
    window = cfg.sliding_window if window is None else window
    q, k, v = project_qkv(p, x, cfg, positions, norm_eps,
                          compute_dtype=x.dtype)
    out = ops.attention(q, k, v, causal=causal, window=window)
    out = L.merged_heads(out.reshape(B, S, cfg.num_heads * cfg.head_dim),
                         -1, cfg.num_heads)
    return L.constrain(P.dense_apply(p["o"], out, x.dtype),
                       ("batch", "seq", "embed"))


# ---------------------------------------------------------------------------
# Decode attention (one new token against a cache)
# ---------------------------------------------------------------------------
def decode_attention(q: torch.Tensor, k_cache: torch.Tensor,
                     v_cache: torch.Tensor, k_new: torch.Tensor,
                     v_new: torch.Tensor,
                     cache_valid: Optional[torch.Tensor] = None
                     ) -> torch.Tensor:
    """q: (B,1,H,D); caches: (B,Sc,KVH,D); new k/v: (B,1,KVH,D).

    The new token attends to every valid cached slot plus itself.
    ``cache_valid``: (Sc,) bool, False for empty or out-of-window slots
    (see :func:`cache_slot_validity`).  Scores and the softmax are
    float32; the output is q's dtype.  DTensors compute on their local
    shards (``sharding.logical.heads_call``): the batch and the heads
    sharded, a cache's sequence gathered first (DTensor's einsums here
    flatten a sharded dim, which torch 2.11 refuses)."""
    if L.any_dtensor(q, k_cache, v_cache, k_new, v_new):
        rest = () if cache_valid is None else (cache_valid,)
        return L.heads_call(_decode_attention, q,
                            (k_cache, v_cache, k_new, v_new), rest)
    return _decode_attention(q, k_cache, v_cache, k_new, v_new, cache_valid)


def _decode_attention(q: torch.Tensor, k_cache: torch.Tensor,
                      v_cache: torch.Tensor, k_new: torch.Tensor,
                      v_new: torch.Tensor,
                      cache_valid: Optional[torch.Tensor] = None
                      ) -> torch.Tensor:
    B, _, H, D = q.shape
    KVH = k_cache.shape[2]
    G = H // KVH
    f32 = torch.float32
    qg = q.reshape(B, KVH, G, D).to(f32)
    scale = 1.0 / math.sqrt(D)
    # products of the working dtype summed in float32, as repro's einsums
    # with preferred_element_type=float32
    s_c = torch.einsum("bhgd,bkhd->bhgk", qg, k_cache.to(f32)) * scale
    if cache_valid is not None:
        s_c = torch.where(cache_valid[None, None, None, :], s_c, NEG_INF)
    s_n = torch.einsum("bhgd,bkhd->bhgk", qg, k_new.to(f32)) * scale
    m = torch.maximum(torch.amax(s_c, dim=-1, keepdim=True),
                      torch.amax(s_n, dim=-1, keepdim=True))
    p_c = torch.exp(s_c - m)
    p_n = torch.exp(s_n - m)
    l = (torch.sum(p_c, dim=-1, keepdim=True)  # noqa: E741
         + torch.sum(p_n, dim=-1, keepdim=True))
    o = (torch.einsum("bhgk,bkhd->bhgd", p_c.to(v_cache.dtype).to(f32),
                      v_cache.to(f32))
         + torch.einsum("bhgk,bkhd->bhgd", p_n.to(v_new.dtype).to(f32),
                        v_new.to(f32)))
    out = (o / torch.clamp_min(l, 1e-30)).to(q.dtype)
    return out.reshape(B, 1, H, D)


def cache_slot_validity(Sc: int, position: int, window: Optional[int],
                        device: DeviceLike = None) -> torch.Tensor:
    """(Sc,) bool: which circular-cache slots hold attendable positions.

    Ring invariant: slot i holds the largest absolute position p_i <
    position with p_i = i (mod Sc).  A slot is valid iff that position
    exists (p_i >= 0) and, for windowed layers, iff its distance is
    inside the window (position - p_i < window).  ``position`` is a host
    int, so building the mask never waits on the card."""
    idx = torch.arange(Sc, device=device)
    pm1 = position - 1
    p_i = pm1 - torch.remainder(pm1 - idx, Sc)
    valid = p_i >= 0
    if window is not None:
        valid &= (position - p_i) < window
    return valid


def attn_decode(p: P.Params, x: torch.Tensor, cache: dict,
                cfg: AttentionConfig, position: int, norm_eps: float = 1e-6,
                window: Optional[int] = None) -> Tuple[torch.Tensor, dict]:
    """One-token decode: x (B,1,E), cache {'k','v': (B,Sc,KVH,D)}.

    The cache is circular: the new k/v go to slot ``position % Sc`` (for a
    window cache Sc == window and the modulo is the ring).  Returns the
    output and a new cache; the given cache is left as it was."""
    B = x.shape[0]
    positions = torch.full((B, 1), position, dtype=torch.int64,
                           device=x.device)
    q, k_new, v_new = project_qkv(p, x, cfg, positions, norm_eps,
                                  compute_dtype=x.dtype)
    Sc = cache["k"].shape[1]
    valid = cache_slot_validity(Sc, position, window, x.device)
    out = decode_attention(q, cache["k"], cache["v"], k_new, v_new,
                           cache_valid=valid)
    out = P.dense_apply(p["o"], out.reshape(B, 1, cfg.num_heads
                                            * cfg.head_dim), x.dtype)
    slot = position % Sc
    new_cache = {}
    for name, new in (("k", k_new), ("v", v_new)):
        c = cache[name].clone()
        c[:, slot:slot + 1] = new
        new_cache[name] = c
    return L.constrain(out, ("batch", "seq", "embed")), new_cache
