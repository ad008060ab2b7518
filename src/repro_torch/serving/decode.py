"""Serving: KV / recurrent-state caches, prefill, and one-token decode.

Port of ``repro.serving.decode`` for every family of the zoo: dense and
MoE decoders, RWKV6, RecurrentGemma, whisper's encoder-decoder and
InternVL2's vision prefix.  Where ``repro`` scans over the stacked units,
the port loops over them in Python and then over the tail layers; the
cache has ``repro``'s tree (``cache_shape``), its ``units`` leaves
stacked over the units and, for an encoder-decoder, a ``cross`` entry of
each decoder layer's cross-attention keys and values over the encoder's
output.

On the card a prefill launches the flash-attention kernel once per
attention layer (and for an encoder-decoder once per encoder layer and
once per cross-attention), the RG-LRU scan kernel once per recurrent
layer and the WKV kernel once per RWKV6 layer; a decode step launches the
WKV kernel once per RWKV6 layer and no other.  Positions are host ints,
so a decode step never waits on the card.  A vision prefix's patches
come before the prompt and take its first positions: decode positions
and ``pad_cache``'s ``prompt_len`` count them.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch

from repro_torch import DeviceLike, resolve_device
from repro_torch.configs.base import (ATTN, LOCAL_ATTN, ModelConfig,
                                      RECURRENT, RWKV)
from repro_torch.kernels import ops
from repro_torch.models import attention as A
from repro_torch.models import params as P
from repro_torch.models import rglru as G
from repro_torch.models import rwkv6 as R
from repro_torch.models.mlp import mlp_apply
from repro_torch.models.moe import moe_apply
from repro_torch.sharding import logical as L
from repro_torch.models.transformer import (cross_kv, cross_out,
                                            embed_tokens, encode, logits_fn,
                                            sinusoidal_positions, take_layer,
                                            unit_counts, unit_pattern)

Tree = Dict[str, Any]


def _stack(trees) -> Tree:
    """Stack per-unit trees along a new leading dim."""
    leaves = [dict(P.tree_items(t)) for t in trees]
    return P.tree_map_with_path(
        lambda path, _: torch.stack([lv[path] for lv in leaves]), trees[0])


# ---------------------------------------------------------------------------
# Cache construction
# ---------------------------------------------------------------------------
def layer_cache_shape(cfg: ModelConfig, kind: str, batch: int, seq_len: int,
                      long_context: bool = False) -> Dict[str, torch.Tensor]:
    """One layer's cache entry as ``meta`` tensors (shape and dtype, no
    storage): the port's counterpart of ``repro``'s ShapeDtypeStructs."""
    a = cfg.attention
    dt = getattr(torch, cfg.dtype)
    if kind in (ATTN, LOCAL_ATTN):
        if kind == LOCAL_ATTN and a.sliding_window:
            Sc = min(seq_len, a.sliding_window)
        elif long_context:
            Sc = min(seq_len, a.long_context_window)
        else:
            Sc = seq_len
        shape = (batch, Sc, a.num_kv_heads, a.head_dim)
        return {"k": torch.empty(shape, dtype=dt, device="meta"),
                "v": torch.empty(shape, dtype=dt, device="meta")}
    if kind == RECURRENT:
        W = cfg.recurrent.lru_width or cfg.d_model
        cw = cfg.recurrent.conv1d_width
        return {"h": torch.empty((batch, W), dtype=torch.float32,
                                 device="meta"),
                "conv": torch.empty((batch, cw - 1, W), dtype=dt,
                                    device="meta")}
    if kind == RWKV:
        H, N = cfg.recurrent.num_heads, cfg.recurrent.head_size
        return {"shift_tm": torch.empty((batch, cfg.d_model), dtype=dt,
                                        device="meta"),
                "wkv": torch.empty((batch, H, N, N), dtype=torch.float32,
                                   device="meta"),
                "shift_cm": torch.empty((batch, cfg.d_model), dtype=dt,
                                        device="meta")}
    raise ValueError(kind)


def cache_shape(cfg: ModelConfig, batch: int, seq_len: int,
                long_context: bool = False) -> Tree:
    """Full-model cache tree of ``meta`` tensors (stacked over units); an
    encoder-decoder's ``cross`` k / v are (L, B, encoder_seq, KVH, D) in
    the working dtype."""
    unit = unit_pattern(cfg)
    n_units, n_tail = unit_counts(cfg)
    per_unit = {f"l{i}": layer_cache_shape(cfg, kind, batch, seq_len,
                                           long_context)
                for i, (kind, _) in enumerate(unit)}
    cache: Tree = {"units": P.tree_map_with_path(
        lambda _, s: s.new_empty((n_units, *s.shape)), per_unit)}
    if n_tail:
        cache["tail"] = {f"l{i}": layer_cache_shape(cfg, unit[i][0], batch,
                                                    seq_len, long_context)
                         for i in range(n_tail)}
    if cfg.is_encdec:
        a = cfg.attention
        shape = (cfg.num_layers, batch, cfg.encoder_seq, a.num_kv_heads,
                 a.head_dim)
        cache["cross"] = {
            name: torch.empty(shape, dtype=getattr(torch, cfg.dtype),
                              device="meta") for name in ("k", "v")}
    return cache


def cache_logical_axes(tree: Tree) -> Tree:
    """Logical sharding axes for a cache tree built by :func:`cache_shape`
    (``repro``'s, leaf for leaf)."""
    def leaf_axes(path, s):
        nd = s.dim()
        if path[-1] in ("k", "v"):
            base = ("batch", "cache_seq", "kv_heads", None)
            if path[0] in ("cross", "units"):
                return ("layers",) + base if nd == 5 else base
            return base
        stacked = {"wkv": (("batch", "heads", None, None), 5),
                   "h": (("batch", "state"), 3),
                   "conv": (("batch", None, "state"), 4),
                   "shift_tm": (("batch", "embed"), 3),
                   "shift_cm": (("batch", "embed"), 3)}
        if path[-1] in stacked:
            base, full = stacked[path[-1]]
            return ("layers",) + base if nd == full else base
        return (None,) * nd

    return P.tree_map_with_path(leaf_axes, tree)


def init_cache(cfg: ModelConfig, batch: int, seq_len: int,
               long_context: bool = False, device: DeviceLike = None) -> Tree:
    """Zero-initialised concrete cache on ``device``."""
    dev = resolve_device(device)
    return P.tree_map_with_path(
        lambda _, s: torch.zeros(s.shape, dtype=s.dtype, device=dev),
        cache_shape(cfg, batch, seq_len, long_context))


def pad_cache(cache: Tree, cfg: ModelConfig, prompt_len: int,
              target_len: int) -> Tree:
    """Extend a prefill-produced cache so decode can run past the prompt.

    Attention k/v entries are padded with zero slots up to ``target_len``
    (windowed layers stay at their window size) and rolled so the ring
    invariant (slot i holds position = i (mod Sc)) is restored; the padded
    slots are excluded by :func:`~repro_torch.models.attention.
    cache_slot_validity` until they are written.  Recurrent and RWKV6
    entries are O(1) state, and an encoder-decoder's cross k / v are fixed
    by its frames: untouched."""
    a = cfg.attention
    unit = unit_pattern(cfg)

    def leaf(path, x):
        if path[-1] not in ("k", "v") or path[0] == "cross":
            return x
        li = int(path[1][1:]) if path[1].startswith("l") else 0
        kind = unit[li % len(unit)][0]
        cap = (a.sliding_window
               if (kind == LOCAL_ATTN and a.sliding_window) else None)
        tgt = min(target_len, cap) if cap else target_len
        axis = x.dim() - 3                      # the cache_seq dim
        Sc = x.shape[axis]
        if Sc >= tgt:
            # already at (or beyond) target; restore ring alignment if the
            # prefill truncated to a window (slot j held prompt_len-Sc+j)
            if prompt_len > Sc:
                return torch.roll(x, prompt_len % Sc, dims=axis)
            return x
        shape = list(x.shape)
        shape[axis] = tgt - Sc
        return torch.cat([x, x.new_zeros(shape)], dim=axis)

    return P.tree_map_with_path(leaf, cache)


# ---------------------------------------------------------------------------
# Layers: one function each for a prompt (no cache entry) and a decode step
# ---------------------------------------------------------------------------
def _decode_window(cfg: ModelConfig, entry: Tree) -> Optional[int]:
    """Effective attention window for a decode cache entry: the ring size
    Sc when the cache was sized BY a window (sliding_window or the
    long-context variant), else None (all valid slots)."""
    a = cfg.attention
    Sc = entry["k"].shape[1]
    if a.sliding_window and Sc == a.sliding_window:
        return a.sliding_window
    if Sc == a.long_context_window:
        return a.long_context_window
    return None


def _attn_prefill(p: P.Params, h: torch.Tensor, cfg: ModelConfig, kind: str
                  ) -> Tuple[torch.Tensor, Tree]:
    a = cfg.attention
    B, S, _ = h.shape
    q, k, v = A.project_qkv(p, h, a, torch.arange(S, device=h.device),
                            cfg.norm_eps, compute_dtype=h.dtype)
    out = ops.attention(q, k, v, causal=True, window=a.sliding_window)
    out = P.dense_apply(p["o"], out.reshape(B, S, a.num_heads * a.head_dim),
                        h.dtype)
    if kind == LOCAL_ATTN and a.sliding_window and S > a.sliding_window:
        k, v = k[:, -a.sliding_window:], v[:, -a.sliding_window:]
    return L.constrain(out, ("batch", "seq", "embed")), {"k": k, "v": v}


def _mix(p: P.Params, h: torch.Tensor, cfg: ModelConfig, kind: str,
         entry: Optional[Tree], position: Optional[int]
         ) -> Tuple[torch.Tensor, Tree]:
    """The layer's token mix over a prompt (``entry`` None) or one decode
    step from its cache entry; returns (out, new entry)."""
    if kind in (ATTN, LOCAL_ATTN):
        if entry is None:
            return _attn_prefill(p, h, cfg, kind)
        return A.attn_decode(p, h, entry, cfg.attention, position,
                             cfg.norm_eps, window=_decode_window(cfg, entry))
    if kind == RECURRENT:
        if entry is None:
            return G.rglru_apply(p, h, cfg)
        return G.rglru_decode(p, h, cfg, entry)
    if kind == RWKV:
        h, st = R.timemix_apply(p, h, cfg, state=None if entry is None else {
            "shift": entry["shift_tm"], "wkv": entry["wkv"]})
        return h, {"shift_tm": st["shift"], "wkv": st["wkv"]}
    raise ValueError(kind)


def _apply_layer(p: P.Params, x: torch.Tensor, cfg: ModelConfig, kind: str,
                 use_moe: bool, entry: Optional[Tree],
                 position: Optional[int]) -> Tuple[torch.Tensor, Tree]:
    """One pre-norm layer, x + mix(norm1(x)), then x + mlp(norm2(x)), over
    a prompt (``entry`` None) or one decode step.  An RWKV6 layer's MLP is
    its channel mix, whose token shift the cache entry carries; an MoE
    layer's is ``moe_apply`` in chunks of 512 tokens over a prompt and of
    one in a decode step."""
    h = P.rmsnorm_apply(p["norm1"], x, cfg.norm_eps)
    h, new_entry = _mix(p["mix"], h, cfg, kind, entry, position)
    x = x + h
    h = P.rmsnorm_apply(p["norm2"], x, cfg.norm_eps)
    if kind == RWKV:
        h, new_entry["shift_cm"] = R.channelmix_apply(
            p["mlp"], h, state=None if entry is None else entry["shift_cm"])
    elif use_moe:
        h, _ = moe_apply(p["mlp"], h, cfg.moe, cfg.act, cfg.glu,
                         chunk=512 if entry is None else 1)
    else:
        h = mlp_apply(p["mlp"], h, cfg.act, cfg.glu)
    return x + h, new_entry


def _run_layers(params: P.Params, cfg: ModelConfig, x: torch.Tensor,
                cache: Optional[Tree] = None, position: Optional[int] = None
                ) -> Tuple[torch.Tensor, Tree]:
    """Apply the stacked units in order, then the tail layers, each layer
    with its slice of ``cache`` (None in prefill).  Returns x and the new
    cache tree."""
    unit = unit_pattern(cfg)
    n_units, n_tail = unit_counts(cfg)
    per_unit = []
    for u in range(n_units):
        up = take_layer(params["units"], u)
        uc = None if cache is None else take_layer(cache["units"], u)
        entries = {}
        for i, (kind, use_moe) in enumerate(unit):
            x, entries[f"l{i}"] = _apply_layer(
                up[f"l{i}"], x, cfg, kind, use_moe,
                None if uc is None else uc[f"l{i}"], position)
        per_unit.append(entries)
    new_cache: Tree = {"units": _stack(per_unit)}
    if n_tail:
        new_cache["tail"] = {}
        for i in range(n_tail):
            name = f"l{i}"
            x, new_cache["tail"][name] = _apply_layer(
                params["tail"][name], x, cfg, *unit[i],
                None if cache is None else cache["tail"][name], position)
    return x, new_cache


# ---------------------------------------------------------------------------
# Encoder-decoder (whisper)
# ---------------------------------------------------------------------------
def _sinusoidal_at(position: int, d: int, device: DeviceLike = "cpu"
                   ) -> torch.Tensor:
    """(d,) float32 sinusoidal row of the host int ``position``, in
    float32 arithmetic on ``device`` (``repro``'s decode row; the prefill
    table is float64 rounded, :func:`~repro_torch.models.transformer.
    sinusoidal_positions`)."""
    half = torch.arange(0, d, 2, dtype=torch.float32, device=device)
    # -log(10000) / d rounded to float32, as a host scalar: no sync
    rate = float(-torch.log(torch.tensor(10000.0, dtype=torch.float32)) / d)
    ang = torch.exp(half * rate) * float(position)
    return torch.stack([torch.sin(ang), torch.cos(ang)], dim=-1).reshape(d)


def _cross_decode(p: P.Params, x: torch.Tensor, xk: torch.Tensor,
                  xv: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """x + cross-attention of one decode step (x (B, 1, d)) against the
    cached cross keys and values (B, F, KVH, D): float32 scores and
    softmax over every frame, probabilities rounded to the cache's
    dtype."""
    a = cfg.attention
    B = x.shape[0]
    f32 = torch.float32
    h = P.rmsnorm_apply(p["norm"], x, cfg.norm_eps)
    q = P.dense_apply(p["attn"]["q"], h, h.dtype)
    KVH = xk.shape[2]
    qg = L.even_view(q, -1, KVH).reshape(
        B, KVH, a.num_heads // KVH, a.head_dim).to(f32)
    s = torch.einsum("bhgd,bkhd->bhgk", qg, xk.to(f32)) / (a.head_dim ** 0.5)
    pr = torch.softmax(s, dim=-1)
    o = torch.einsum("bhgk,bkhd->bhgd", pr.to(xv.dtype).to(f32), xv.to(f32))
    o = o.reshape(B, 1, a.num_heads * a.head_dim).to(x.dtype)
    return x + P.dense_apply(p["attn"]["o"], o, x.dtype)


def _run_encdec(params: P.Params, cfg: ModelConfig, x: torch.Tensor,
                cache: Optional[Tree] = None, position: Optional[int] = None,
                enc_out: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, Tree]:
    """The decoder of an encoder-decoder: each layer self-attention
    (causal), cross-attention, then the MLP, each pre-norm.  Over a prompt
    (``cache`` None) it computes each layer's cross keys and values from
    ``enc_out`` once, for its cross-attention and for the cache; a decode
    step reads them from ``cache["cross"]``, which it passes on."""
    entries, xks, xvs = [], [], []
    for u in range(cfg.num_layers):
        up = take_layer(params["units"], u)["l0"]
        cp = take_layer(params["cross"]["layers"], u)
        h = P.rmsnorm_apply(up["norm1"], x, cfg.norm_eps)
        if cache is None:
            h, entry = _attn_prefill(up["mix"], h, cfg, ATTN)
        else:
            h, entry = A.attn_decode(up["mix"], h,
                                     take_layer(cache["units"], u)["l0"],
                                     cfg.attention, position, cfg.norm_eps)
        x = x + h
        if cache is None:
            xk, xv = cross_kv(cp["attn"], enc_out, cfg, x.dtype)
            xks.append(xk)
            xvs.append(xv)
            h = P.rmsnorm_apply(cp["norm"], x, cfg.norm_eps)
            x = x + cross_out(cp["attn"], h, xk, xv, cfg)
        else:
            x = _cross_decode(cp, x, cache["cross"]["k"][u],
                              cache["cross"]["v"][u], cfg)
        h = P.rmsnorm_apply(up["norm2"], x, cfg.norm_eps)
        x = x + mlp_apply(up["mlp"], h, cfg.act, cfg.glu)
        entries.append({"l0": entry})
    cross = (cache["cross"] if cache is not None
             else {"k": torch.stack(xks), "v": torch.stack(xvs)})
    return x, {"cross": cross, "units": _stack(entries)}


# ---------------------------------------------------------------------------
# Entry points
# ---------------------------------------------------------------------------
def decode_step(params: P.Params, cfg: ModelConfig, tokens: torch.Tensor,
                cache: Tree, position: int) -> Tuple[torch.Tensor, Tree]:
    """tokens: (B, 1) int64 on the params' device; position: the host int
    position of that token (a vision prefix's patches count).  Returns
    (logits (B, Vp), new cache); the given cache is left as it was."""
    x = embed_tokens(params, cfg, tokens)
    if cfg.attention.rope_theta == 0:
        x = x + _sinusoidal_at(position, cfg.d_model,
                               x.device).to(x.dtype)[None, None]
    if cfg.is_encdec:
        x, new_cache = _run_encdec(params, cfg, x, cache, position)
    else:
        x, new_cache = _run_layers(params, cfg, x, cache, position)
    x = P.rmsnorm_apply(params["final_norm"], x, cfg.norm_eps)
    return (L.constrain(logits_fn(params, cfg, x[:, 0, :]), ("batch", "vocab")),
            new_cache)


def prefill(params: P.Params, cfg: ModelConfig, batch: Dict[str, Any]
            ) -> Tuple[torch.Tensor, Tree]:
    """batch: {'tokens': (B, S) int64 on the params' device}, with
    'frames' (B, F, d) for an encoder-decoder and 'prefix' (B, P, d) for a
    vision frontend.  Process a prompt and build the cache: returns
    (last-token logits (B, Vp), cache)."""
    x = embed_tokens(params, cfg, batch["tokens"])
    if cfg.frontend.kind == "vision" and "prefix" in batch:
        x = torch.cat([batch["prefix"].to(x.dtype), x], dim=1)
    if cfg.attention.rope_theta == 0:
        x = x + sinusoidal_positions(x.shape[1], cfg.d_model,
                                     device=x.device).to(x.dtype)[None]
    if cfg.is_encdec:
        x, cache = _run_encdec(params, cfg, x,
                               enc_out=encode(params, cfg, batch["frames"]))
    else:
        x, cache = _run_layers(params, cfg, x)
    x = P.rmsnorm_apply(params["final_norm"], x, cfg.norm_eps)
    return (L.constrain(logits_fn(params, cfg, x[:, -1, :]),
                        ("batch", "vocab")), cache)
