"""The model zoo's backbone.

Port of ``repro.models.transformer``: the layer pattern's repeating unit
(1 layer for dense, 2 for interleaved MoE, 3 for RecurrentGemma),
parameter init with the units stacked along a leading ``layers`` dim (as
``repro`` stacks them for its scan), the token embedding, the logits head
(tied or untied), sinusoidal positions, the encoder-decoder half
(whisper's ``encode`` and ``cross_attend``) and training: the chunked
cross-entropy (``xent_loss``), ``forward_train`` and ``loss_fn``.

Where ``repro`` scans the stacked units under ``jax.checkpoint``
(``cfg.remat == "full"``), the port loops over them and wraps each unit,
each encoder-decoder layer and each encoder layer in
``torch.utils.checkpoint``: their activations are recomputed in the
backward, so each kernel of the forward runs twice a training step.
The gradient flows through the kernels' own backwards
(``FlashAttentionFn``, ``WKVScanFn``, ``RGLRUScanFn``).

Under an active mesh the params and activations may be DTensors
(``repro_torch.sharding``); ``constrain`` sits at ``repro``'s places.
Two aten ops of ``xent_loss`` have no good DTensor strategy for a
sharded vocab: the ``gather`` of the gold logit fails, which
``_sharded_gold`` computes on each rank's vocab shard instead, and
``logsumexp`` moves the logits to a batch sharding (an all-to-all),
which ``_sharded_lse`` replaces by a max and a sum over the shards.
"""
from __future__ import annotations

import math
from typing import Any, Callable, Dict, Optional, Tuple

import numpy as np
import torch
from torch.distributed.tensor import DTensor
from torch.utils.checkpoint import checkpoint

from repro_torch import DeviceLike, resolve_device
from repro_torch.configs.base import (ATTN, LOCAL_ATTN, RECURRENT, RWKV,
                                      ModelConfig)
from repro_torch.kernels import ops
from repro_torch.models import attention as A
from repro_torch.models import params as P
from repro_torch.models import rglru as G
from repro_torch.models import rwkv6 as R
from repro_torch.models.mlp import mlp_apply, mlp_axes, mlp_init
from repro_torch.models.moe import moe_apply, moe_axes, moe_init
from repro_torch.sharding import logical as L

VOCAB_PAD = 256


def padded_vocab(cfg: ModelConfig) -> int:
    return ((cfg.vocab_size + VOCAB_PAD - 1) // VOCAB_PAD) * VOCAB_PAD


def divisor_block(S: int, target: int) -> int:
    """Largest block size <= target that divides S (chunked passes need
    exact tiling; e.g. whisper's encoder S=1500 -> 500)."""
    b = max(1, min(target, S))
    while S % b:
        b -= 1
    return b


# ---------------------------------------------------------------------------
# Pattern units
# ---------------------------------------------------------------------------
def unit_pattern(cfg: ModelConfig) -> Tuple[Tuple[str, bool], ...]:
    """The repeating unit as ((kind, use_moe), ...)."""
    pat = cfg.layer_pattern
    if cfg.moe.num_experts > 0:
        unit_len = cfg.moe.interleave
    elif cfg.recurrent.block_pattern:
        unit_len = len(cfg.recurrent.block_pattern)
    else:
        unit_len = 1
    unit_len = min(unit_len, cfg.num_layers)
    return tuple((pat[i], cfg.moe.num_experts > 0
                  and i % cfg.moe.interleave == 0) for i in range(unit_len))


def unit_counts(cfg: ModelConfig) -> Tuple[int, int]:
    """(num_stacked_units, num_tail_layers)."""
    u = len(unit_pattern(cfg))
    return cfg.num_layers // u, cfg.num_layers % u


# ---------------------------------------------------------------------------
# Init
# ---------------------------------------------------------------------------
def _dtype(cfg: ModelConfig) -> torch.dtype:
    """The params' dtype, ``cfg.param_dtype``."""
    return getattr(torch, cfg.param_dtype)


def _layer_init(generator: torch.Generator, cfg: ModelConfig, kind: str,
                use_moe: bool, device: DeviceLike,
                lead: Tuple[int, ...] = ()) -> P.Params:
    dt = _dtype(cfg)
    p = {"norm1": P.rmsnorm_init(cfg.d_model, device, lead, dt),
         "norm2": P.rmsnorm_init(cfg.d_model, device, lead, dt)}
    if kind == RWKV:        # time mix, and the channel mix as its MLP
        p["mix"] = R.timemix_init(generator, cfg, device, lead)
        p["mlp"] = R.channelmix_init(generator, cfg, device, lead)
        return p
    if kind in (ATTN, LOCAL_ATTN):
        p["mix"] = A.attn_init(generator, cfg.d_model, cfg.attention, device,
                               lead, dt)
    elif kind == RECURRENT:
        p["mix"] = G.rglru_init(generator, cfg, device, lead)
    else:
        raise ValueError(kind)
    if use_moe:
        p["mlp"] = moe_init(generator, cfg.d_model, cfg.d_ff, cfg.moe,
                            cfg.glu, device, lead, dt)
    else:
        p["mlp"] = mlp_init(generator, cfg.d_model, cfg.d_ff, cfg.glu,
                            device, lead, dt)
    return p


def _unit_init(generator: torch.Generator, cfg: ModelConfig,
               device: DeviceLike, lead: Tuple[int, ...] = ()) -> P.Params:
    return {f"l{i}": _layer_init(generator, cfg, kind, use_moe, device, lead)
            for i, (kind, use_moe) in enumerate(unit_pattern(cfg))}


def _encoder_layer_init(generator: torch.Generator, cfg: ModelConfig,
                        device: DeviceLike, lead: Tuple[int, ...] = ()
                        ) -> P.Params:
    """Whisper encoder layer: bidirectional self-attention + MLP."""
    dt = _dtype(cfg)
    return {"norm1": P.rmsnorm_init(cfg.d_model, device, lead, dt),
            "norm2": P.rmsnorm_init(cfg.d_model, device, lead, dt),
            "attn": A.attn_init(generator, cfg.d_model, cfg.attention,
                                device, lead, dt),
            "mlp": mlp_init(generator, cfg.d_model, cfg.d_ff, cfg.glu,
                            device, lead, dt)}


def _cross_layer_init(generator: torch.Generator, cfg: ModelConfig,
                      device: DeviceLike, lead: Tuple[int, ...] = ()
                      ) -> P.Params:
    """A decoder layer's cross-attention: its pre-norm and projections."""
    dt = _dtype(cfg)
    return {"norm": P.rmsnorm_init(cfg.d_model, device, lead, dt),
            "attn": A.attn_init(generator, cfg.d_model, cfg.attention,
                                device, lead, dt)}


def init_params(generator: torch.Generator, cfg: ModelConfig,
                device: DeviceLike = None) -> P.Params:
    """Random params with ``repro``'s tree, in ``cfg.param_dtype`` where
    ``repro`` puts it (every leaf but Qwen3's float32 qk-norm scales):
    ``embed``, ``units`` (each leaf stacked over the units; an MoE layer's
    experts over a second, ``experts`` dim), ``tail`` (the layers that do
    not fill a unit), ``final_norm``, ``head`` when untied, and for an
    encoder-decoder ``encoder`` (``layers`` stacked over the encoder
    layers, ``norm``) and ``cross`` (``layers`` stacked over the decoder
    layers).  Every leaf is drawn straight into its stacked shape, so the
    params are never held twice (37.6 GB for RecurrentGemma-9B in
    float32); a leaf of another dtype is drawn in float32 one (in, out)
    block at a time and cast into place (37.1 GB of bfloat16 for
    Maverick at depth 2, its float32 transient one block).  Drawn on
    ``generator``'s device: a generator on the card keeps the init on the
    card."""
    dev = resolve_device(device)
    dt = _dtype(cfg)
    n_units, n_tail = unit_counts(cfg)
    unit = unit_pattern(cfg)
    p: Dict[str, Any] = {
        "embed": P.embed_init(generator, padded_vocab(cfg), cfg.d_model, dev,
                              dt),
        "units": _unit_init(generator, cfg, dev, lead=(n_units,)),
    }
    if n_tail:
        p["tail"] = {f"l{i}": _layer_init(generator, cfg, *unit[i], dev)
                     for i in range(n_tail)}
    p["final_norm"] = P.rmsnorm_init(cfg.d_model, dev, dtype=dt)
    if not cfg.tie_embeddings:
        p["head"] = P.dense_init(generator, cfg.d_model, padded_vocab(cfg),
                                 device=dev, dtype=dt)
    if cfg.is_encdec:
        p["encoder"] = {
            "layers": _encoder_layer_init(generator, cfg, dev,
                                          lead=(cfg.num_encoder_layers,)),
            "norm": P.rmsnorm_init(cfg.d_model, dev, dtype=dt)}
        p["cross"] = {"layers": _cross_layer_init(
            generator, cfg, dev, lead=(cfg.num_layers,))}
    return p


def _layer_axes(cfg: ModelConfig, kind: str, use_moe: bool) -> P.Axes:
    a = {"norm1": P.rmsnorm_axes(), "norm2": P.rmsnorm_axes()}
    if kind == RWKV:
        a["mix"], a["mlp"] = R.timemix_axes(), R.channelmix_axes()
        return a
    a["mix"] = (A.attn_axes(cfg.attention) if kind in (ATTN, LOCAL_ATTN)
                else G.rglru_axes())
    a["mlp"] = (moe_axes(cfg.moe, cfg.glu) if use_moe
                else mlp_axes(cfg.glu))
    return a


def params_axes(cfg: ModelConfig) -> P.Axes:
    """The logical axes of :func:`init_params`' tree, leaf for leaf
    ``repro``'s ``init_params(...)[1]``: stacked leaves lead with
    ``layers`` (an MoE layer's experts then with ``experts``)."""
    n_units, n_tail = unit_counts(cfg)
    unit = unit_pattern(cfg)
    a: Dict[str, Any] = {
        "embed": P.embed_axes(),
        "units": P.add_axes({f"l{i}": _layer_axes(cfg, *u)
                             for i, u in enumerate(unit)}, "layers")}
    if n_tail:
        a["tail"] = {f"l{i}": _layer_axes(cfg, *unit[i])
                     for i in range(n_tail)}
    a["final_norm"] = P.rmsnorm_axes()
    if not cfg.tie_embeddings:
        a["head"] = P.dense_axes("embed", "vocab")
    if cfg.is_encdec:
        enc = {"norm1": P.rmsnorm_axes(), "norm2": P.rmsnorm_axes(),
               "attn": A.attn_axes(cfg.attention), "mlp": mlp_axes(cfg.glu)}
        cross = {"norm": P.rmsnorm_axes(),
                 "attn": A.attn_axes(cfg.attention)}
        a["encoder"] = {"layers": P.add_axes(enc, "layers"),
                        "norm": P.rmsnorm_axes()}
        a["cross"] = {"layers": P.add_axes(cross, "layers")}
    return a


# ---------------------------------------------------------------------------
# Embedding / positions / head
# ---------------------------------------------------------------------------
def embed_tokens(params: P.Params, cfg: ModelConfig, tokens: torch.Tensor
                 ) -> torch.Tensor:
    """tokens (B, S) -> (B, S, d) in the working dtype, scaled by
    sqrt(d) rounded to that dtype (as ``repro`` does).  The rows are
    gathered first and then cast, which gives the same values as casting
    the whole table (2.1 GB at full size) first."""
    dt = getattr(torch, cfg.dtype)
    table = params["embed"]["table"]
    x = (_sharded_rows(table, tokens) if isinstance(table, DTensor)
         else table[tokens]).to(dt)
    scale = torch.tensor(math.sqrt(cfg.d_model), dtype=dt).item()
    return L.constrain(x * scale, ("batch", "seq", "embed"))


def _sharded_rows(table, tokens: torch.Tensor) -> torch.Tensor:
    """A vocab-sharded DTensor table's rows of ``tokens``: each rank looks
    up the tokens of its own vocab shard (the others give zero rows), a
    Partial sum over the ranks that shard the vocab; the tokens keep their
    batch sharding.  (DTensor's ``index`` on a sharded table has no
    strategy on a 3-d mesh in torch 2.11.)"""
    info: dict = {}

    def fn(t, tok):
        v0, n = info["offsets"][0][0], t.shape[0]
        loc = tok.long() - v0
        mine = (loc >= 0) & (loc < n)
        return t[torch.where(mine, loc, 0)] * mine[..., None].to(t.dtype)

    return L.local_call(fn, (table, tokens), (("v", None), ("b", None)),
                        ("b", "v"), (("b", None, None),), info, sums=(True,))


def sinusoidal_positions(S: int, d: int, offset: int = 0,
                         device: DeviceLike = "cpu") -> torch.Tensor:
    """(S, d) float32 table of positions offset .. offset + S - 1: sin in
    the even columns, cos in the odd ones, computed in numpy float64 and
    rounded to float32, as ``repro`` builds it."""
    pos = np.arange(offset, offset + S)[:, None]
    div = np.exp(np.arange(0, d, 2) * (-np.log(10000.0) / d))
    pe = np.zeros((S, d), np.float32)
    pe[:, 0::2] = np.sin(pos * div)
    pe[:, 1::2] = np.cos(pos * div)
    return torch.from_numpy(pe).to(resolve_device(device))


def logits_fn(params: P.Params, cfg: ModelConfig, h: torch.Tensor
              ) -> torch.Tensor:
    """h: (..., d) -> (..., Vp), in h's dtype."""
    if cfg.tie_embeddings:
        return h @ params["embed"]["table"].to(h.dtype).T
    return P.dense_apply(params["head"], h, h.dtype)


# ---------------------------------------------------------------------------
# Encoder-decoder (whisper)
# ---------------------------------------------------------------------------
def cross_kv(p: P.Params, enc_out: torch.Tensor, cfg: ModelConfig,
             dtype: torch.dtype) -> Tuple[torch.Tensor, torch.Tensor]:
    """A cross-attention's keys and values from the encoder's output:
    (B, F, KVH, D) each, in ``dtype``."""
    B, F, _ = enc_out.shape
    a = cfg.attention
    return tuple(L.even_view(P.dense_apply(p[name], enc_out, dtype), -1,
                             a.num_kv_heads).reshape(
        B, F, a.num_kv_heads, a.head_dim) for name in ("k", "v"))


def cross_out(p: P.Params, h: torch.Tensor, k: torch.Tensor,
              v: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """Queries from h (B, S, d) against precomputed cross keys and values,
    every key visible, through ``ops.attention``; returns (B, S, d)."""
    B, S, _ = h.shape
    a = cfg.attention
    q = L.even_view(P.dense_apply(p["q"], h, h.dtype), -1,
                    a.num_heads).reshape(B, S, a.num_heads, a.head_dim)
    out = ops.attention(q, k, v, causal=False, window=None)
    out = L.merged_heads(out.reshape(B, S, a.num_heads * a.head_dim), -1,
                         a.num_heads)
    return P.dense_apply(p["o"], out, h.dtype)


def cross_attend(p: P.Params, h: torch.Tensor, enc_out: torch.Tensor,
                 cfg: ModelConfig) -> torch.Tensor:
    """Decoder cross-attention: queries from h, keys/values from
    enc_out."""
    return cross_out(p, h, *cross_kv(p, enc_out, cfg, h.dtype), cfg)


def take_layer(tree: P.Params, i: int) -> P.Params:
    """Layer (or unit) ``i`` of a stacked tree: views into the stacked
    leaves."""
    return P.tree_map_with_path(lambda _, w: w[i], tree)


def _remat(fn: Callable, on: bool) -> Callable:
    """``fn`` whose activations are recomputed in the backward where
    ``on`` (``jax.checkpoint``'s counterpart).  The forward draws no random
    numbers, so the RNG state is not stashed."""
    if not on:
        return fn
    return lambda *args: checkpoint(fn, *args, use_reentrant=False,
                                    preserve_rng_state=False)


def _encoder_layer(lp: P.Params, x: torch.Tensor, cfg: ModelConfig
                   ) -> torch.Tensor:
    h = P.rmsnorm_apply(lp["norm1"], x, cfg.norm_eps)
    x = x + A.attn_apply(lp["attn"], h, cfg.attention, cfg.norm_eps,
                         causal=False, window=None)
    h = P.rmsnorm_apply(lp["norm2"], x, cfg.norm_eps)
    return x + mlp_apply(lp["mlp"], h, cfg.act, cfg.glu)


def encode(params: P.Params, cfg: ModelConfig, frames: torch.Tensor,
           remat: bool = False) -> torch.Tensor:
    """Whisper encoder over stubbed frame embeddings (B, F, d): sinusoidal
    positions, then pre-norm layers of bidirectional self-attention (the
    attention kernel, every frame visible) and the MLP, then the encoder's
    norm.  In the working dtype; ``remat`` recomputes each layer in the
    backward."""
    dt = getattr(torch, cfg.dtype)
    x = frames.to(dt)
    x = x + sinusoidal_positions(x.shape[1], cfg.d_model,
                                 device=x.device).to(dt)[None]
    x = L.constrain(x, ("batch", "seq", "embed"))
    layer = _remat(_encoder_layer, remat)
    for i in range(cfg.num_encoder_layers):
        x = layer(take_layer(params["encoder"]["layers"], i), x, cfg)
    return P.rmsnorm_apply(params["encoder"]["norm"], x, cfg.norm_eps)


# ---------------------------------------------------------------------------
# Loss
# ---------------------------------------------------------------------------
def xent_loss(params: P.Params, cfg: ModelConfig, h: torch.Tensor,
              labels: torch.Tensor, mask: Optional[torch.Tensor] = None,
              chunk: int = 512) -> torch.Tensor:
    """Chunked softmax cross-entropy.  h: (B, S, d), labels: (B, S) int.

    Padded vocab entries are excluded via a -inf additive mask; the seq
    dim is processed in chunks of ``divisor_block(S, chunk)`` so a chunk's
    logits are (B, chunk, Vp); logsumexp in float32; the mean over the
    mask's mass, at least 1."""
    B, S, _ = h.shape
    Vp = padded_vocab(cfg)
    chunk = divisor_block(S, chunk)
    f32 = torch.float32
    pad_mask = torch.where(torch.arange(Vp, device=h.device)
                           < cfg.vocab_size, 0.0, A.NEG_INF).to(f32)
    if mask is None:
        mask = torch.ones((B, S), dtype=f32, device=h.device)
    tot = torch.zeros((), dtype=f32, device=h.device)
    cnt = torch.zeros((), dtype=f32, device=h.device)
    for c0 in range(0, S, chunk):
        mc = mask[:, c0:c0 + chunk]
        logits = logits_fn(params, cfg, h[:, c0:c0 + chunk]).to(f32) + pad_mask
        logits = L.constrain(logits, ("batch", "seq", "vocab"))
        lc = labels[:, c0:c0 + chunk, None].long()
        if isinstance(logits, DTensor):
            lse, gold = _sharded_lse(logits), _sharded_gold(logits, lc)
        else:
            lse = torch.logsumexp(logits, dim=-1)
            gold = torch.gather(logits, -1, lc)[..., 0]
        tot = tot + torch.sum((lse - gold) * mc)
        cnt = cnt + torch.sum(mc)
    return tot / torch.clamp_min(cnt, 1.0)


def _sharded_lse(logits) -> torch.Tensor:
    """logsumexp over a DTensor's last dim as max, exp-sum, log: a max
    and a sum over the vocab shards (DTensor's own logsumexp moves the
    whole logits to a batch sharding first, an all-to-all)."""
    m = torch.amax(logits.detach(), dim=-1, keepdim=True)
    return torch.log(torch.sum(torch.exp(logits - m), dim=-1)) + m[..., 0]


def _sharded_gold(logits, lc: torch.Tensor) -> torch.Tensor:
    """The gold logits of a DTensor's vocab shards: each rank's one-hot sum
    over its own columns (exact: at most one term is not zero), a
    ``Partial`` sum over the ranks that shard the vocab.  DTensor's own
    ``gather`` over a vocab-sharded dim fails (its mask buffer indexes a
    3-d shard as 2-d)."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    from torch.distributed.tensor._utils import \
        compute_local_shape_and_global_offset
    mesh, pl = logits.device_mesh, list(logits.placements)
    v = logits.dim() - 1
    if isinstance(lc, DTensor):
        lc = lc.redistribute(mesh, [Replicate() if isinstance(p, Shard)
                                    and p.dim == v else p for p in pl])
    else:
        lc = DTensor.from_local(lc, mesh, [Replicate()] * mesh.ndim,
                                run_check=False).redistribute(
            mesh, [Replicate() if isinstance(p, Shard) and p.dim == v else p
                   for p in pl])
    (vloc,), (v0,) = (x[v:] for x in compute_local_shape_and_global_offset(
        tuple(logits.shape), mesh, pl))
    loc = logits.to_local()
    cols = torch.arange(v0, v0 + vloc, device=loc.device)
    gold = torch.sum(torch.where(lc.to_local() == cols, loc, 0.0), dim=-1)
    return DTensor.from_local(gold, mesh, [
        Partial() if isinstance(p, Shard) and p.dim == v else p
        for p in pl], run_check=False)


# ---------------------------------------------------------------------------
# Layer application (training)
# ---------------------------------------------------------------------------
def _mix_train(p: P.Params, h: torch.Tensor, cfg: ModelConfig, kind: str
               ) -> torch.Tensor:
    a = cfg.attention
    if kind == ATTN:
        return A.attn_apply(p, h, a, cfg.norm_eps, window=a.sliding_window)
    if kind == LOCAL_ATTN:
        return A.attn_apply(p, h, a, cfg.norm_eps,
                            window=a.sliding_window or a.long_context_window)
    if kind == RECURRENT:
        return G.rglru_apply(p, h, cfg)[0]
    if kind == RWKV:
        return R.timemix_apply(p, h, cfg)[0]
    raise ValueError(kind)


def _apply_layer_train(p: P.Params, x: torch.Tensor, cfg: ModelConfig,
                       kind: str, use_moe: bool, sums: bool = False
                       ) -> Tuple[torch.Tensor, torch.Tensor,
                                  Tuple[torch.Tensor, ...]]:
    """Returns (x, moe_aux_loss, moe_sums): the MoE layer's aux is
    ``router_aux_loss_coef * lb_loss + 1e-3 * z_loss``; with ``sums``
    ``moe_sums`` holds its ``moe_apply`` row sums, else it is empty."""
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    rows: Tuple[torch.Tensor, ...] = ()
    h = P.rmsnorm_apply(p["norm1"], x, cfg.norm_eps)
    x = x + _mix_train(p["mix"], h, cfg, kind)
    h = P.rmsnorm_apply(p["norm2"], x, cfg.norm_eps)
    if kind == RWKV:
        h, _ = R.channelmix_apply(p["mlp"], h)
    elif use_moe:
        h, moe_aux = moe_apply(p["mlp"], h, cfg.moe, cfg.act, cfg.glu,
                               sums=sums)
        aux = (aux + cfg.moe.router_aux_loss_coef * moe_aux["lb_loss"]
               + 1e-3 * moe_aux["z_loss"])
        if sums:
            rows = (moe_aux["sums"],)
    else:
        h = mlp_apply(p["mlp"], h, cfg.act, cfg.glu)
    return x + h, aux, rows


def _apply_unit_train(unit_p: P.Params, x: torch.Tensor, cfg: ModelConfig,
                      sums: bool = False
                      ) -> Tuple[torch.Tensor, torch.Tensor,
                                 Tuple[torch.Tensor, ...]]:
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    rows: Tuple[torch.Tensor, ...] = ()
    for i, (kind, use_moe) in enumerate(unit_pattern(cfg)):
        x, a, r = _apply_layer_train(unit_p[f"l{i}"], x, cfg, kind, use_moe,
                                     sums)
        aux = aux + a
        rows += r
    return x, aux, rows


def _encdec_layer_train(up: P.Params, cp: P.Params, x: torch.Tensor,
                        enc_out: torch.Tensor, cfg: ModelConfig
                        ) -> torch.Tensor:
    """A decoder layer of an encoder-decoder: causal self-attention,
    cross-attention to the encoder's output, then the MLP, each
    pre-norm."""
    h = P.rmsnorm_apply(up["l0"]["norm1"], x, cfg.norm_eps)
    x = x + _mix_train(up["l0"]["mix"], h, cfg, ATTN)
    h = P.rmsnorm_apply(cp["norm"], x, cfg.norm_eps)
    x = x + cross_attend(cp["attn"], h, enc_out, cfg)
    h = P.rmsnorm_apply(up["l0"]["norm2"], x, cfg.norm_eps)
    return x + mlp_apply(up["l0"]["mlp"], h, cfg.act, cfg.glu)


# ---------------------------------------------------------------------------
# Forward: train
# ---------------------------------------------------------------------------
def forward_train(params: P.Params, cfg: ModelConfig, batch: Dict[str, Any]
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns (hidden (B, S, d), moe_aux scalar).

    batch: tokens (B, S_text); optional 'prefix' (B, P, d) early-fusion
    embeddings (vlm); optional 'frames' (B, F, d) encoder stub input
    (audio)."""
    h, aux, _ = _forward_train(params, cfg, batch, False)
    return h, aux


def _forward_train(params: P.Params, cfg: ModelConfig, batch: Dict[str, Any],
                   sums: bool) -> Tuple[torch.Tensor, torch.Tensor,
                                        Tuple[torch.Tensor, ...]]:
    """:func:`forward_train`, and with ``sums`` each MoE layer's
    ``moe_apply`` row sums in layer order."""
    remat = cfg.remat == "full"
    x = embed_tokens(params, cfg, batch["tokens"])
    if cfg.frontend.kind == "vision" and "prefix" in batch:
        x = torch.cat([batch["prefix"].to(x.dtype), x], dim=1)
        x = L.constrain(x, ("batch", "seq", "embed"))
    if cfg.attention.rope_theta == 0:
        x = x + sinusoidal_positions(x.shape[1], cfg.d_model,
                                     device=x.device).to(x.dtype)[None]
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    rows: Tuple[torch.Tensor, ...] = ()
    n_units, n_tail = unit_counts(cfg)
    if cfg.is_encdec:
        enc_out = encode(params, cfg, batch["frames"], remat=remat)
        layer = _remat(_encdec_layer_train, remat)
        for u in range(n_units):
            x = layer(take_layer(params["units"], u),
                      take_layer(params["cross"]["layers"], u), x, enc_out,
                      cfg)
    else:
        unit_fn = _remat(_apply_unit_train, remat)
        for u in range(n_units):
            x, a, r = unit_fn(take_layer(params["units"], u), x, cfg, sums)
            aux = aux + a
            rows += r
        unit = unit_pattern(cfg)
        for i in range(n_tail):
            x, a, r = _apply_layer_train(params["tail"][f"l{i}"], x, cfg,
                                         *unit[i], sums)
            aux = aux + a
            rows += r
    return P.rmsnorm_apply(params["final_norm"], x, cfg.norm_eps), aux, rows


def loss_fn(params: P.Params, cfg: ModelConfig, batch: Dict[str, Any],
            moe_sums: bool = False
            ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """(xent + moe_aux, {"xent", "moe_aux"}); with a vision prefix the
    loss covers the text positions only.  With ``moe_sums`` (an MoE
    config) the dict also holds ``"moe_sums"`` (MoE layers, chunks, 2 E +
    2): each layer's ``moe_apply`` row sums, from which a multi-rank step
    forms the aux loss of a batch spread over ranks."""
    h, aux, rows = _forward_train(params, cfg, batch, moe_sums)
    if cfg.frontend.kind == "vision" and "prefix" in batch:
        h = h[:, batch["prefix"].shape[1]:, :]
    loss = xent_loss(params, cfg, h, batch["labels"], batch.get("mask"))
    mets = {"xent": loss, "moe_aux": aux}
    if rows:
        mets["moe_sums"] = torch.stack(rows)
    return loss + aux, mets
