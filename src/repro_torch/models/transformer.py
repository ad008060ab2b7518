"""The model zoo's decoder backbone, as far as serving needs it.

Port of the serving half of ``repro.models.transformer``: the layer
pattern's repeating unit, parameter init with the units stacked along a
leading ``layers`` dim (as ``repro`` stacks them for its scan), the
token embedding and the logits head (tied or untied).  Decoder-only
configs without MoE or a frontend; the others raise
``NotImplementedError`` (ROADMAP.md, queue 1).  Training
(``forward_train``, ``xent_loss``) is a later slice.
"""
from __future__ import annotations

import math
from typing import Any, Dict, Tuple

import torch

from repro_torch import DeviceLike, resolve_device
from repro_torch.configs.base import (ATTN, LOCAL_ATTN, RECURRENT, RWKV,
                                      ModelConfig)
from repro_torch.models import attention as A
from repro_torch.models import params as P
from repro_torch.models import rglru as G
from repro_torch.models import rwkv6 as R
from repro_torch.models.mlp import mlp_init

VOCAB_PAD = 256


def padded_vocab(cfg: ModelConfig) -> int:
    return ((cfg.vocab_size + VOCAB_PAD - 1) // VOCAB_PAD) * VOCAB_PAD


def check_servable(cfg: ModelConfig) -> None:
    """Raise ``NotImplementedError`` for what the port does not serve."""
    missing = []
    if cfg.moe.num_experts > 0:
        missing.append("MoE")
    if cfg.is_encdec:
        missing.append("encoder-decoder")
    if cfg.frontend.kind != "none":
        missing.append("a modality frontend")
    if cfg.attention.rope_theta <= 0:
        missing.append("sinusoidal positions")
    if missing:
        raise NotImplementedError(
            f"{cfg.name}: {', '.join(missing)} not ported yet "
            f"(ROADMAP.md, queue 1)")


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
def _layer_init(generator: torch.Generator, cfg: ModelConfig, kind: str,
                device: DeviceLike, lead: Tuple[int, ...] = ()) -> P.Params:
    p = {"norm1": P.rmsnorm_init(cfg.d_model, device, lead),
         "norm2": P.rmsnorm_init(cfg.d_model, device, lead)}
    if kind == RWKV:        # time mix, and the channel mix as its MLP
        p["mix"] = R.timemix_init(generator, cfg, device, lead)
        p["mlp"] = R.channelmix_init(generator, cfg, device, lead)
        return p
    if kind in (ATTN, LOCAL_ATTN):
        p["mix"] = A.attn_init(generator, cfg.d_model, cfg.attention, device,
                               lead)
    elif kind == RECURRENT:
        p["mix"] = G.rglru_init(generator, cfg, device, lead)
    else:
        raise ValueError(kind)
    p["mlp"] = mlp_init(generator, cfg.d_model, cfg.d_ff, cfg.glu, device,
                        lead)
    return p


def _unit_init(generator: torch.Generator, cfg: ModelConfig,
               device: DeviceLike, lead: Tuple[int, ...] = ()) -> P.Params:
    return {f"l{i}": _layer_init(generator, cfg, kind, device, lead)
            for i, (kind, _) in enumerate(unit_pattern(cfg))}


def init_params(generator: torch.Generator, cfg: ModelConfig,
                device: DeviceLike = None) -> P.Params:
    """Random float32 params with ``repro``'s tree: ``embed``, ``units``
    (each leaf stacked over the units), ``tail`` (the layers that do not
    fill a unit), ``final_norm``, and ``head`` when untied.  Every leaf is
    drawn straight into its stacked shape, so the params are never held
    twice (37.6 GB for RecurrentGemma-9B).  Drawn on ``generator``'s
    device: a generator on the card keeps the init on the card."""
    check_servable(cfg)
    dev = resolve_device(device)
    n_units, n_tail = unit_counts(cfg)
    unit = unit_pattern(cfg)
    p: Dict[str, Any] = {
        "embed": P.embed_init(generator, padded_vocab(cfg), cfg.d_model, dev),
        "units": _unit_init(generator, cfg, dev, lead=(n_units,)),
    }
    if n_tail:
        p["tail"] = {f"l{i}": _layer_init(generator, cfg, unit[i][0], dev)
                     for i in range(n_tail)}
    p["final_norm"] = P.rmsnorm_init(cfg.d_model, dev)
    if not cfg.tie_embeddings:
        p["head"] = P.dense_init(generator, cfg.d_model, padded_vocab(cfg),
                                 device=dev)
    return p


# ---------------------------------------------------------------------------
# Embedding / head
# ---------------------------------------------------------------------------
def embed_tokens(params: P.Params, cfg: ModelConfig, tokens: torch.Tensor
                 ) -> torch.Tensor:
    """tokens (B, S) -> (B, S, d) in the working dtype, scaled by
    sqrt(d) rounded to that dtype (as ``repro`` does).  The rows are
    gathered first and then cast, which gives the same values as casting
    the whole table (2.1 GB at full size) first."""
    dt = getattr(torch, cfg.dtype)
    x = params["embed"]["table"][tokens].to(dt)
    scale = torch.tensor(math.sqrt(cfg.d_model), dtype=dt).item()
    return x * scale


def logits_fn(params: P.Params, cfg: ModelConfig, h: torch.Tensor
              ) -> torch.Tensor:
    """h: (..., d) -> (..., Vp), in h's dtype."""
    if cfg.tie_embeddings:
        return h @ params["embed"]["table"].to(h.dtype).T
    return P.dense_apply(params["head"], h, h.dtype)
