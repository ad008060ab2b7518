"""Analytic FLOPs / HBM-bytes / collective-bytes model per (arch x shape).

Port of ``repro.analysis.costmodel``: host arithmetic that gives
``repro``'s numbers exactly, field by field of :class:`CostBreakdown`.
It is the standard napkin math over the workload.  The dry-run
(:mod:`repro_torch.launch.dryrun`) reports it as each record's
``roofline`` block, beside the counts its dispatch trace reads off the
port's own step: ``FlopCounterMode``'s global flops and the per-rank
collective bytes by kind.  ``repro`` keeps this model because XLA's
``cost_analysis()`` counts a scan's body once; the trace has no such
blind spot, so the two blocks cross-check each other.

All results are PER-CHIP values for the given mesh.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict

from repro_torch.configs.base import (ATTN, LOCAL_ATTN, RECURRENT, RWKV,
                                      InputShape, ModelConfig)


@dataclass
class CostBreakdown:
    flops: float              # per chip
    hbm_bytes: float          # per chip
    coll_bytes: float         # per chip
    detail: Dict[str, float]


def _itemsize(dtype: str) -> int:
    return {"bfloat16": 2, "float32": 4, "float16": 2}[dtype]


def _attn_window(cfg: ModelConfig, kind: str, S: int, long_ctx: bool) -> int:
    a = cfg.attention
    if kind == LOCAL_ATTN and a.sliding_window:
        return min(S, a.sliding_window)
    if long_ctx:
        return min(S, a.long_context_window)
    return S


def forward_flops(cfg: ModelConfig, B: int, S: int, mode: str,
                  long_ctx: bool = False) -> Dict[str, float]:
    """Global forward FLOPs by component.  mode: train|prefill|decode.
    For decode, B tokens total are processed (one per sequence) against a
    cache of length S."""
    T = B * S if mode != "decode" else B
    d, f = cfg.d_model, cfg.d_ff
    a = cfg.attention
    comps: Dict[str, float] = {}
    # matmul core: 2 flops per param per token over all matmul params
    n_matmul = cfg.active_param_count() - cfg.vocab_size * cfg.d_model * \
        (1 if cfg.tie_embeddings else 2)
    comps["matmul"] = 2.0 * T * n_matmul
    # logits
    from repro_torch.models.transformer import padded_vocab
    comps["logits"] = 2.0 * T * d * padded_vocab(cfg)
    # attention score x value contractions
    att = 0.0
    for kind in cfg.layer_pattern:
        if kind in (ATTN, LOCAL_ATTN):
            W = _attn_window(cfg, kind, S, long_ctx)
            if mode == "decode":
                # one query against W cached positions
                att += 4.0 * B * W * a.num_heads * a.head_dim
            else:
                eff = min(W, S)
                # causal: each query sees ~min(pos, W) keys ~ eff/2 on
                # average for full causal, ~W for windowed
                avg = eff / 2 if eff == S else eff
                att += 4.0 * B * S * avg * a.num_heads * a.head_dim
        elif kind == RWKV:
            H, N = cfg.recurrent.num_heads, cfg.recurrent.head_size
            att += 4.0 * (B * S if mode != "decode" else B) * H * N * N
        elif kind == RECURRENT:
            Wd = cfg.recurrent.lru_width or d
            att += 10.0 * (B * S if mode != "decode" else B) * Wd
    comps["attention"] = att
    if cfg.is_encdec:
        F = cfg.encoder_seq
        # encoder matmuls via per-layer params
        enc_params = cfg.num_encoder_layers * (
            4 * d * a.num_heads * a.head_dim + (3 if cfg.glu else 2) * d * f)
        if mode != "decode":
            comps["encoder"] = 2.0 * B * F * enc_params
            comps["encoder_attn"] = (2.0 * B * F * F * a.num_heads
                                     * a.head_dim * cfg.num_encoder_layers)
        # cross attention: queries x F encoder keys, every decoder layer
        q_T = B * (S if mode != "decode" else 1)
        comps["cross_attn"] = (4.0 * q_T * F * a.num_heads * a.head_dim
                               * cfg.num_layers)
    return comps


def step_costs(cfg: ModelConfig, shape: InputShape, chips: int,
               model_shards: int, data_shards: int, schedule: str,
               num_clusters: int = 4, pods: int = 1,
               long_ctx: bool = False, fsdp: bool = False,
               grad_sync_dtype: str = None, microbatches: int = 1,
               param_cast_dtype: str = None) -> CostBreakdown:
    """Per-chip analytic costs for one step of the mode implied by shape.

    Perf knobs: ``grad_sync_dtype`` narrows the gradient sync payload;
    ``microbatches`` divides activation memory; ``param_cast_dtype``
    narrows the FSDP all-gather payload."""
    mode = shape.mode
    B, S = shape.global_batch, shape.seq_len
    fwd = forward_flops(cfg, B, S, mode, long_ctx)
    f_fwd = sum(fwd.values())
    if mode == "train":
        mult = 4.0 if cfg.remat == "full" else 3.0   # fwd + 2x bwd (+remat)
    else:
        mult = 1.0
    flops_global = f_fwd * mult
    flops_chip = flops_global / chips

    it = _itemsize(cfg.dtype)
    pit = _itemsize(cfg.param_dtype)
    P = cfg.param_count()
    d = cfg.d_model
    L_ = cfg.num_layers
    T = B * S if mode != "decode" else B
    # HBM traffic: weights streamed per pass + activations + opt update
    # weights are sharded over model (and data if fsdp): per-chip share
    w_share = P * pit / (model_shards * (data_shards * pods if fsdp else 1))
    passes = mult            # one weight stream per fwd/bwd pass
    act_bytes = 12.0 * T * d * L_ * it / chips / max(microbatches, 1)
    hbm = w_share * passes + act_bytes
    if mode == "train":
        hbm += 5.0 * w_share * 3                     # adam: p,mu,nu r+w
    if mode == "decode":
        # read the whole cache once per step
        a = cfg.attention
        cache = 0
        for kind in cfg.layer_pattern:
            if kind in (ATTN, LOCAL_ATTN):
                W = _attn_window(cfg, kind, S, long_ctx)
                cache += 2 * B * W * a.num_kv_heads * a.head_dim * it
            elif kind == RWKV:
                H, N = cfg.recurrent.num_heads, cfg.recurrent.head_size
                cache += B * H * N * N * 4
            elif kind == RECURRENT:
                cache += B * (cfg.recurrent.lru_width or d) * 4
        hbm += cache / chips
        hbm += w_share            # weights streamed once
    bytes_chip = hbm

    # ---- collectives (per chip) ----
    coll = 0.0
    sync_it = _itemsize(grad_sync_dtype) if grad_sync_dtype else 4
    grad_share = P * sync_it / model_shards   # sync payload, model-sharded
    if mode == "train":
        if schedule == "tolfl_ring":
            k = num_clusters
            members = max(data_shards // k, 1)
            # intra-cluster psum (ring all-reduce ~ 2x payload when m>1)
            coll += (2.0 * grad_share if members > 1 else 0.0)
            # SBT chain: k-1 sequential hops, payload = grad share, but
            # only head chips move data; amortised per chip over the data
            # axis it is (k-1)/data_shards x payload... report the HEAD
            # chip (critical path): k-1 hops + pod hops
            coll += (k - 1 + (pods - 1)) * grad_share
            # broadcast (masked all-reduce)
            coll += 2.0 * grad_share
        else:
            coll += 2.0 * grad_share     # reduce-scatter + all-gather
        if fsdp:
            # param all-gather per pass (each chip receives ~the full
            # model-axis share it doesn't hold)
            gather_it = (_itemsize(param_cast_dtype)
                         if param_cast_dtype else pit)
            coll += passes * P * gather_it / model_shards
        # tensor-parallel all-reduces: 2 per layer per pass on (T_loc, d)
        if model_shards > 1:
            t_loc = T / (data_shards * pods)
            coll += 2.0 * L_ * passes * t_loc * d * it
    else:
        t_loc = T / max(data_shards * pods, 1)
        coll += 2.0 * L_ * t_loc * d * it * (1.0 if model_shards > 1 else 0.0)
        if mode == "decode" and B < data_shards:
            # sequence-parallel cache: flash-decoding combine per layer
            coll += L_ * B * cfg.attention.num_heads * cfg.attention.head_dim * 4
    return CostBreakdown(flops_chip, bytes_chip, coll,
                         dict(fwd, mult=mult, grad_share=grad_share))
