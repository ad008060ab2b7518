"""Model configs of the zoo: plain dataclasses, no external deps.

The port's copy of the model half of ``repro.configs.base``
(``AttentionConfig``, ``MoEConfig``, ``RecurrentConfig``,
``FrontendConfig``, ``ModelConfig`` and the family / layer-kind
constants), field for field, so that a config compares equal to
``repro``'s by ``dataclasses.asdict``, and the run-level half (``InputShape``,
``INPUT_SHAPES``, ``TolFLConfig``, ``OptimizerConfig``, ``MeshConfig``,
``RunConfig``) field for field as well.

* ``reduced()`` produces the CPU-smoke-test variant of the same family
  (2 layers, d_model<=512, <=4 experts).
* Everything is hashable (tuples, not lists).
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Optional, Tuple


# ---------------------------------------------------------------------------
# Architecture families
# ---------------------------------------------------------------------------
DENSE = "dense"
MOE = "moe"
SSM = "ssm"        # attention-free (RWKV6)
HYBRID = "hybrid"  # RG-LRU + local attention (RecurrentGemma)
AUDIO = "audio"    # encoder-decoder with stubbed conv/mel frontend (Whisper)
VLM = "vlm"        # decoder with stubbed vision frontend (InternVL2)

FAMILIES = (DENSE, MOE, SSM, HYBRID, AUDIO, VLM)

# Layer kinds used by the hybrid pattern.
ATTN = "attn"          # global attention
LOCAL_ATTN = "local"   # sliding-window / local attention
RECURRENT = "rec"      # RG-LRU recurrent block
RWKV = "rwkv"          # RWKV6 time-mix block


@dataclass(frozen=True)
class AttentionConfig:
    num_heads: int = 8
    num_kv_heads: int = 8          # GQA: kv heads <= heads
    head_dim: int = 128
    qk_norm: bool = False          # Qwen3-style per-head RMSNorm on q,k
    qkv_bias: bool = False         # Qwen1.5-style bias on qkv projections
    rope_theta: float = 10000.0
    sliding_window: Optional[int] = None   # None => full causal attention
    causal: bool = True
    # Beyond-paper extension: dense archs may select a sliding-window variant
    # for the long_500k shape (DESIGN.md section 4).
    long_context_window: int = 4096


@dataclass(frozen=True)
class MoEConfig:
    num_experts: int = 0           # 0 => dense MLP
    num_experts_per_tok: int = 1   # top-k routing (Llama-4: top-1)
    capacity_factor: float = 1.25
    router_aux_loss_coef: float = 0.01
    # every `interleave` layers is MoE; others dense (Llama-4 interleaves;
    # we default to all-MoE when num_experts>0 and interleave==1)
    interleave: int = 1
    shared_expert: bool = False


@dataclass(frozen=True)
class RecurrentConfig:
    """RG-LRU (RecurrentGemma) / RWKV6 recurrence parameters."""
    lru_width: Optional[int] = None     # defaults to d_model
    conv1d_width: int = 4               # temporal conv in recurrent block
    num_heads: int = 8                  # rwkv heads = d_model // head_size
    head_size: int = 64
    # hybrid pattern: e.g. ("rec", "rec", "local") repeated => 1:2 attn ratio
    block_pattern: Tuple[str, ...] = ()


@dataclass(frozen=True)
class FrontendConfig:
    """Stubbed modality frontend (audio conv / vision patch embedder).

    Per the brief the frontend itself is NOT implemented; ``input_specs``
    provides precomputed embeddings of shape (batch, frontend_seq, d_model)
    for the encoder (audio) or prefix tokens (vlm).
    """
    kind: str = "none"                  # "audio" | "vision" | "none"
    frontend_seq: int = 0               # frames / patches after the stub
    frontend_dim: int = 0               # embedding dim handed to backbone


@dataclass(frozen=True)
class ModelConfig:
    name: str = "model"
    family: str = DENSE
    citation: str = ""
    num_layers: int = 2
    d_model: int = 256
    d_ff: int = 1024
    vocab_size: int = 32000
    attention: AttentionConfig = field(default_factory=AttentionConfig)
    moe: MoEConfig = field(default_factory=MoEConfig)
    recurrent: RecurrentConfig = field(default_factory=RecurrentConfig)
    frontend: FrontendConfig = field(default_factory=FrontendConfig)
    # encoder-decoder (whisper): encoder layer count; 0 => decoder-only
    num_encoder_layers: int = 0
    encoder_seq: int = 0                 # encoder positions (whisper: 1500)
    tie_embeddings: bool = True
    norm_eps: float = 1e-6
    act: str = "silu"                    # mlp activation
    glu: bool = True                     # gated linear unit mlp
    dtype: str = "bfloat16"
    param_dtype: str = "float32"
    # remat policy for the layer scan: "none" | "full" | "dots_saveable"
    remat: str = "full"
    max_seq_len: int = 8192

    # ---------------- derived ----------------
    @property
    def head_dim(self) -> int:
        return self.attention.head_dim

    @property
    def is_encdec(self) -> bool:
        return self.num_encoder_layers > 0

    @property
    def layer_pattern(self) -> Tuple[str, ...]:
        """Per-layer kind sequence of length num_layers."""
        pat = self.recurrent.block_pattern
        if not pat:
            base = (RWKV,) if self.family == SSM else (ATTN,)
            return base * self.num_layers
        reps = (self.num_layers + len(pat) - 1) // len(pat)
        return (pat * reps)[: self.num_layers]

    def param_count(self) -> int:
        """Analytic parameter count (embedding + layers + head)."""
        d, f, v = self.d_model, self.d_ff, self.vocab_size
        a = self.attention
        total = v * d                               # embedding
        if not self.tie_embeddings:
            total += v * d
        q = a.num_heads * a.head_dim
        kv = a.num_kv_heads * a.head_dim
        attn_p = d * q + 2 * d * kv + q * d
        if a.qkv_bias:
            attn_p += q + 2 * kv
        mlp_dense = (3 if self.glu else 2) * d * f
        rec = self.recurrent
        lru_w = rec.lru_width or d
        rglru_p = (2 * d * lru_w            # in proj (x branch + gate branch)
                   + lru_w * d              # out proj
                   + rec.conv1d_width * lru_w
                   + 2 * lru_w)             # a-param + input gate
        rwkv_p = (4 * d * d                 # r,k,v,g (o folded into v-ish) …
                  + d * d                   # output
                  + 6 * d                   # mu / decay params
                  + 2 * d * 64)             # lora-style ddlerp adapters
        for li, kind in enumerate(self.layer_pattern):
            total += 2 * d                  # norms
            if kind == ATTN or kind == LOCAL_ATTN:
                total += attn_p
            elif kind == RECURRENT:
                total += rglru_p
            elif kind == RWKV:
                total += rwkv_p
            # mlp / moe (moe only on every `interleave`-th layer)
            m = self.moe
            if m.num_experts > 0 and li % m.interleave == 0:
                total += d * m.num_experts                   # router
                total += m.num_experts * mlp_dense
                if m.shared_expert:
                    total += mlp_dense
            else:
                total += mlp_dense
        if self.is_encdec:
            enc_layer = 2 * d + attn_p + mlp_dense
            total += self.num_encoder_layers * enc_layer
        total += d                                           # final norm
        return total

    def active_param_count(self) -> int:
        """Params touched per token (MoE: only routed experts)."""
        if self.moe.num_experts == 0:
            return self.param_count()
        m = self.moe
        dense_like = dataclasses.replace(self, moe=MoEConfig(num_experts=0))
        per_expert = (3 if self.glu else 2) * self.d_model * self.d_ff
        n_moe_layers = sum(1 for li in range(self.num_layers)
                           if li % m.interleave == 0)
        extra_per_moe = (self.d_model * m.num_experts
                         + m.num_experts_per_tok * per_expert
                         + (per_expert if m.shared_expert else 0)
                         - per_expert)  # replaces the dense mlp counted above
        return dense_like.param_count() + n_moe_layers * extra_per_moe

    def reduced(self) -> "ModelConfig":
        """CPU smoke-test variant of the same family (brief requirement:
        2 layers, d_model<=512, <=4 experts)."""
        d = min(self.d_model, 256)
        heads = min(self.attention.num_heads, 4)
        kvh = max(1, min(self.attention.num_kv_heads, heads))
        att = dataclasses.replace(
            self.attention, num_heads=heads, num_kv_heads=kvh,
            head_dim=d // heads if d // heads >= 8 else 8,
            sliding_window=(64 if self.attention.sliding_window else None),
            long_context_window=64,
        )
        moe = dataclasses.replace(
            self.moe,
            num_experts=min(self.moe.num_experts, 4) if self.moe.num_experts else 0)
        rec = dataclasses.replace(
            self.recurrent,
            lru_width=d if self.recurrent.lru_width else None,
            num_heads=max(1, min(self.recurrent.num_heads, 4)),
            head_size=d // max(1, min(self.recurrent.num_heads, 4)),
            # keep one recurrent + one local-attn layer so the reduced
            # hybrid still exercises both block kinds in 2 layers
            block_pattern=((RECURRENT, LOCAL_ATTN)
                           if self.recurrent.block_pattern else ()))
        return dataclasses.replace(
            self, name=self.name + "-reduced", num_layers=2, d_model=d,
            d_ff=min(self.d_ff, 512), vocab_size=min(self.vocab_size, 1024),
            attention=att, moe=moe, recurrent=rec,
            num_encoder_layers=min(self.num_encoder_layers, 2),
            encoder_seq=min(self.encoder_seq, 16) if self.encoder_seq else 0,
            frontend=dataclasses.replace(
                self.frontend,
                frontend_seq=min(self.frontend.frontend_seq, 16),
                frontend_dim=d if self.frontend.frontend_dim else 0),
            max_seq_len=512, remat="none", dtype="float32")


# ---------------------------------------------------------------------------
# Input shapes (assigned)
# ---------------------------------------------------------------------------
@dataclass(frozen=True)
class InputShape:
    name: str
    seq_len: int
    global_batch: int
    mode: str  # "train" | "prefill" | "decode"


INPUT_SHAPES = {
    "train_4k": InputShape("train_4k", 4096, 256, "train"),
    "prefill_32k": InputShape("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": InputShape("decode_32k", 32768, 128, "decode"),
    "long_500k": InputShape("long_500k", 524288, 1, "decode"),
}


# ---------------------------------------------------------------------------
# Training / run config
# ---------------------------------------------------------------------------
@dataclass(frozen=True)
class TolFLConfig:
    """The paper's technique: hierarchical aggregation over the data axis.

    num_clusters == 1  -> plain FedAvg (FL)
    num_clusters == N  -> SBT (flat ring)
    1 < k < N          -> Tol-FL proper
    """
    num_clusters: int = 4
    # "tolfl_ring": paper-faithful — all-reduce inside clusters + a
    #               sequential send/recv chain over cluster heads
    #               (Algorithm 1).
    # "tolfl_psum": beyond-paper — algebraically identical weighted
    #               all-reduce.
    # "fedavg":     single global all-reduce with a designated server.
    # "sbt_ring":   full sequential ring (k = N).
    schedule: str = "tolfl_ring"
    local_epochs: int = 1          # E: local steps per round
    server_coord: int = 0          # which member index acts as cluster head
    pod_ring: bool = True          # multi-pod: SBT ring over the pod axis
    # dtype the gradients are cast to for the cross-rank sync; f32 master
    # grads are restored after.
    grad_sync_dtype: Optional[str] = None        # e.g. "bfloat16"
    # gradient accumulation: split the batch into m microbatches run one
    # after the other — divides activation memory by m.
    microbatches: int = 1
    # cast the f32 params once at step start to this dtype.
    param_cast_dtype: Optional[str] = None       # e.g. "bfloat16"


@dataclass(frozen=True)
class OptimizerConfig:
    name: str = "adam"             # "sgd" | "adam" | "adamw"
    lr: float = 1e-3
    warmup_steps: int = 100
    total_steps: int = 10000
    schedule: str = "cosine"       # "constant" | "cosine" | "linear"
    b1: float = 0.9
    b2: float = 0.999
    eps: float = 1e-8
    weight_decay: float = 0.0
    grad_clip: float = 1.0


@dataclass(frozen=True)
class MeshConfig:
    data: int = 16
    model: int = 16
    pods: int = 1

    @property
    def multi_pod(self) -> bool:
        return self.pods > 1


@dataclass(frozen=True)
class RunConfig:
    model: ModelConfig = field(default_factory=ModelConfig)
    tolfl: TolFLConfig = field(default_factory=TolFLConfig)
    optimizer: OptimizerConfig = field(default_factory=OptimizerConfig)
    mesh: MeshConfig = field(default_factory=MeshConfig)
    shape: InputShape = field(default_factory=lambda: INPUT_SHAPES["train_4k"])
    seed: int = 0
    use_pallas: bool = False       # repro's Pallas switch, kept for parity
    log_every: int = 10
    ckpt_every: int = 0            # 0 => disabled
    ckpt_dir: str = "/tmp/repro_ckpt"
