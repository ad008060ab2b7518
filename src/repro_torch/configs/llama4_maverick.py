"""Llama-4-Maverick-400B-A17B [hf:meta-llama/Llama-4-Scout-17B-16E family] —
MoE 128 experts top-1, GQA kv=8, early fusion.
(The port's copy of ``repro.configs.llama4_maverick``.)"""
from repro_torch.configs.base import (MOE, AttentionConfig, ModelConfig,
                                      MoEConfig)

CONFIG = ModelConfig(
    name="llama4-maverick-400b-a17b",
    family=MOE,
    citation="hf:meta-llama/Llama-4-Scout-17B-16E",
    num_layers=48,
    d_model=5120,
    d_ff=8192,
    vocab_size=202048,
    attention=AttentionConfig(
        num_heads=40, num_kv_heads=8, head_dim=128, rope_theta=5e5),
    # interleave=2: MoE every other layer (matches the 400B-total nominal;
    # dense-FFN layers in between, as in the released model).
    moe=MoEConfig(num_experts=128, num_experts_per_tok=1,
                  capacity_factor=1.25, shared_expert=True, interleave=2),
    tie_embeddings=False,
)
