"""Llama-4-Scout-17B-A16E [hf:meta-llama/Llama-4-Scout-17B-16E] —
MoE 16 experts top-1, GQA kv=8, early fusion.
(The port's copy of ``repro.configs.llama4_scout``.)"""
from repro_torch.configs.base import (MOE, AttentionConfig, ModelConfig,
                                      MoEConfig)

CONFIG = ModelConfig(
    name="llama4-scout-17b-a16e",
    family=MOE,
    citation="hf:meta-llama/Llama-4-Scout-17B-16E",
    num_layers=48,
    d_model=5120,
    d_ff=8192,
    vocab_size=202048,
    attention=AttentionConfig(
        num_heads=40, num_kv_heads=8, head_dim=128, rope_theta=5e5),
    moe=MoEConfig(num_experts=16, num_experts_per_tok=1,
                  capacity_factor=1.25, shared_expert=True),
    tie_embeddings=False,
)
