"""Qwen3-8B [hf:Qwen/Qwen3-8B] — dense, GQA kv=8, qk_norm.
(The port's copy of ``repro.configs.qwen3_8b``.)"""
from repro_torch.configs.base import AttentionConfig, ModelConfig, DENSE

CONFIG = ModelConfig(
    name="qwen3-8b",
    family=DENSE,
    citation="hf:Qwen/Qwen3-8B",
    num_layers=36,
    d_model=4096,
    d_ff=12288,
    vocab_size=151936,
    attention=AttentionConfig(
        num_heads=32, num_kv_heads=8, head_dim=128,
        qk_norm=True, rope_theta=1e6),
    tie_embeddings=False,
)
