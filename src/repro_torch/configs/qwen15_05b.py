"""Qwen1.5-0.5B [hf:Qwen/Qwen1.5-0.5B] — dense, QKV bias, MHA (kv=16).
(The port's copy of ``repro.configs.qwen15_05b``.)"""
from repro_torch.configs.base import AttentionConfig, ModelConfig, DENSE

CONFIG = ModelConfig(
    name="qwen1.5-0.5b",
    family=DENSE,
    citation="hf:Qwen/Qwen1.5-0.5B",
    num_layers=24,
    d_model=1024,
    d_ff=2816,
    vocab_size=151936,
    attention=AttentionConfig(
        num_heads=16, num_kv_heads=16, head_dim=64,
        qkv_bias=True, rope_theta=1e6),
    tie_embeddings=True,
)
