"""Granite-3.0-2B [hf:ibm-granite/granite-3.0-2b-base] — dense, GQA kv=8.
(The port's copy of ``repro.configs.granite_3_2b``.)"""
from repro_torch.configs.base import AttentionConfig, ModelConfig, DENSE

CONFIG = ModelConfig(
    name="granite-3-2b",
    family=DENSE,
    citation="hf:ibm-granite/granite-3.0-2b-base",
    num_layers=40,
    d_model=2048,
    d_ff=8192,
    vocab_size=49155,
    attention=AttentionConfig(
        num_heads=32, num_kv_heads=8, head_dim=64, rope_theta=1e6),
    tie_embeddings=True,
)
