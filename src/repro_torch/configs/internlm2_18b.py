"""InternLM2-1.8B [arXiv:2403.17297] — dense, GQA kv=8.
(The port's copy of ``repro.configs.internlm2_18b``.)"""
from repro_torch.configs.base import AttentionConfig, ModelConfig, DENSE

CONFIG = ModelConfig(
    name="internlm2-1.8b",
    family=DENSE,
    citation="arXiv:2403.17297",
    num_layers=24,
    d_model=2048,
    d_ff=8192,
    vocab_size=92544,
    attention=AttentionConfig(
        num_heads=16, num_kv_heads=8, head_dim=128, rope_theta=1e6),
    tie_embeddings=False,
)
