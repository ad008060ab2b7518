"""InternVL2-26B [arXiv:2404.16821] — VLM: InternViT vision encoder (STUB —
the serving inputs provide projected patch embeddings) + InternLM2-20B-class
language backbone (48L, d_model=6144, GQA kv=8).
(The port's copy of ``repro.configs.internvl2_26b``.)"""
from repro_torch.configs.base import (VLM, AttentionConfig, FrontendConfig,
                                      ModelConfig)

CONFIG = ModelConfig(
    name="internvl2-26b",
    family=VLM,
    citation="arXiv:2404.16821",
    num_layers=48,
    d_model=6144,
    d_ff=16384,
    vocab_size=92553,
    attention=AttentionConfig(
        num_heads=48, num_kv_heads=8, head_dim=128, rope_theta=1e6),
    frontend=FrontendConfig(kind="vision", frontend_seq=256,   # 256 patch toks
                            frontend_dim=6144),
    tie_embeddings=False,
)
