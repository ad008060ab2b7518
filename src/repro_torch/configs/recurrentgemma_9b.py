"""RecurrentGemma-9B (Griffin) [arXiv:2402.19427] — hybrid: RG-LRU recurrent
blocks + local (sliding-window 2048) attention in a 2:1 pattern.  (The
port's copy of ``repro.configs.recurrentgemma_9b``.)"""
from repro_torch.configs.base import (AttentionConfig, ModelConfig,
                                      RecurrentConfig, HYBRID, LOCAL_ATTN,
                                      RECURRENT)

CONFIG = ModelConfig(
    name="recurrentgemma-9b",
    family=HYBRID,
    citation="arXiv:2402.19427",
    num_layers=38,
    d_model=4096,
    d_ff=12288,
    vocab_size=256000,
    attention=AttentionConfig(
        num_heads=16, num_kv_heads=1, head_dim=256,
        sliding_window=2048, rope_theta=10000.0),
    recurrent=RecurrentConfig(
        lru_width=4096, conv1d_width=4,
        block_pattern=(RECURRENT, RECURRENT, LOCAL_ATTN)),  # 1:2 attn:rec
    glu=True,
    act="gelu",
    tie_embeddings=True,
)
