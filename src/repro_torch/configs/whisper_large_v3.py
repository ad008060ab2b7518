"""Whisper-large-v3 [arXiv:2212.04356] — encoder-decoder audio backbone.
Conv/mel frontend is a STUB: the serving inputs provide precomputed frame
embeddings (batch, 1500, 1280) for the encoder.
(The port's copy of ``repro.configs.whisper_large_v3``.)"""
from repro_torch.configs.base import (AUDIO, AttentionConfig, FrontendConfig,
                                      ModelConfig)

CONFIG = ModelConfig(
    name="whisper-large-v3",
    family=AUDIO,
    citation="arXiv:2212.04356",
    num_layers=32,                 # decoder layers
    num_encoder_layers=32,
    encoder_seq=1500,              # 30 s of audio at 50 Hz after conv stub
    d_model=1280,
    d_ff=5120,
    vocab_size=51866,
    attention=AttentionConfig(
        num_heads=20, num_kv_heads=20, head_dim=64,
        qkv_bias=True, rope_theta=0.0),   # whisper uses learned abs pos
    frontend=FrontendConfig(kind="audio", frontend_seq=1500,
                            frontend_dim=1280),
    glu=False,
    act="gelu",
    tie_embeddings=True,
)
