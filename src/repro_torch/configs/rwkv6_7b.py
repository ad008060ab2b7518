"""RWKV6-7B "Finch" [arXiv:2404.05892] — attention-free SSM with
data-dependent decay.  d_model=4096, 32 layers, head_size=64.  (The
port's copy of ``repro.configs.rwkv6_7b``.)"""
from repro_torch.configs.base import ModelConfig, RecurrentConfig, SSM

CONFIG = ModelConfig(
    name="rwkv6-7b",
    family=SSM,
    citation="arXiv:2404.05892",
    num_layers=32,
    d_model=4096,
    d_ff=14336,
    vocab_size=65536,
    recurrent=RecurrentConfig(num_heads=64, head_size=64),
    glu=False,            # rwkv channel-mix is a squared-relu 2-matrix mlp
    act="sqrelu",
    tie_embeddings=False,
)
