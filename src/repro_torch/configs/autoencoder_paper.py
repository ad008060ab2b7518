"""The paper's anomaly-detection autoencoder (Section V-A).

Fully-connected encoder/decoder, three hidden layers with 64-128 neurons,
code vector length 32, ReLU hidden activations, linear output, dropout 0.2.
Trained to minimise reconstruction error ||x - x_hat||^2; the reconstruction
error is the anomaly score.  (The port's copy of
``repro.configs.autoencoder_paper``.)
"""
from dataclasses import dataclass
from typing import Tuple


@dataclass(frozen=True)
class AutoencoderConfig:
    name: str = "paper-autoencoder"
    input_dim: int = 112                       # Comms-ML sample shape 112x1
    hidden: Tuple[int, ...] = (128, 64)        # encoder hidden layers
    code_dim: int = 32
    dropout: float = 0.2
    act: str = "relu"


# per-dataset variants used by the paper (Table VII)
COMMSML = AutoencoderConfig(input_dim=112)
FMNIST = AutoencoderConfig(name="paper-autoencoder-fmnist", input_dim=784)
CIFAR10 = AutoencoderConfig(name="paper-autoencoder-cifar10", input_dim=3072)
CIFAR100 = AutoencoderConfig(name="paper-autoencoder-cifar100", input_dim=3072)

CONFIG = COMMSML
