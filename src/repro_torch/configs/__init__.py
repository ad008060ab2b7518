"""Port of ``repro.configs``: the config classes and the ``--arch``
registry, exported as ``repro.configs`` exports them."""
from repro_torch.configs.base import (INPUT_SHAPES, AttentionConfig,
                                      FrontendConfig, InputShape, MeshConfig,
                                      ModelConfig, MoEConfig, OptimizerConfig,
                                      RecurrentConfig, RunConfig, TolFLConfig)
from repro_torch.configs.registry import ARCHS, ASSIGNED, get_arch

__all__ = [
    "AttentionConfig", "FrontendConfig", "InputShape", "INPUT_SHAPES",
    "MeshConfig", "ModelConfig", "MoEConfig", "OptimizerConfig",
    "RecurrentConfig", "RunConfig", "TolFLConfig", "ARCHS", "ASSIGNED",
    "get_arch",
]
