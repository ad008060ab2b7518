"""--arch <id> registry mapping architecture ids to ModelConfigs.

Port of ``repro.configs.registry``: the same ten ids, each the port's
copy of ``repro``'s config.
"""
from __future__ import annotations

from typing import Dict

from repro_torch.configs import (granite_3_2b, internlm2_18b, internvl2_26b,
                                 llama4_maverick, llama4_scout, qwen3_8b,
                                 qwen15_05b, recurrentgemma_9b, rwkv6_7b,
                                 whisper_large_v3)
from repro_torch.configs.base import ModelConfig

ARCHS: Dict[str, ModelConfig] = {
    m.CONFIG.name: m.CONFIG for m in (
        recurrentgemma_9b, rwkv6_7b, whisper_large_v3, internlm2_18b,
        llama4_maverick, internvl2_26b, llama4_scout, qwen3_8b, granite_3_2b,
        qwen15_05b)}

# ids as assigned in the brief
ASSIGNED = (
    "recurrentgemma-9b", "rwkv6-7b", "whisper-large-v3", "internlm2-1.8b",
    "llama4-maverick-400b-a17b", "internvl2-26b", "llama4-scout-17b-a16e",
    "qwen3-8b", "granite-3-2b", "qwen1.5-0.5b",
)


def get_arch(name: str) -> ModelConfig:
    if name not in ARCHS:
        raise KeyError(f"unknown arch {name!r}; available: {sorted(ARCHS)}")
    return ARCHS[name]
