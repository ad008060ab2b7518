"""--arch <id> registry: the architectures the port can serve.

Port of ``repro.configs.registry``.  Only the configs whose serving path
is ported are here; every other id of ``repro``'s registry raises a
``KeyError`` that says where it stands (ROADMAP.md, queue 1).
"""
from __future__ import annotations

from typing import Dict

from repro_torch.configs import (granite_3_2b, internlm2_18b, qwen3_8b,
                                 qwen15_05b, recurrentgemma_9b, rwkv6_7b)
from repro_torch.configs.base import ModelConfig

ARCHS: Dict[str, ModelConfig] = {
    m.CONFIG.name: m.CONFIG for m in (recurrentgemma_9b, rwkv6_7b,
                                      internlm2_18b, qwen3_8b, granite_3_2b,
                                      qwen15_05b)}

#: ``repro``'s other architecture ids, not ported yet
NOT_PORTED = (
    "whisper-large-v3", "llama4-maverick-400b-a17b", "internvl2-26b",
    "llama4-scout-17b-a16e",
)


def get_arch(name: str) -> ModelConfig:
    if name not in ARCHS:
        where = ("is not ported yet (ROADMAP.md, queue 1)"
                 if name in NOT_PORTED else "is unknown")
        raise KeyError(f"arch {name!r} {where}; the port serves "
                       f"{sorted(ARCHS)}")
    return ARCHS[name]
