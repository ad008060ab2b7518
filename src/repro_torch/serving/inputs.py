"""Synthetic serving inputs.

Port of ``repro.serving.inputs`` for the configs the port serves
(decoder-only, no frontend): random prompt tokens from an explicit
``torch.Generator``, so equal seeds reproduce the batch exactly.
"""
from __future__ import annotations

from typing import Dict

import torch

from repro_torch import DeviceLike, resolve_device


def synthetic_batch(cfg, batch_size: int, prompt_len: int,
                    generator: torch.Generator,
                    device: DeviceLike = None) -> Dict[str, torch.Tensor]:
    """{'tokens': (batch_size, prompt_len) int64 in [0, vocab_size)},
    drawn on ``generator``'s device and moved to ``device``."""
    tokens = torch.randint(0, cfg.vocab_size, (batch_size, prompt_len),
                           generator=generator, device=generator.device)
    return {"tokens": tokens.to(resolve_device(device))}
