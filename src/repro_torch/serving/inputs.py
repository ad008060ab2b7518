"""Synthetic serving inputs.

Port of ``repro.serving.inputs``: the prefill input batch of one
architecture config, drawn from an explicit ``torch.Generator``, so equal
seeds reproduce the batch exactly.
"""
from __future__ import annotations

from typing import Dict

import torch

from repro_torch import DeviceLike, resolve_device


def synthetic_batch(cfg, batch_size: int, prompt_len: int,
                    generator: torch.Generator,
                    device: DeviceLike = None) -> Dict[str, torch.Tensor]:
    """{'tokens': (batch_size, prompt_len) int64 in [0, vocab_size)}, with
    'frames' (batch_size, encoder_seq or 16, d) for an encoder-decoder and
    'prefix' (batch_size, frontend_seq or 16, d) for a vision frontend,
    standard normal float32; drawn in that order on ``generator``'s
    device and moved to ``device``."""
    dev = resolve_device(device)
    gdev = generator.device
    batch = {"tokens": torch.randint(0, cfg.vocab_size,
                                     (batch_size, prompt_len),
                                     generator=generator, device=gdev)}
    if cfg.is_encdec:
        batch["frames"] = torch.randn(
            (batch_size, cfg.encoder_seq or 16, cfg.d_model),
            generator=generator, device=gdev)
    if cfg.frontend.kind == "vision":
        batch["prefix"] = torch.randn(
            (batch_size, cfg.frontend.frontend_seq or 16, cfg.d_model),
            generator=generator, device=gdev)
    return {name: x.to(dev) for name, x in batch.items()}
