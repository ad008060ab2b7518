"""The paper's anomaly-detection autoencoder (Section V-A).

Port of ``repro.models.autoencoder``.  Fully-connected encoder/decoder;
hidden layers 128-64 / 64-128 around a 32-wide code; ReLU hidden
activations, linear output; dropout 0.2 on hidden layers during training.
Anomaly score = squared reconstruction error.

Every function also takes params with a leading device axis (leaves
``(N, ...)``), which makes the forward pass a batched product: the
simulator takes all N per-device gradients in one pass.
"""
from __future__ import annotations

from typing import List, Optional, Sequence

import torch

from repro_torch import DeviceLike
from repro_torch.configs.autoencoder_paper import AutoencoderConfig
from repro_torch.models import params as P


def init_params(generator: torch.Generator, cfg: AutoencoderConfig,
                device: DeviceLike = None) -> P.Params:
    """Normal weights with std ``1/sqrt(fan_in)`` and zero biases, the
    distribution of ``repro``'s init (torch cannot reproduce its
    threefry draws: parity tests pass ``repro``'s params in)."""
    dims = ([cfg.input_dim] + list(cfg.hidden) + [cfg.code_dim]
            + list(reversed(cfg.hidden)) + [cfg.input_dim])
    return {f"fc{i}": P.dense_init(generator, dims[i], dims[i + 1],
                                   bias=True, device=device)
            for i in range(len(dims) - 1)}


def num_layers(cfg: AutoencoderConfig) -> int:
    return 2 * (len(cfg.hidden) + 1)


def forward(params: P.Params, cfg: AutoencoderConfig, x: torch.Tensor,
            dropout_generator: Optional[torch.Generator] = None,
            dropout_masks: Optional[Sequence[torch.Tensor]] = None,
            dense: P.DenseFn = P.dense_apply) -> torch.Tensor:
    """x: (B, input_dim) -> reconstruction (B, input_dim).

    Pass ``dropout_generator`` (on ``x``'s device) during training to
    enable dropout on hidden layers (paper: p=0.2), drawn here.  Or pass
    ``dropout_masks``, one keep mask a hidden layer (:func:`dropout_masks`),
    drawn once and broadcast against each layer's activations: several
    calls then see the same masks.  ``dense`` computes each layer's
    product (the score path passes the row-stable kernel's)."""
    act = P.activation(cfg.act)
    n = num_layers(cfg)
    h = x
    for i in range(n):
        h = dense(params[f"fc{i}"], h)
        if i < n - 1:                      # hidden layers
            h = act(h)
            if dropout_masks is not None:
                keep = dropout_masks[i]
            elif dropout_generator is not None and cfg.dropout > 0:
                keep = torch.rand(h.shape, generator=dropout_generator,
                                  device=h.device) < (1.0 - cfg.dropout)
            else:
                continue
            h = torch.where(keep, h / (1.0 - cfg.dropout),
                            torch.zeros((), device=h.device))
    return h


def dropout_masks(cfg: AutoencoderConfig, lead: Sequence[int],
                  generator: torch.Generator,
                  device: DeviceLike = None) -> Optional[List[torch.Tensor]]:
    """Keep masks of the hidden layers for activations of leading shape
    ``lead``: (*lead, width) bool a layer, in layer order, drawn on
    ``device`` (default: ``generator``'s) as :func:`forward` draws them
    inline (so a forward pass with the masks equals one with the generator
    in the same state).  ``None`` when ``cfg.dropout`` is 0."""
    if cfg.dropout <= 0:
        return None
    dims = ([cfg.input_dim] + list(cfg.hidden) + [cfg.code_dim]
            + list(reversed(cfg.hidden)))
    device = generator.device if device is None else device
    return [torch.rand((*lead, width), generator=generator, device=device)
            < (1.0 - cfg.dropout)
            for width in dims[1:]]


def recon_loss(params: P.Params, cfg: AutoencoderConfig, x: torch.Tensor,
               dropout_generator: Optional[torch.Generator] = None
               ) -> torch.Tensor:
    """Mean squared reconstruction error J(x) = ||x - x_hat||^2."""
    x_hat = forward(params, cfg, x, dropout_generator)
    return torch.mean(torch.sum(torch.square(x - x_hat), dim=-1), dim=-1)


def anomaly_scores(params: P.Params, cfg: AutoencoderConfig,
                   x: torch.Tensor, dense: P.DenseFn = P.dense_apply
                   ) -> torch.Tensor:
    """Per-sample anomaly score (no dropout at eval)."""
    x_hat = forward(params, cfg, x, dense=dense)
    return torch.sum(torch.square(x - x_hat), dim=-1)
