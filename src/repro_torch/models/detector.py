"""Pluggable per-device detector bodies for the Tol-FL round loop.

Port of ``repro.models.detector``.  A :class:`DetectorModel` is a frozen,
hashable spec exposing

* ``init_params(generator, device)`` -> params tree
* ``loss(params, x, valid, generator, dropout_masks)``  masked mean
  reconstruction loss; dropout draws from ``generator`` or applies the
  given ``dropout_masks`` (with neither, no dropout)
* ``dropout_masks(lead, generator)`` -> one keep mask a hidden layer
* ``anomaly_scores(params, x)`` -> (B,) per-sample scores
* ``param_count()`` / ``param_bytes()``  for the comm-cost models

With a leading device axis on params and data, ``loss`` returns one loss
per device.  Only the paper autoencoder is ported; ``SeqDetector`` comes
with the ``rglru_scan`` kernel.
"""
from __future__ import annotations

import functools
from dataclasses import dataclass
from typing import (Callable, Dict, List, Optional, Sequence, Tuple,
                    Union)

import torch

from repro_torch import DeviceLike
from repro_torch.configs.autoencoder_paper import CONFIG, AutoencoderConfig
from repro_torch.models import autoencoder as AE
from repro_torch.models import params as P


class DetectorModel:
    """Base class for detector specs (concrete specs are frozen
    dataclasses; the spec itself never holds tensors)."""

    def init_params(self, generator: torch.Generator,
                    device: DeviceLike = None) -> P.Params:
        raise NotImplementedError

    def loss(self, params: P.Params, x: torch.Tensor, valid: torch.Tensor,
             generator: Optional[torch.Generator] = None,
             dropout_masks: Optional[Sequence[torch.Tensor]] = None
             ) -> torch.Tensor:
        raise NotImplementedError

    def dropout_masks(self, lead: Sequence[int],
                      generator: torch.Generator
                      ) -> Optional[List[torch.Tensor]]:
        raise NotImplementedError

    def anomaly_scores(self, params: P.Params, x: torch.Tensor
                       ) -> torch.Tensor:
        raise NotImplementedError

    def param_count(self) -> int:
        return _spec_sizes(self)[0]

    def param_bytes(self) -> int:
        return _spec_sizes(self)[1]


@functools.lru_cache(maxsize=64)
def _spec_sizes(det: DetectorModel) -> Tuple[int, int]:
    """(param_count, param_bytes) of a spec, via one tiny CPU init."""
    params = det.init_params(torch.Generator().manual_seed(0), device="cpu")
    return P.param_count(params), P.param_bytes(params)


@dataclass(frozen=True)
class AutoencoderDetector(DetectorModel):
    """The paper's fully-connected autoencoder, behind the interface."""

    cfg: AutoencoderConfig = CONFIG

    def init_params(self, generator, device=None):
        return AE.init_params(generator, self.cfg, device)

    def loss(self, params, x, valid, generator=None, dropout_masks=None):
        x_hat = AE.forward(params, self.cfg, x, dropout_generator=generator,
                           dropout_masks=dropout_masks)
        err = torch.sum(torch.square(x - x_hat), dim=-1) * valid
        return (torch.sum(err, dim=-1)
                / torch.clamp_min(torch.sum(valid, dim=-1), 1.0))

    def dropout_masks(self, lead, generator):
        return AE.dropout_masks(self.cfg, lead, generator)

    def anomaly_scores(self, params, x):
        return AE.anomaly_scores(params, self.cfg, x)


ModelLike = Union[DetectorModel, AutoencoderConfig]


def as_detector(model: ModelLike) -> DetectorModel:
    """Normalise user-facing model specs to a :class:`DetectorModel`
    (a raw :class:`AutoencoderConfig` wraps into an
    :class:`AutoencoderDetector`)."""
    if isinstance(model, DetectorModel):
        return model
    if isinstance(model, AutoencoderConfig):
        return AutoencoderDetector(model)
    raise TypeError(
        f"expected a DetectorModel or AutoencoderConfig, got {model!r}")


_REGISTRY: Dict[str, Callable[..., DetectorModel]] = {}


def register_detector(name: str, factory: Callable[..., DetectorModel]
                      ) -> None:
    """Register a detector body under ``name`` (idempotent re-register of
    the same factory is allowed; silent replacement is not)."""
    prior = _REGISTRY.get(name)
    if prior is not None and prior is not factory:
        raise ValueError(f"detector {name!r} already registered")
    _REGISTRY[name] = factory


def make_detector(name: str, **kwargs) -> DetectorModel:
    if name not in _REGISTRY:
        raise KeyError(
            f"unknown detector {name!r}; known: {detector_names()}")
    return as_detector(_REGISTRY[name](**kwargs))


def detector_names() -> Tuple[str, ...]:
    return tuple(sorted(_REGISTRY))


register_detector("autoencoder", AutoencoderDetector)
