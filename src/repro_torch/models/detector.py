"""Pluggable per-device detector bodies for the Tol-FL round loop.

Port of ``repro.models.detector``.  A :class:`DetectorModel` is a frozen,
hashable spec exposing

* ``init_params(generator, device)`` -> params tree
* ``loss(params, x, valid, generator, dropout_masks)``  masked mean
  reconstruction loss; dropout draws from ``generator`` or applies the
  given ``dropout_masks`` (with neither, no dropout)
* ``dropout_masks(lead, generator, device)`` -> one keep mask a hidden
  layer, drawn on ``device`` (default: the generator's)
* ``anomaly_scores(params, x, dense)`` -> (B,) per-sample scores, each
  layer's product computed by ``dense`` (``params.dense_apply``; the
  scoring service passes the row-stable kernel's)
* ``param_count()`` / ``param_bytes()``  for the comm-cost models

With leading axes on params and data (scenario and device in the round
loop), ``loss`` returns one loss per leading index.

Two bodies ship by default, registered as ``"autoencoder"`` and
``"seq-rglru"``:

* :class:`AutoencoderDetector` — the paper's fully-connected autoencoder.
* :class:`SeqDetector` — a windowed sequence detector: features are folded
  into (seq, window) patches and reconstructed through one RG-LRU block
  (``models/rglru.py``), whose recurrence is the ``rglru_scan`` kernel,
  forward and backward.

``budget_family`` names each body's family ("ae", "seq"), as in ``repro``.
"""
from __future__ import annotations

import functools
from dataclasses import dataclass
from typing import (Callable, Dict, List, Optional, Sequence, Tuple,
                    Union)

import torch
import torch.nn.functional as F

from repro_torch import DeviceLike
from repro_torch.configs.autoencoder_paper import CONFIG, AutoencoderConfig
from repro_torch.configs.base import ModelConfig, RecurrentConfig
from repro_torch.models import autoencoder as AE
from repro_torch.models import params as P
from repro_torch.models import rglru as R


class DetectorModel:
    """Base class for detector specs (concrete specs are frozen
    dataclasses; the spec itself never holds tensors)."""

    #: the body's family ("ae", "seq"), as ``repro`` names it
    budget_family: str = "ae"

    def init_params(self, generator: torch.Generator,
                    device: DeviceLike = None) -> P.Params:
        raise NotImplementedError

    def loss(self, params: P.Params, x: torch.Tensor, valid: torch.Tensor,
             generator: Optional[torch.Generator] = None,
             dropout_masks: Optional[Sequence[torch.Tensor]] = None
             ) -> torch.Tensor:
        raise NotImplementedError

    def dropout_masks(self, lead: Sequence[int],
                      generator: torch.Generator,
                      device: DeviceLike = None
                      ) -> Optional[List[torch.Tensor]]:
        raise NotImplementedError

    def anomaly_scores(self, params: P.Params, x: torch.Tensor,
                       dense: P.DenseFn = P.dense_apply) -> torch.Tensor:
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

    def dropout_masks(self, lead, generator, device=None):
        return AE.dropout_masks(self.cfg, lead, generator, device)

    def anomaly_scores(self, params, x, dense=P.dense_apply):
        return AE.anomaly_scores(params, self.cfg, x, dense)


@dataclass(frozen=True)
class SeqDetector(DetectorModel):
    """Windowed sequence reconstruction through one RG-LRU block.

    The (..., input_dim) feature rows are zero-padded to a multiple of
    ``window`` and folded into (..., seq, window) patches; each patch is
    embedded, run through the Griffin-style RG-LRU block
    (:func:`repro_torch.models.rglru.rglru_block`), decoded back to window
    space, and scored by squared reconstruction error — the loss / score
    contract of the paper autoencoder, so it trains under the same
    campaigns.  Dropout (rate ``dropout``) acts on the block's output, one
    keep mask of (*lead, seq_len, d_model)."""

    input_dim: int = 112
    window: int = 16
    d_model: int = 16
    lru_width: Optional[int] = None
    conv1d_width: int = 2
    dropout: float = 0.0
    act: str = "gelu"
    name: str = "seq-rglru"

    budget_family = "seq"

    @property
    def seq_len(self) -> int:
        return -(-self.input_dim // self.window)

    def _model_cfg(self) -> ModelConfig:
        return ModelConfig(
            name=self.name, d_model=self.d_model,
            recurrent=RecurrentConfig(lru_width=self.lru_width,
                                      conv1d_width=self.conv1d_width))

    def _windows(self, x: torch.Tensor) -> torch.Tensor:
        """(..., input_dim) -> (..., seq_len, window), zero-padded."""
        pad = self.seq_len * self.window - self.input_dim
        return F.pad(x, (0, pad)).reshape(*x.shape[:-1], self.seq_len,
                                          self.window)

    def init_params(self, generator, device=None):
        return {"enc": P.dense_init(generator, self.window, self.d_model,
                                    bias=True, device=device),
                "rglru": R.rglru_init(generator, self._model_cfg(), device),
                "dec": P.dense_init(generator, self.d_model, self.window,
                                    bias=True, device=device)}

    def _reconstruct(self, params, x, generator=None, dropout_masks=None,
                     dense=P.dense_apply):
        """x (..., n, input_dim) against params with leading axes that
        broadcast against x's leading axes -> (*lead, n, input_dim)."""
        h = P.activation(self.act)(R.dense_tokens(
            params["enc"], self._windows(x), dense=dense))
        h = R.rglru_block(params["rglru"], h, dense)
        keep = None
        if dropout_masks is not None:
            keep = dropout_masks[0]
        elif generator is not None and self.dropout > 0:
            keep = torch.rand(h.shape, generator=generator,
                              device=h.device) < (1.0 - self.dropout)
        if keep is not None:
            h = torch.where(keep, h / (1.0 - self.dropout),
                            torch.zeros((), device=h.device))
        y = R.dense_tokens(params["dec"], h, dense=dense)
        return y.reshape(*y.shape[:-2], -1)[..., :self.input_dim]

    def loss(self, params, x, valid, generator=None, dropout_masks=None):
        x_hat = self._reconstruct(params, x, generator, dropout_masks)
        err = torch.sum(torch.square(x - x_hat), dim=-1) * valid
        return (torch.sum(err, dim=-1)
                / torch.clamp_min(torch.sum(valid, dim=-1), 1.0))

    def dropout_masks(self, lead, generator, device=None):
        """One keep mask of (*lead, seq_len, d_model) for the block's
        output, drawn as :meth:`loss` draws it inline, on ``device``
        (default: the generator's); ``None`` when ``dropout`` is 0."""
        if self.dropout <= 0:
            return None
        device = generator.device if device is None else device
        return [torch.rand((*lead, self.seq_len, self.d_model),
                           generator=generator, device=device)
                < (1.0 - self.dropout)]

    def anomaly_scores(self, params, x, dense=P.dense_apply):
        x_hat = self._reconstruct(params, x, dense=dense)
        return torch.sum(torch.square(x - x_hat), dim=-1)


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


def canonical_model_key(model: ModelLike):
    """The model's component of a cache key: autoencoder specs key on
    their :class:`AutoencoderConfig`, whichever spelling the caller used
    (as ``repro`` keys its executables), other bodies on the frozen spec
    itself."""
    if isinstance(model, AutoencoderDetector):
        return model.cfg
    if isinstance(model, (DetectorModel, AutoencoderConfig)):
        return model
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


def spec_classes() -> Tuple[type, ...]:
    """The registered spec classes (plancheck's cache-key check holds
    each to a frozen, eq, hashable dataclass)."""
    return tuple(f for f in _REGISTRY.values() if isinstance(f, type))


register_detector("autoencoder", AutoencoderDetector)
register_detector("seq-rglru", SeqDetector)
