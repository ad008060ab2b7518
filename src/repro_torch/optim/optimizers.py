"""Optimizers from scratch: SGD, Adam, AdamW + schedules + clip.

Port of ``repro.optim.optimizers``, over the port's dict trees of
tensors.  The API is ``repro``'s (optax's, minimally):
``opt.init(params) -> state``, ``opt.update(grads, state, params) ->
(updates, state)``, then :func:`apply_updates`.  ``torch.optim`` is not
used: the float32 bias correction ``1 - b ** step``, the clip before
the moments and the update rounded to the param's dtype are
``repro``'s.  The step count and the learning rate are tensors on the
params' device, so an update never waits on the host.

A bf16 leaf is updated as ``repro`` updates it under JAX's promotion:
a Python constant (b1, b2 and their complements) is rounded to the dtype
of the tensor it multiplies (:func:`_weak`, JAX's weak type), and the
float32 learning rate widens a bf16 gradient to float32 before their
product is rounded (torch would round the learning rate to bf16 on the
CPU and keep it float32 on the card).  For float32 leaves both are what
plain arithmetic gives.
"""
from __future__ import annotations

import functools
import math
from typing import Any, Callable, NamedTuple, Optional, Tuple

import torch

from repro_torch.configs.base import OptimizerConfig
from repro_torch.models.params import global_norm, tree_items, tree_map


# ---------------------------------------------------------------------------
# LR schedules
# ---------------------------------------------------------------------------
def make_schedule(cfg: OptimizerConfig
                  ) -> Callable[[torch.Tensor], torch.Tensor]:
    """step (an int tensor) -> the float32 learning rate: linear warm-up
    over ``warmup_steps``, then constant, linear or cosine decay to
    ``total_steps``."""
    base = cfg.lr
    if cfg.schedule not in ("constant", "linear", "cosine"):
        raise ValueError(cfg.schedule)

    def sched(step: torch.Tensor) -> torch.Tensor:
        step = torch.as_tensor(step).to(torch.float32)
        warm = torch.clamp_max((step + 1) / max(cfg.warmup_steps, 1), 1.0)
        if cfg.schedule == "constant":
            return base * warm
        frac = torch.clamp((step - cfg.warmup_steps)
                           / max(cfg.total_steps - cfg.warmup_steps, 1),
                           0.0, 1.0)
        if cfg.schedule == "linear":
            decay = 1.0 - frac
        else:
            decay = 0.5 * (1.0 + torch.cos(math.pi * frac))
        return base * warm * decay

    return sched


# ---------------------------------------------------------------------------
# Gradient clipping
# ---------------------------------------------------------------------------
def clip_by_global_norm(grads, max_norm: float):
    """(grads scaled by min(1, max_norm / norm), norm)."""
    norm = global_norm(grads)
    scale = torch.clamp_max(max_norm / torch.clamp_min(norm, 1e-12), 1.0)
    return tree_map(lambda g: g * scale.to(g.dtype), grads), norm


# ---------------------------------------------------------------------------
# Optimizers
# ---------------------------------------------------------------------------
@functools.lru_cache(maxsize=None)
def _weak(c: float, dtype: torch.dtype) -> float:
    """A Python constant as JAX takes it against a tensor of ``dtype``
    (a weak type): rounded to that dtype, on the host."""
    return float(torch.tensor(c, dtype=torch.float64).to(dtype))


class Optimizer(NamedTuple):
    init: Callable[[Any], Any]
    update: Callable[..., Tuple[Any, Any]]


class SGDState(NamedTuple):
    step: torch.Tensor
    momentum: Any


def _step0(params) -> torch.Tensor:
    dev = tree_items(params)[0][1].device
    return torch.zeros((), dtype=torch.int32, device=dev)


def sgd(cfg: OptimizerConfig, momentum: float = 0.0) -> Optimizer:
    sched = make_schedule(cfg)

    def init(params):
        mom = tree_map(torch.zeros_like, params) if momentum else None
        return SGDState(_step0(params), mom)

    def update(grads, state, params=None):
        if cfg.grad_clip:
            grads, _ = clip_by_global_norm(grads, cfg.grad_clip)
        lr = sched(state.step)
        if momentum:
            new_m = tree_map(lambda m, g: momentum * m + g, state.momentum,
                             grads)
            upd = tree_map(lambda m: (-lr * m).to(m.dtype), new_m)
            return upd, SGDState(state.step + 1, new_m)
        upd = tree_map(lambda g: (-lr * g.to(torch.float32)).to(g.dtype),
                       grads)
        return upd, SGDState(state.step + 1, None)

    return Optimizer(init, update)


class AdamState(NamedTuple):
    step: torch.Tensor
    mu: Any
    nu: Any


def adam(cfg: OptimizerConfig, weight_decay: Optional[float] = None,
         state_dtype: Optional[str] = None) -> Optimizer:
    """Adam/AdamW.  ``state_dtype`` overrides the moments' dtype (bf16 for
    the very large architectures)."""
    sched = make_schedule(cfg)
    wd = cfg.weight_decay if weight_decay is None else weight_decay
    dt = getattr(torch, state_dtype) if state_dtype else None

    def init(params):
        def z(p):
            # zeros_like: a DTensor's moments take its layout
            return torch.zeros_like(p, dtype=dt or p.dtype)
        return AdamState(_step0(params), tree_map(z, params),
                         tree_map(z, params))

    def update(grads, state, params=None):
        if cfg.grad_clip:
            grads, _ = clip_by_global_norm(grads, cfg.grad_clip)
        step = state.step + 1
        lr = sched(state.step)
        b1, b2, eps = cfg.b1, cfg.b2, cfg.eps
        mu = tree_map(lambda m, g: (_weak(b1, m.dtype) * m + _weak(
            1 - b1, g.dtype) * g).to(m.dtype), state.mu, grads)
        nu = tree_map(lambda v, g: (_weak(b2, v.dtype) * v + (1 - b2)
                                    * torch.square(g.to(torch.float32))
                                    ).to(v.dtype), state.nu, grads)
        stepf = step.to(torch.float32)
        bc1 = 1 - torch.pow(b1, stepf)
        bc2 = 1 - torch.pow(b2, stepf)

        def u(m, v, p=None):
            mhat = m.to(torch.float32) / bc1
            vhat = v.to(torch.float32) / bc2
            step_ = mhat / (torch.sqrt(vhat) + eps)
            if wd and p is not None:
                step_ = step_ + wd * p.to(torch.float32)
            return (-lr * step_).to(p.dtype if p is not None else m.dtype)

        upd = (tree_map(u, mu, nu) if params is None
               else tree_map(u, mu, nu, params))
        return upd, AdamState(step, mu, nu)

    return Optimizer(init, update)


def make_optimizer(cfg: OptimizerConfig, state_dtype: Optional[str] = None
                   ) -> Optimizer:
    if cfg.name == "sgd":
        return sgd(cfg)
    if cfg.name in ("adam", "adamw"):
        return adam(cfg, state_dtype=state_dtype)
    raise ValueError(cfg.name)


def apply_updates(params, updates):
    return tree_map(lambda p, u: p + u.to(p.dtype), params, updates)
