"""Minimal functional parameter system for the port.

Port of ``repro.models.params``, the parts the Tol-FL round loop needs.
Params are nested dicts of tensors with the same keys and shapes as
``repro``'s pytrees.  Leaves are ordered by sorted key, as
``jax.tree.leaves`` orders a dict.

The simulator holds params as ONE flat f32 tensor of ``P`` elements
(:class:`FlatLayout`): the combine is elementwise, so the flat layout
gives the same numbers as ``repro``'s per-leaf ``tree.map`` while a
round's gradients form one ``(N, P)`` tensor and the combine kernel takes
``(k, P)``.  Per-layer tensors are views into the flat one.

``from_numpy_tree`` / ``to_numpy_tree`` are the weight bridge: a
``repro`` pytree as numpy arrays (``jax.tree.map(np.asarray, params)``)
in, the port's tree out, and back.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Tuple

import numpy as np
import torch

from repro_torch import DeviceLike, resolve_device

Params = Dict[str, Any]


def dense_init(generator: torch.Generator, in_dim: int, out_dim: int,
               bias: bool = False, device: DeviceLike = None) -> Params:
    """Kernel (in, out) ~ N(0, stddev^2) with fan-in stddev
    ``1/sqrt(in_dim)``; zero bias.  Drawn on ``generator``'s device (the
    CPU by default) and then moved, so a seed gives the same weights on
    every device."""
    w = torch.randn((in_dim, out_dim), generator=generator,
                    dtype=torch.float32) / math.sqrt(in_dim)
    p = {"w": w.to(resolve_device(device))}
    if bias:
        p["b"] = torch.zeros((out_dim,), dtype=torch.float32,
                             device=p["w"].device)
    return p


def dense_apply(p: Params, x: torch.Tensor) -> torch.Tensor:
    """``x @ w + b``.  With a leading device axis on the params
    (``w`` (N, in, out), ``b`` (N, out)) this is a batched product, and
    ``x`` may be (N, B, in) or a shared (B, in)."""
    y = x @ p["w"]
    if "b" in p:
        y = y + p["b"].unsqueeze(-2)
    return y


def activation(name: str) -> Callable[[torch.Tensor], torch.Tensor]:
    return {
        "relu": torch.relu,
        "gelu": lambda x: torch.nn.functional.gelu(x, approximate="tanh"),
        "silu": torch.nn.functional.silu,
        "sqrelu": lambda x: torch.square(torch.relu(x)),
        "linear": lambda x: x,
        "tanh": torch.tanh,
    }[name]


# ---------------------------------------------------------------------------
# Tree utilities
# ---------------------------------------------------------------------------
def tree_items(tree: Params, prefix: Tuple[str, ...] = ()
               ) -> List[Tuple[Tuple[str, ...], Any]]:
    """(path, leaf) pairs in ``jax.tree.leaves`` order (sorted keys)."""
    out = []
    for key in sorted(tree):
        v = tree[key]
        if isinstance(v, dict):
            out.extend(tree_items(v, prefix + (key,)))
        else:
            out.append((prefix + (key,), v))
    return out


def _tree_from_items(items) -> Params:
    tree: Params = {}
    for path, leaf in items:
        node = tree
        for key in path[:-1]:
            node = node.setdefault(key, {})
        node[path[-1]] = leaf
    return tree


def param_count(params: Params) -> int:
    return int(sum(np.prod(tuple(x.shape)) for _, x in tree_items(params)))


def param_bytes(params: Params) -> int:
    return int(sum(np.prod(tuple(x.shape)) * x.element_size()
                   for _, x in tree_items(params)))


def from_numpy_tree(tree: Params, device: DeviceLike = None) -> Params:
    """``repro`` params as numpy (``jax.tree.map(np.asarray, params)``) ->
    the port's tree of tensors on ``device``."""
    dev = resolve_device(device)
    return _tree_from_items(
        (path, torch.from_numpy(np.array(leaf, copy=True)).to(dev))
        for path, leaf in tree_items(tree))


def to_numpy_tree(tree: Params) -> Params:
    """The port's tree of tensors -> nested dict of numpy arrays."""
    return _tree_from_items((path, leaf.detach().cpu().numpy())
                            for path, leaf in tree_items(tree))


@dataclass(frozen=True)
class FlatLayout:
    """Where each leaf of a params tree sits in one flat f32 vector."""
    entries: Tuple[Tuple[Tuple[str, ...], Tuple[int, ...], int], ...]
    size: int

    @classmethod
    def of(cls, tree: Params) -> "FlatLayout":
        entries, off = [], 0
        for path, leaf in tree_items(tree):
            shape = tuple(leaf.shape)
            entries.append((path, shape, off))
            off += int(np.prod(shape))
        return cls(tuple(entries), off)

    def flatten(self, tree: Params) -> torch.Tensor:
        """Tree (leaves may share leading batch dims) -> (..., P)."""
        leaves = dict(tree_items(tree))
        parts = []
        for path, shape, _ in self.entries:
            x = leaves[path]
            lead = x.shape[:x.dim() - len(shape)]
            parts.append(x.reshape(*lead, -1).to(torch.float32))
        return torch.cat(parts, dim=-1)

    def unflatten(self, flat: torch.Tensor) -> Params:
        """(..., P) -> tree of VIEWS into ``flat`` with the same leading
        dims (gradients taken w.r.t. ``flat`` come out flat)."""
        lead = flat.shape[:-1]
        return _tree_from_items(
            (path, flat[..., off:off + int(np.prod(shape))].reshape(
                *lead, *shape))
            for path, shape, off in self.entries)
