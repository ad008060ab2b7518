"""Minimal functional parameter system for the port.

Port of ``repro.models.params``, the parts the Tol-FL round loop and
the model zoo's serving path need.  Params are nested dicts of tensors
with the same keys and shapes as ``repro``'s pytrees (the zoo's per-layer
trees stacked along a leading ``layers`` dim, as ``repro`` stacks them).
Leaves are ordered by sorted key, as ``jax.tree.leaves`` orders a dict.

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
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch import DeviceLike, resolve_device

Params = Dict[str, Any]
#: a parallel tree of logical axes (``repro``'s ``axes`` tree): the same
#: keys, each leaf a tuple of logical axis names (or None), one a dim
Axes = Dict[str, Any]
#: a layer's product, ``(p, x, compute_dtype=None) -> y``: :func:`dense_apply`
#: or the score path's row-stable one (``kernels/row_dense.dense_apply``)
DenseFn = Callable[..., torch.Tensor]


def normal_init(generator: torch.Generator, shape: Tuple[int, ...],
                stddev: float, device: DeviceLike = None,
                dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """N(0, stddev^2) of ``shape`` in ``dtype``, drawn in float32 on
    ``generator``'s device and then moved to ``device``, so a seed gives
    the same numbers on every target device.  Another ``dtype`` is drawn
    block by block (:func:`_blocked`).  On ``meta`` nothing is drawn
    (``generator`` may be None)."""
    if resolve_device(device).type == "meta":
        return torch.empty(shape, dtype=dtype, device="meta")
    if dtype != torch.float32:
        return _blocked(generator, shape, lambda x: x.mul_(stddev), dtype,
                        device)
    x = torch.randn(shape, generator=generator, dtype=torch.float32,
                    device=generator.device) * stddev
    return x.to(resolve_device(device))


def _blocked(generator: torch.Generator, shape: Tuple[int, ...],
             scale: Callable[[torch.Tensor], torch.Tensor],
             dtype: torch.dtype, device: DeviceLike) -> torch.Tensor:
    """A ``dtype`` tensor of ``shape`` on ``device``, allocated up front and
    filled one block at a time: each block (the last two dims: one
    layer's, or one expert's, (in, out) matrix; a leaf of two dims or
    fewer is one block) drawn in float32 on ``generator``'s device,
    ``scale``d there and cast into place.  The float32 transient is one
    block, not the leaf (21.5 GB for Maverick's stacked experts)."""
    out = torch.empty(shape, dtype=dtype, device=resolve_device(device))
    blocks = out.view(-1, *shape[-2:]) if len(shape) > 2 else out[None]
    for block in blocks:
        block.copy_(scale(torch.randn(block.shape, generator=generator,
                                      dtype=torch.float32,
                                      device=generator.device)))
    return out


def dense_init(generator: torch.Generator, in_dim: int, out_dim: int,
               bias: bool = False, device: DeviceLike = None,
               scale: Optional[float] = None, lead: Tuple[int, ...] = (),
               dtype: torch.dtype = torch.float32) -> Params:
    """Kernel (in, out) ~ N(0, stddev^2) with fan-in stddev
    ``1/sqrt(in_dim)`` unless ``scale`` is given; zero bias; both in
    ``dtype``.  ``lead`` prepends stacked dims (the zoo's ``layers`` axis):
    each (in, out) slice is one layer's draw.  Drawn in float32 on
    ``generator``'s device (the CPU by default) and then moved, so a seed
    gives the same weights on every device; another ``dtype`` block by
    block (:func:`_blocked`)."""
    shape = (*lead, in_dim, out_dim)
    if resolve_device(device).type == "meta":
        p = {"w": torch.empty(shape, dtype=dtype, device="meta")}
        if bias:
            p["b"] = torch.empty((*lead, out_dim), dtype=dtype,
                                 device="meta")
        return p

    def scaled(w):
        # in place: a stacked leaf (10.7 GB for Scout's experts) is held once
        return w.mul_(scale) if scale is not None else w.div_(
            math.sqrt(in_dim))
    if dtype == torch.float32:
        w = scaled(torch.randn(shape, generator=generator,
                               dtype=torch.float32, device=generator.device))
        p = {"w": w.to(resolve_device(device))}
    else:
        p = {"w": _blocked(generator, shape, scaled, dtype, device)}
    if bias:
        p["b"] = torch.zeros((*lead, out_dim), dtype=dtype,
                             device=p["w"].device)
    return p


def dense_apply(p: Params, x: torch.Tensor,
                compute_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """``x @ w + b``.  With a leading device axis on the params
    (``w`` (N, in, out), ``b`` (N, out)) this is a batched product, and
    ``x`` may be (N, B, in) or a shared (B, in).  ``compute_dtype`` casts
    ``w`` and ``b`` for this call only (the zoo's params, float32 or
    ``cfg.param_dtype``, compute in its activation dtype; a cast to the
    params' own dtype copies nothing)."""
    w = p["w"] if compute_dtype is None else p["w"].to(compute_dtype)
    y = x @ w
    if "b" in p:
        b = p["b"] if compute_dtype is None else p["b"].to(compute_dtype)
        y = y + b.unsqueeze(-2)
    return y


def is_axes_leaf(x) -> bool:
    """A logical-axes leaf: a (possibly empty) plain tuple of axis names.

    NamedTuples (optimizer states) are containers, not leaves."""
    return (isinstance(x, tuple) and not hasattr(x, "_fields")
            and all(e is None or isinstance(e, str) for e in x))


def dense_axes(in_ax: Optional[str], out_ax: Optional[str],
               bias: bool = False) -> Axes:
    """:func:`dense_init`'s logical axes: kernel (in, out), bias (out,)."""
    a = {"w": (in_ax, out_ax)}
    if bias:
        a["b"] = (out_ax,)
    return a


def embed_axes() -> Axes:
    return {"table": ("vocab", "embed")}


def rmsnorm_axes() -> Axes:
    return {"scale": ("embed",)}


def add_axes(axes: Axes, *names: Optional[str]) -> Axes:
    """``axes`` with ``names`` in front of every leaf (the stacked dims a
    ``lead`` puts in front: ``("layers",)``, ``("experts",)``)."""
    if is_axes_leaf(axes):
        return tuple(names) + axes
    return {k: add_axes(v, *names) for k, v in axes.items()}


def embed_init(generator: torch.Generator, vocab: int, dim: int,
               device: DeviceLike = None,
               dtype: torch.dtype = torch.float32) -> Params:
    return {"table": normal_init(generator, (vocab, dim), 0.02, device,
                                 dtype)}


def rmsnorm_init(dim: int, device: DeviceLike = None,
                 lead: Tuple[int, ...] = (),
                 dtype: torch.dtype = torch.float32) -> Params:
    return {"scale": torch.ones((*lead, dim), dtype=dtype,
                                device=resolve_device(device))}


def rmsnorm_apply(p: Params, x: torch.Tensor, eps: float = 1e-6
                  ) -> torch.Tensor:
    """RMS norm over the last dim, computed in float32 and cast back to
    ``x``'s dtype."""
    x32 = x.to(torch.float32)
    var = torch.mean(torch.square(x32), dim=-1, keepdim=True)
    y = x32 * torch.rsqrt(var + eps)
    return (y * p["scale"].to(torch.float32)).to(x.dtype)


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


def tree_from_items(items) -> Params:
    """The tree of (path, leaf) pairs (:func:`tree_items`' inverse)."""
    tree: Params = {}
    for path, leaf in items:
        node = tree
        for key in path[:-1]:
            node = node.setdefault(key, {})
        node[path[-1]] = leaf
    return tree


def tree_map_with_path(fn: Callable[[Tuple[str, ...], Any], Any],
                       tree: Params) -> Params:
    """The tree of ``fn(path, leaf)`` for each leaf of ``tree``."""
    return tree_from_items((path, fn(path, leaf))
                            for path, leaf in tree_items(tree))


def tree_map(fn: Callable[..., Any], tree: Params, *rest: Params) -> Params:
    """The tree of ``fn(leaf, *leaves of rest at the same path)``: the
    trees share ``tree``'s keys (as ``jax.tree.map`` over several trees)."""
    others = [dict(tree_items(t)) for t in rest]
    return tree_map_with_path(
        lambda path, leaf: fn(leaf, *(o[path] for o in others)), tree)


def cast_tree(params: Params, dtype: torch.dtype) -> Params:
    return tree_map(lambda x: x.to(dtype), params)


def tree_zeros_like(params: Params) -> Params:
    return tree_map(torch.zeros_like, params)


def global_norm(tree: Params) -> torch.Tensor:
    """sqrt of the sum over leaves of each leaf's float32 sum of squares
    (as ``repro`` stacks the per-leaf sums and adds them).  A DTensor
    leaf's sum is reduced over its shards to a plain scalar (left to
    DTensor, a pending sum would turn every gradient it scales into one,
    gathering each first)."""
    leaves = [_whole(torch.sum(torch.square(x.to(torch.float32))))
              for _, x in tree_items(tree)]
    return torch.sqrt(torch.sum(torch.stack(leaves)))


def _whole(x: torch.Tensor) -> torch.Tensor:
    """A DTensor's full value as a plain tensor; a plain tensor as it is."""
    return x.full_tensor() if hasattr(x, "full_tensor") else x


class GradBF16Boundary(torch.autograd.Function):
    """Identity in the forward pass; rounds a float32 cotangent through
    bfloat16 on the way back (``repro``'s ``grad_bf16_boundary``: the
    backward's partial sums then carry bf16 numbers)."""

    @staticmethod
    def forward(ctx, x):
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        if g.dtype == torch.float32:
            g = g.to(torch.bfloat16).to(torch.float32)
        return g


def grad_bf16_boundary(x: torch.Tensor) -> torch.Tensor:
    return GradBF16Boundary.apply(x)


def param_count(params: Params) -> int:
    return int(sum(np.prod(tuple(x.shape)) for _, x in tree_items(params)))


def param_bytes(params: Params) -> int:
    return int(sum(np.prod(tuple(x.shape)) * x.element_size()
                   for _, x in tree_items(params)))


def from_numpy_tree(tree: Params, device: DeviceLike = None) -> Params:
    """``repro`` params as numpy (``jax.tree.map(np.asarray, params)``) ->
    the port's tree of tensors on ``device``, bit for bit.  A bfloat16
    leaf (``ml_dtypes``' dtype, named "bfloat16"; numpy has none of its
    own) comes across through a 16-bit integer view of its bits."""
    dev = resolve_device(device)
    return tree_map_with_path(lambda _, leaf: _from_numpy(leaf).to(dev),
                              tree)


def _from_numpy(leaf) -> torch.Tensor:
    arr = np.array(leaf, copy=True)
    if arr.dtype.name == "bfloat16":
        return torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(arr)


def to_numpy_tree(tree: Params) -> Params:
    """The port's tree of tensors -> nested dict of numpy arrays, each in
    its leaf's dtype; a bfloat16 leaf (numpy has no such dtype) comes back
    as its exact float32 widening."""
    def leaf_np(_, leaf):
        leaf = leaf.detach().cpu()
        if leaf.dtype == torch.bfloat16:
            leaf = leaf.to(torch.float32)
        return leaf.numpy()
    return tree_map_with_path(leaf_np, tree)


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
        return tree_from_items(
            (path, flat[..., off:off + int(np.prod(shape))].reshape(
                *lead, *shape))
            for path, shape, off in self.entries)


@dataclass(frozen=True)
class DtypeLayout:
    """Where each leaf of a params tree sits in one flat vector of its
    dtype: one group a dtype, float32's first (empty where no leaf is
    float32), then the others by name.  The train steps' collectives send
    a buffer a group, so a bf16 leaf travels in bf16 and a mixed tree
    (Qwen3's bf16 leaves and float32 qk-norm scales) sends two buffers;
    float32 scalars (the loss, n) ride at the end of the float32 buffer
    (:meth:`zeros`' ``tail``, ``distributed._Comm.all_reduce_with``).
    ``of(tree, dtype)`` puts every leaf in one group of ``dtype``: for
    float32 its vector is :class:`FlatLayout`'s."""
    groups: Tuple[Tuple[torch.dtype, FlatLayout], ...]

    @classmethod
    def of(cls, tree: Params, dtype: Optional[torch.dtype] = None
           ) -> "DtypeLayout":
        by: Dict[torch.dtype, List] = {torch.float32: []}
        for path, leaf in tree_items(tree):
            by.setdefault(dtype or leaf.dtype, []).append((path, leaf))
        order = [torch.float32] + sorted(
            (d for d in by if d != torch.float32), key=str)
        return cls(tuple((d, FlatLayout.of(tree_from_items(by[d])))
                         for d in order))

    def flatten(self, tree: Params) -> List[torch.Tensor]:
        """Tree -> a 1-d buffer a group, each leaf cast to its group's
        dtype (an empty float32 buffer where no leaf is float32)."""
        leaves = dict(tree_items(tree))
        dev = next(iter(leaves.values())).device
        return [torch.cat([leaves[path].reshape(-1).to(dt)
                           for path, _, _ in lay.entries]) if lay.entries
                else torch.zeros(0, dtype=dt, device=dev)
                for dt, lay in self.groups]

    def zeros(self, device: DeviceLike, tail: int = 0) -> List[torch.Tensor]:
        """:meth:`flatten`'s buffers, zero, the float32 one ``tail``
        words longer."""
        return [torch.zeros(lay.size + (tail if dt == torch.float32 else 0),
                            dtype=dt, device=device)
                for dt, lay in self.groups]

    def unflatten(self, bufs: List[torch.Tensor]) -> Params:
        """A buffer a group (a float32 tail past its leaves ignored) ->
        tree of VIEWS into them, in the buffers' dtypes."""
        return tree_from_items(
            (path, buf[off:off + int(np.prod(shape))].reshape(shape))
            for (_, lay), buf in zip(self.groups, bufs)
            for path, shape, off in lay.entries)
