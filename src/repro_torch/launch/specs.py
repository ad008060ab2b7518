"""Input stand-ins for every (arch x input-shape) combination.

Port of ``repro.launch.specs``.  Where ``repro`` hands its dry-run
``ShapeDtypeStruct``s carrying a ``NamedSharding``, the port hands
``meta`` tensors (shapes and dtypes, no storage): with a mesh each is a
DTensor of ``repro``'s placements over it, whose local shard is this
rank's, so the dry-run runs the port's own step on them.  Without a mesh
they are plain ``meta`` tensors of the global shapes.

Modality carve-out: for audio / vlm the frontend is a stub, so the
stand-ins are precomputed frame / patch embeddings of the right shape
instead of raw audio / pixels.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Sequence

import torch

from repro_torch.configs.base import InputShape, ModelConfig, OptimizerConfig
from repro_torch.core import distributed as D
from repro_torch.models import transformer as T
from repro_torch.serving.decode import cache_logical_axes, cache_shape
from repro_torch.sharding import logical as L

# vlm: number of (stubbed) patch-embedding prefix tokens
VLM_PREFIX = 256


def _meta(shape: Sequence[int], dtype: torch.dtype, mesh,
          axes: Sequence[Optional[str]], rules: Optional[dict]
          ) -> torch.Tensor:
    """A meta tensor of ``shape``; with a mesh a DTensor laid out by
    ``axes`` whose local shard is this rank's."""
    shape = tuple(shape)
    if mesh is None:
        return torch.empty(shape, dtype=dtype, device="meta")
    from torch.distributed.tensor import DTensor
    sh = L.sharding_for(mesh, axes, shape, rules)
    local = torch.empty(sh.local_shape(shape), dtype=dtype, device="meta")
    return DTensor.from_local(local, sh.device_mesh, sh.placements,
                              run_check=False, shape=shape,
                              stride=torch.empty(shape, device="meta")
                              .stride())


def _dtype(name: str) -> torch.dtype:
    return getattr(torch, name)


def train_batch_specs(cfg: ModelConfig, shape: InputShape, mesh,
                      rules: Optional[dict]) -> Dict[str, Any]:
    B, S = shape.global_batch, shape.seq_len
    batch: Dict[str, Any] = {}
    tok_axes = ("batch", None)
    if cfg.frontend.kind == "vision":
        P_ = VLM_PREFIX
        batch["prefix"] = _meta((B, P_, cfg.d_model), _dtype(cfg.dtype),
                                mesh, ("batch", None, None), rules)
        S = S - P_
    elif cfg.is_encdec:
        batch["frames"] = _meta((B, cfg.encoder_seq, cfg.d_model),
                                _dtype(cfg.dtype), mesh,
                                ("batch", None, None), rules)
    batch["tokens"] = _meta((B, S), torch.int32, mesh, tok_axes, rules)
    batch["labels"] = _meta((B, S), torch.int32, mesh, tok_axes, rules)
    return batch


def _laid_out(tree, axes_tree, mesh, rules):
    """Each meta leaf of ``tree`` laid out by its axes (a leaf whose axes
    do not match its rank is replicated, as ``repro`` does)."""
    def one(x, ax):
        if not (isinstance(ax, tuple) and len(ax) == x.dim()):
            ax = (None,) * x.dim()
        return _meta(x.shape, x.dtype, mesh, ax, rules)
    return D.map_state(one, tree, axes_tree)


def state_specs(cfg: ModelConfig, ocfg: OptimizerConfig, mesh,
                rules: Optional[dict]):
    """The train state: params, optimizer state, step."""
    return _laid_out(D.state_shapes(cfg, ocfg),
                     D.state_logical_axes(cfg, ocfg), mesh, rules)


def alive_spec(mesh) -> torch.Tensor:
    g = D.num_groups(mesh) if mesh is not None else 1
    return torch.empty((g,), dtype=torch.float32, device="meta")


def decode_specs(cfg: ModelConfig, shape: InputShape, mesh,
                 rules: Optional[dict], long_context: bool = False
                 ) -> Dict[str, Any]:
    """``tokens`` (B, 1), ``cache`` and ``position``: a 0-d int32 stand-in,
    ``repro``'s; the port's decode step takes the position as a host
    int."""
    B = shape.global_batch
    cs = cache_shape(cfg, B, shape.seq_len, long_context)
    return {"tokens": _meta((B, 1), torch.int32, mesh, ("batch", None),
                            rules),
            "cache": _laid_out(cs, cache_logical_axes(cs), mesh, rules),
            "position": torch.empty((), dtype=torch.int32, device="meta")}


def prefill_specs(cfg: ModelConfig, shape: InputShape, mesh,
                  rules: Optional[dict]) -> Dict[str, Any]:
    return train_batch_specs(cfg, shape, mesh, rules)


def params_specs(cfg: ModelConfig, mesh, rules: Optional[dict]):
    return _laid_out(T.init_params(None, cfg, "meta"),
                     D.params_logical_axes(cfg), mesh, rules)
