"""Roofline terms of a dry-run record, and the collective counter that
reads a step's collectives off its dispatch trace.

Port of ``repro.analysis.roofline``.  Three terms per (arch x shape x
mesh), seconds:

    compute    = FLOPs_per_chip / peak_FLOP/s
    memory     = bytes_per_chip / HBM_bw
    collective = collective_bytes_per_chip / link_bw

Hardware constants: the NVIDIA H100 SXM5 80GB datasheet's, not
measurements: 989e12 FLOP/s dense bf16 (tensor cores, no sparsity),
3.35e12 B/s HBM3, and NVLink 4 at 900 GB/s a GPU in both directions,
450e9 B/s a direction.

Where ``repro`` parses the post-SPMD HLO text for its collectives, the
port counts them on its own step as it runs (:class:`CollectiveCounter`,
a ``TorchDispatchMode``): every ``c10d`` / ``_c10d_functional``
collective's result bytes on this rank, by ``repro``'s kind names.  The
collectives DTensor inserts inside an op are seen too: the counter lets
DTensor ops through (``NotImplemented``) and counts what they turn into.
``_wrap_tensor_autograd`` (a functional collective's wrapper, the same
bytes again) and the waits are not counted.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Dict, Optional

import torch
from torch.utils._python_dispatch import TorchDispatchMode

PEAK_FLOPS = 989e12          # bf16 dense per GPU, H100 SXM5 datasheet
HBM_BW = 3.35e12             # bytes/s per GPU, HBM3, datasheet
LINK_BW = 450e9              # bytes/s per direction, NVLink 4, datasheet

_COLLECTIVES = ("all-reduce", "all-gather", "reduce-scatter", "all-to-all",
                "collective-permute")

#: op name -> kind, for the ops whose result is their first argument
#: (``c10d``'s in-place collectives and point-to-point ops)
_C10D = {"allreduce_": "all-reduce", "allreduce_coalesced_": "all-reduce",
         "allgather_": "all-gather", "_allgather_base_": "all-gather",
         "allgather_into_tensor_coalesced_": "all-gather",
         "reduce_scatter_": "reduce-scatter",
         "_reduce_scatter_base_": "reduce-scatter",
         "reduce_scatter_tensor_coalesced_": "reduce-scatter",
         "alltoall_": "all-to-all", "alltoall_base_": "all-to-all",
         "send": "collective-permute", "recv_": "collective-permute"}
#: op name -> kind, for the functional ops, whose result is their output
_FUNCTIONAL = {"all_reduce": "all-reduce",
               "all_reduce_coalesced": "all-reduce",
               "all_gather_into_tensor": "all-gather",
               "all_gather_into_tensor_coalesced": "all-gather",
               "reduce_scatter_tensor": "reduce-scatter",
               "reduce_scatter_tensor_coalesced": "reduce-scatter",
               "all_to_all_single": "all-to-all"}


def _bytes(x) -> int:
    if isinstance(x, torch.Tensor):
        return x.numel() * x.element_size()
    if isinstance(x, (list, tuple)):
        return sum(_bytes(y) for y in x)
    return 0


class CollectiveCounter(TorchDispatchMode):
    """Sums this rank's collective result bytes by kind while active.

    Enter it OUTSIDE a ``FlopCounterMode`` (``with CollectiveCounter(),
    FlopCounterMode():``): the flop counter then sees each DTensor op
    once, at its global shapes, and this one the local ops and
    collectives DTensor runs for it."""

    def __init__(self):
        super().__init__()
        self.bytes: Dict[str, int] = {k: 0 for k in _COLLECTIVES}
        self.calls: Dict[str, int] = {k: 0 for k in _COLLECTIVES}

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch.distributed.tensor import DTensor
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented
        out = func(*args, **(kwargs or {}))
        ns = getattr(func, "namespace", "")
        name = getattr(func, "_opname", "")
        kind = n = None
        if ns == "c10d" and name in _C10D:
            kind, n = _C10D[name], _bytes(args[0])
        elif ns == "_c10d_functional" and name in _FUNCTIONAL:
            kind, n = _FUNCTIONAL[name], _bytes(out)
        if kind is not None:
            self.bytes[kind] += n
            self.calls[kind] += 1
        return out


@dataclass
class Roofline:
    arch: str
    shape: str
    mesh: str
    chips: int
    flops_per_chip: float
    bytes_per_chip: float
    coll_bytes_per_chip: float
    coll_breakdown: Dict[str, int]
    model_flops: float            # 6 N D (active params) global
    memory_per_device: Optional[float] = None   # per-rank state + batch

    @property
    def t_compute(self) -> float:
        return self.flops_per_chip / PEAK_FLOPS

    @property
    def t_memory(self) -> float:
        return self.bytes_per_chip / HBM_BW

    @property
    def t_collective(self) -> float:
        return self.coll_bytes_per_chip / LINK_BW

    @property
    def bottleneck(self) -> str:
        terms = {"compute": self.t_compute, "memory": self.t_memory,
                 "collective": self.t_collective}
        return max(terms, key=terms.get)

    @property
    def useful_flops_ratio(self) -> float:
        """MODEL_FLOPS / global flops: catches remat / redundancy."""
        glob = self.flops_per_chip * self.chips
        return self.model_flops / glob if glob else float("nan")

    def to_dict(self) -> dict:
        d = dataclasses.asdict(self)
        d.update(t_compute=self.t_compute, t_memory=self.t_memory,
                 t_collective=self.t_collective, bottleneck=self.bottleneck,
                 useful_flops_ratio=self.useful_flops_ratio)
        return d


def model_flops_for(cfg, shape, mode: str) -> float:
    """6 N D for training; 2 N D for inference, D = tokens processed."""
    n_active = cfg.active_param_count()
    if mode == "train":
        toks = shape.global_batch * shape.seq_len
        return 6.0 * n_active * toks
    if mode == "prefill":
        toks = shape.global_batch * shape.seq_len
        return 2.0 * n_active * toks
    # decode: one token per sequence
    return 2.0 * n_active * shape.global_batch


def build_roofline(arch: str, shape_name: str, mesh_name: str, chips: int,
                   global_flops: float, coll: Dict[str, int],
                   model_flops: float, bytes_per_chip: float = 0.0,
                   memory_per_device: Optional[float] = None) -> Roofline:
    """The trace's roofline: ``global_flops`` (``FlopCounterMode``'s, a
    DTensor op at its global shapes) over the chips, ``coll`` a rank's
    :class:`CollectiveCounter` bytes."""
    return Roofline(
        arch=arch, shape=shape_name, mesh=mesh_name, chips=chips,
        flops_per_chip=float(global_flops) / chips,
        bytes_per_chip=float(bytes_per_chip),
        coll_bytes_per_chip=float(sum(coll.values())),
        coll_breakdown=dict(coll), model_flops=model_flops,
        memory_per_device=memory_per_device)


def format_table(rows) -> str:
    hdr = (f"{'arch':28s} {'shape':12s} {'mesh':10s} "
           f"{'t_comp(s)':>10s} {'t_mem(s)':>10s} {'t_coll(s)':>10s} "
           f"{'bottleneck':>10s} {'useful':>7s}")
    lines = [hdr, "-" * len(hdr)]
    for r in rows:
        lines.append(
            f"{r.arch:28s} {r.shape:12s} {r.mesh:10s} "
            f"{r.t_compute:10.3e} {r.t_memory:10.3e} {r.t_collective:10.3e} "
            f"{r.bottleneck:>10s} {r.useful_flops_ratio:7.3f}")
    return "\n".join(lines)
