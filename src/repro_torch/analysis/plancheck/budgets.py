"""Named op-count budgets for the port's round loops and score core.

Port of ``repro.analysis.plancheck.budgets``.  ``repro`` bounds the
equations of each traced core's jaxpr, which sets its compile time.  The
port's cores run eagerly, so their counterpart is the number of aten ops
one call dispatches (:class:`OpCounter`, a ``TorchDispatchMode``), which
sets the host's dispatch time: a round loop is host-bound where its ops
are small.  The guarded regression class is the same: a count that
starts scaling with a knob that used to be shape-only (an unrolled
Python fold over ``max_events``, a loop over scenarios).

* :data:`BUDGETS` names every guarded core and its ceiling;
* :func:`op_count` measures a callable (on the meta device nothing
  executes, and a host sync raises :class:`HostSync`);
* :func:`check_budget` turns a breach into a ``PC-TORCH-BUDGET``
  finding; :func:`constant_across` pins the O(1)-in-knob property
  (``trace_alive_mask`` across ``max_events``, a round across the
  scenario count S).

On the CPU and on the meta device the kernel wrappers run their plain
versions, so the counts are those of the plain path: the fused round
update's plain version loops over the k clusters and the scan's over the
sequence, where the card launches one kernel each.  Budget values are
ceilings with about 2x headroom over the counts measured when they were
set (``tests/test_torch_plancheck.py`` measures them); they catch the
class of regression, not exact counts.
"""
from __future__ import annotations

import os
import sys
from dataclasses import dataclass
from typing import Callable, Dict, Optional, Sequence

import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch.analysis.plancheck.findings import Finding, finding

#: aten ops that make the host wait on the device's data (with a
#: boolean index, indexing does too: :func:`_is_sync`)
SYNC_OPS = frozenset({"aten::_local_scalar_dense", "aten::nonzero",
                      "aten::masked_select", "aten::_unique2",
                      "aten::unique_dim", "aten::unique_consecutive",
                      "aten::item"})
_PACKAGE = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))           # src/repro_torch
_HERE = os.path.dirname(os.path.abspath(__file__))


@dataclass(frozen=True)
class Budget:
    """One named ceiling on the aten ops a core dispatches."""
    name: str
    max_ops: int
    note: str = ""


#: the named budgets: aten ops one call dispatches, about 2x the counts
#: measured on the meta device at the paper's widths (Comms-ML 112
#: features, 10 devices, the paper autoencoder or ``SeqDetector()``;
#: ``tests/test_torch_plancheck.py`` re-measures them at small widths)
BUDGETS: Dict[str, Budget] = {
    b.name: b for b in (
        Budget("trace_alive_mask", 30,
               "O(1) in max_events: one masked reduction over the slots, "
               "never a per-slot where chain (measured 14)"),
        Budget("trace_faulty_scale", 30,
               "the faulty channel's reader, same O(1)-in-max_events "
               "shape (measured 15)"),
        Budget("campaign_core_single", 2200,
               "single-model bucket run per cell, one round (measured 521 "
               "for a batch cell; a per-cell tolfl bucket counts as a "
               "fused one)"),
        Budget("campaign_core_single_fused", 2200,
               "fused single-model bucket, one round (measured 1,062 at "
               "k_pad = 10, where the plain round update loops over the "
               "10 clusters; 1,074 for fl with its isolated fallback)"),
        Budget("campaign_core_multi", 2800,
               "multi-model bucket, one round (measured 1,392 for "
               "FedGroup's k-means at M = 3; IFCA 575, FeSEM 678)"),
        Budget("campaign_core_single:seq", 3200,
               "single-model bucket with the RG-LRU body, one round "
               "(measured 852 for a batch cell)"),
        Budget("campaign_core_single_fused:seq", 3200,
               "fused single-model bucket with the RG-LRU body (measured "
               "1,393 at k_pad = 10; 1,565 for fl), the plain scan a "
               "loop over the 7 windows"),
        Budget("campaign_core_multi:seq", 3800,
               "multi-model bucket with the RG-LRU body (measured 1,894 "
               "for FedGroup; IFCA 967, FeSEM 1,190)"),
        Budget("serving_score_core", 120,
               "the service's bank-row gather + score core, autoencoder "
               "body (measured 58, constant across bucket / window / "
               "bank rows)"),
        Budget("serving_score_core:seq", 280,
               "the same core with the RG-LRU body (measured 139)"),
    )
}


class HostSync(RuntimeError):
    """An op that waits on the device's data, asked for at ``file``:``line``
    (the innermost line of ``src/repro_torch`` outside plancheck)."""

    def __init__(self, op: str, file: str, line: int):
        super().__init__(f"{op} at {file}:{line}")
        self.op, self.file, self.line = op, file, line


def _caller() -> tuple:
    """(path relative to the repo root, line) of the innermost frame in
    ``src/repro_torch`` outside this package: the line that asked."""
    frame = sys._getframe(1)
    while frame is not None:
        path = os.path.abspath(frame.f_code.co_filename)
        if path.startswith(_PACKAGE) and not path.startswith(_HERE):
            rel = os.path.relpath(path, os.path.dirname(
                os.path.dirname(_PACKAGE)))
            return rel.replace(os.sep, "/"), frame.f_lineno
        frame = frame.f_back
    return "", 0


#: indexing ops whose boolean index tensors become a data-dependent shape
_MASK_INDEXING = frozenset({"aten::index.Tensor", "aten::index_put",
                            "aten::index_put_", "aten::_index_put_impl_"})


def _is_sync(func, args, kwargs) -> bool:
    if func.name() in SYNC_OPS:
        return True
    if func.name() in _MASK_INDEXING:
        return any(i is not None and i.dtype in (torch.bool, torch.uint8)
                   for i in args[1])
    if func.name() == "aten::_to_copy":
        dst = kwargs.get("device")
        return (dst is not None and torch.device(dst).type == "cpu"
                and args[0].device.type != "cpu")
    if func.name() == "aten::copy_":
        return args[0].device.type == "cpu" and args[1].device.type != "cpu"
    return False


class OpCounter(TorchDispatchMode):
    """Counts the aten ops dispatched inside it (autograd's backward ops
    included).  An op that makes the host wait on the device's data
    raises :class:`HostSync` before it runs; ``last`` is the op last
    dispatched (the one that raised, when a call fails)."""

    def __init__(self):
        super().__init__()
        self.count = 0
        self.last = ""

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        self.count += 1
        self.last = func.name()
        if _is_sync(func, args, kwargs):
            raise HostSync(func.name(), *_caller())
        return func(*args, **kwargs)


def op_count(fn: Callable, *args, **kwargs) -> int:
    """The aten ops ``fn(*args, **kwargs)`` dispatches."""
    with OpCounter() as counter:
        fn(*args, **kwargs)
    return counter.count


def check_budget(name: str, count: int, where: str = "",
                 file: str = "", line: int = 0) -> Optional[Finding]:
    """None when ``count`` fits the named budget, else a
    ``PC-TORCH-BUDGET`` finding.  An UNKNOWN name is itself a finding: a
    detector family without a declared ceiling runs unguarded."""
    budget = BUDGETS.get(name)
    if budget is None:
        return finding(
            "PC-TORCH-BUDGET", file or where or name, line,
            f"{where or name}: no named budget {name!r} — this core "
            f"runs unguarded",
            hint=("declare a Budget in plancheck.budgets.BUDGETS for "
                  "this detector family (ceiling ~2x the measured op "
                  "count)"),
            tag=name)
    if count <= budget.max_ops:
        return None
    loc = where or name
    return finding(
        "PC-TORCH-BUDGET", file or loc, line,
        f"{loc}: {count} aten ops > budget {budget.max_ops} "
        f"({budget.name})",
        hint=(budget.note or "find the knob the count started scaling "
              "with and move it into tensor shapes"),
        tag=name)


def constant_across(make_count: Callable[[int], int],
                    values: Sequence[int]) -> bool:
    """True iff the count is identical across every knob value — the
    O(1)-in-knob property (``make_count(v)`` measures at knob v)."""
    return len({make_count(v) for v in values}) == 1


def bucket_budget_name(kind: str, fused: bool, family: str = "ae") -> str:
    """The budget governing one experiment bucket: ``repro``'s names,
    suffixed with the detector's ``budget_family`` unless it is "ae"."""
    if kind == "multi":
        base = "campaign_core_multi"
    else:
        base = ("campaign_core_single_fused" if fused
                else "campaign_core_single")
    return base if family == "ae" else f"{base}:{family}"
