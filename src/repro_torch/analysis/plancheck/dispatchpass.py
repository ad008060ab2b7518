"""The dispatch pass: one round of each bucket of a plan, on the meta device.

The port's counterpart of ``repro.analysis.plancheck.jaxprpass``.  Where
``repro`` lowers each bucket's executable at its plan-predicted shapes
and walks the jaxpr, the port runs one round of the bucket's loop
(``campaign.one_round``: ``rounds=1``, the final scores included) on
zeros of the shapes :func:`repro_torch.core.experiment._bucket_shapes`
predicts, on the meta device, which allocates and computes nothing, under
:class:`~repro_torch.analysis.plancheck.budgets.OpCounter`:

``PC-TORCH-SYNC``
    An op that makes the host wait on the device's data
    (``aten._local_scalar_dense`` behind ``.item()`` / ``int(t)``,
    indexing with a boolean mask, a copy to the CPU), reported
    at the line of ``src/repro_torch`` that asked.  Inside a round it
    stalls the card every round.
``PC-TORCH-BUDGET``
    The round's op count against the bucket's named budget
    (:func:`~repro_torch.analysis.plancheck.budgets.bucket_budget_name`),
    and the same round at one scenario: a count that differs grows with
    the scenario axis S.

An op with no meta kernel makes the pass run that bucket on the CPU
instead, at S = 1 and 2 (the shapes otherwise the plan's), and name the
op in the report (:class:`~repro_torch.analysis.plancheck.findings.
BucketOps`).
"""
from __future__ import annotations

from typing import List, Optional, Tuple

import torch

from repro_torch.analysis.plancheck import budgets as _budgets
from repro_torch.analysis.plancheck.findings import (BucketOps, Finding,
                                                     Report, finding)


class NoKernel(NotImplementedError):
    """An op with no kernel on the device the round ran on (``op``)."""

    def __init__(self, op: str):
        super().__init__(f"{op} has no kernel on this device")
        self.op = op


def round_ops(data, bucket, cells, device: str = "meta",
              scenarios: Optional[int] = None) -> int:
    """The aten ops one round of ``bucket`` dispatches on ``device`` at
    its predicted shapes (``scenarios`` overrides the chunk); raises
    :class:`~repro_torch.analysis.plancheck.budgets.HostSync` at a host
    sync and :class:`NoKernel` at an op with no kernel there."""
    from repro_torch.core import campaign as _c
    from repro_torch.core import experiment as _x
    dev = torch.device(device)
    layout = _c.spec_layout(data.model)
    ops = _c.zero_operands(_x._bucket_shapes(data, bucket, cells,
                                             scenarios), dev)
    counter = _budgets.OpCounter()
    try:
        with counter:
            _c.one_round(data.model, bucket.key_cfg, layout, ops,
                         _x.bucket_k(bucket), bucket.track_iso)
    except NotImplementedError as e:
        raise NoKernel(counter.last) from e
    return counter.count


def _bucket_counts(data, bucket, cells) -> Tuple[int, int, str, str]:
    """(ops at the plan's S, ops at the other S, device, op with no meta
    kernel): on meta at the plan's chunk and at S = 1, or on the CPU at
    S = 2 and 1 when meta cannot run the round."""
    try:
        return (round_ops(data, bucket, cells),
                round_ops(data, bucket, cells, scenarios=1), "meta", "")
    except NoKernel as e:
        op = e.op
    return (round_ops(data, bucket, cells, "cpu", scenarios=2),
            round_ops(data, bucket, cells, "cpu", scenarios=1), "cpu", op)


def check_plan(plan, data=None, budgets: bool = True) -> Report:
    """The dispatch pass over every bucket of an ``ExecutionPlan``: its
    findings, and one :class:`BucketOps` a bucket whose round ran."""
    data = data or plan.spec.data
    family = getattr(data.model, "budget_family", "ae")
    out: List[Finding] = []
    counts: List[BucketOps] = []
    for bucket in plan.buckets:
        cells = [plan.cells[i] for i in bucket.cell_indices]
        where = (f"bucket {bucket.index} ({bucket.kind}"
                 f"{' fused' if bucket.fused else ''})")
        file = f"plan://bucket{bucket.index}"
        try:
            n, n_other, device, no_meta = _bucket_counts(data, bucket, cells)
        except _budgets.HostSync as e:
            out.append(finding(
                "PC-TORCH-SYNC", e.file or file, e.line,
                f"{where}: {e.op} inside a round — the host waits on the "
                f"card every round",
                hint="keep the value on the device (torch.where, masks "
                     "that multiply, gathers) and copy to the host once, "
                     "after the loop",
                tag=f"{e.op}"))
            continue
        name = _budgets.bucket_budget_name(bucket.kind, bucket.fused, family)
        budget = _budgets.BUDGETS.get(name)
        counts.append(BucketOps(bucket.index, name, n,
                                budget.max_ops if budget else 0, device,
                                no_meta))
        if n != n_other:
            out.append(finding(
                "PC-TORCH-BUDGET", file, 0,
                f"{where}: {n} aten ops a round at S = "
                f"{bucket.chunk if device == 'meta' else 2}, {n_other} at "
                f"S = 1: the round's dispatch grows with the scenario axis",
                hint="run the scenarios as one leading tensor axis, not a "
                     "Python loop",
                tag=f"{name}:scenarios"))
        if budgets:
            b = _budgets.check_budget(name, n, where=where, file=file)
            if b is not None:
                out.append(b)
    return Report(findings=out, buckets=counts)
