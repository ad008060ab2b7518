"""Failure model (paper Section II / IV-B) and timed failure traces.

Port of ``repro.core.failure``.  An ``alive`` mask is computed on the
device each round from a fixed-shape :class:`FailureTrace`, and
per-device effective weights are derived from it, so the round loop
never waits on the host.  Traces stack on a leading scenario axis
(:func:`stack_traces`, :func:`concat_traces`): the masks then come out
one row per scenario, which is what lets :mod:`repro_torch.core.campaign`
run a whole (trace x seed) grid through one round loop.  The Monte-Carlo
samplers (:func:`sample_traces`, :func:`sample_rate_grid`) are host numpy
and draw from the caller's ``np.random.Generator`` in ``repro``'s order,
so they give ``repro``'s traces byte for byte.

Semantics (paper IV-B):
* dead member  -> its samples leave the weighted mean; cluster continues.
* dead head    -> the entire cluster leaves training (worst case).
* FL (k=1) head death == server death -> no aggregation is possible; the
  engine falls back to isolated local training (paper Section V-C).
* recovery (churn) -> a later event may bring a device back; the most
  recent event targeting a device wins.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Sequence, Union

import numpy as np
import torch

from repro_torch import DeviceLike, resolve_device
from repro_torch.core.topology import Topology

#: default number of event slots in a trace (fixed shape)
MAX_EVENTS = 8
#: sentinel epoch for unused event slots — never fires
PAD_EPOCH = 1 << 30
#: event-kind codes carried in the trace arrays.  "faulty" events
#: (corrupted updates) live on a SHADOW device range [N, 2N) with the
#: delta scale in the alive_after channel: alive masks never match them,
#: only :func:`trace_faulty_scale` reads them.
KIND_CODES = {"none": 0, "client": 1, "server": 2, "faulty": 3}


@dataclass(frozen=True)
class FailureSpec:
    """A single failure event injected during training (legacy form)."""
    epoch: int                 # fires at the START of this epoch/round
    kind: str                  # "client" | "server" | "none"
    device: Optional[int] = None   # explicit device id; defaults per kind

    def target(self, topo: Topology) -> int:
        if self.device is not None:
            return self.device
        if self.kind == "server":
            return topo.heads[0]          # a cluster head (the FL server)
        # a non-head member: last member of cluster 0 (or device 0 if all
        # devices are heads, i.e. SBT)
        c0 = topo.clusters[0]
        return c0[-1] if len(c0) > 1 else c0[0]


NO_FAILURE = FailureSpec(epoch=PAD_EPOCH, kind="none")


@dataclass(frozen=True)
class FailureEvent:
    """One timed event of a :class:`FailureTrace`."""
    epoch: int
    kind: str                      # "client" | "server"
    device: Optional[int] = None   # explicit device id; defaults per kind
    recover: bool = False          # True -> the device comes back

    def target(self, topo: Topology) -> int:
        return FailureSpec(self.epoch, self.kind, self.device).target(topo)


@dataclass(frozen=True)
class FailureTrace:
    """Up to M timed events as fixed-shape tensors on one device.

    Events are stored sorted by epoch (stable); unused slots carry
    ``PAD_EPOCH`` / device -1 and never match.  ``alive_after[j]`` is the
    device's state once event j fires (0 = dead, 1 = recovered).  A
    stacked trace (:func:`stack_traces`) has (S, M) fields, one row a
    scenario."""
    epochs: torch.Tensor       # (M,) int32
    devices: torch.Tensor      # (M,) int32, -1 in padding slots
    alive_after: torch.Tensor  # (M,) float32
    kinds: torch.Tensor        # (M,) int32 KIND_CODES

    @property
    def max_events(self) -> int:
        return self.epochs.shape[-1]

    def to(self, device: torch.device) -> "FailureTrace":
        return FailureTrace(self.epochs.to(device), self.devices.to(device),
                            self.alive_after.to(device),
                            self.kinds.to(device))

    @staticmethod
    def none(max_events: int = MAX_EVENTS, device: DeviceLike = None
             ) -> "FailureTrace":
        dev = resolve_device(device)
        return FailureTrace(
            epochs=torch.full((max_events,), PAD_EPOCH, dtype=torch.int32,
                              device=dev),
            devices=torch.full((max_events,), -1, dtype=torch.int32,
                               device=dev),
            alive_after=torch.ones((max_events,), dtype=torch.float32,
                                   device=dev),
            kinds=torch.zeros((max_events,), dtype=torch.int32, device=dev))

    @classmethod
    def from_events(cls, events: Sequence[FailureEvent], topo: Topology,
                    max_events: int = MAX_EVENTS, device: DeviceLike = None
                    ) -> "FailureTrace":
        """Build a trace; events are stably sorted by epoch, so events
        that target the same device AT THE SAME epoch apply in their
        list order — the LAST-listed one wins."""
        dev = resolve_device(device)
        events = [e for e in events if e.kind != "none"]
        assert len(events) <= max_events, (len(events), max_events)
        events = sorted(events, key=lambda e: e.epoch)   # stable
        ep = np.full((max_events,), PAD_EPOCH, np.int32)
        dv = np.full((max_events,), -1, np.int32)
        alv = np.ones((max_events,), np.float32)
        knd = np.zeros((max_events,), np.int32)
        for j, e in enumerate(events):
            ep[j] = e.epoch
            dv[j] = e.target(topo)
            alv[j] = 1.0 if e.recover else 0.0
            knd[j] = KIND_CODES[e.kind]
        return cls(*(torch.from_numpy(a).to(dev) for a in (ep, dv, alv, knd)))

    @classmethod
    def from_spec(cls, spec: FailureSpec, topo: Topology,
                  max_events: int = MAX_EVENTS, device: DeviceLike = None
                  ) -> "FailureTrace":
        if spec.kind == "none":
            return cls.none(max_events, device)
        ev = FailureEvent(spec.epoch, spec.kind, spec.device)
        return cls.from_events([ev], topo, max_events, device)


Failure = Union[FailureSpec, FailureTrace]
_FIELDS = ("epochs", "devices", "alive_after", "kinds")


def as_trace(failure: Failure, topo: Topology, max_events: int = MAX_EVENTS,
             device: DeviceLike = None) -> FailureTrace:
    """Normalise either failure encoding to a trace on ``device``."""
    if isinstance(failure, FailureTrace):
        return failure.to(resolve_device(device))
    return FailureTrace.from_spec(failure, topo, max_events, device)


def stack_traces(traces: Sequence[FailureTrace]) -> FailureTrace:
    """Stack same-shape traces on a leading scenario axis: (S, M) fields."""
    if not traces:
        raise ValueError("stack_traces: empty trace list — a batch "
                         "needs at least one trace")
    ms = {t.max_events for t in traces}
    assert len(ms) == 1, f"mixed max_events: {ms}"
    return FailureTrace(*(torch.stack([getattr(t, f) for t in traces])
                          for f in _FIELDS))


def concat_traces(batches: Sequence[FailureTrace]) -> FailureTrace:
    """Concatenate already-stacked trace batches along their leading
    scenario axis — the fused (cell x trace x seed) sweep flattens the
    per-cell batches of a grid into one with this (the batches must
    share ``max_events``)."""
    if not batches:
        raise ValueError("concat_traces: empty batch list — nothing to "
                         "concatenate")
    ms = {t.max_events for t in batches}
    assert len(ms) == 1, f"mixed max_events: {ms}"
    if len(batches) == 1:
        return batches[0]
    return FailureTrace(*(torch.cat([getattr(t, f) for t in batches])
                          for f in _FIELDS))


def sample_traces(rng: np.random.Generator, topo: Topology,
                  failure_rate: float, max_events: int = MAX_EVENTS,
                  rounds: int = 100, num_traces: int = 1,
                  recover_prob: float = 0.5, device: DeviceLike = None
                  ) -> list:
    """Random multi-event failure-and-recovery traces (Section IV-B).

    Each of ``num_traces`` traces: every device independently fails with
    probability ``failure_rate`` at a uniform random epoch in ``[0,
    rounds)`` (a *server* event for a cluster head of ``topo``, else a
    *client* event) and, with probability ``recover_prob``, comes back at
    a later uniform epoch.  Devices are visited in a shuffled order and
    events beyond ``max_events`` slots are dropped; near the budget a
    failure whose recovery no longer fits keeps the failure and drops
    the recovery, so either every failed device appears or every slot is
    used.  The draws from ``rng`` are ``repro``'s, in its order
    (``random``, ``shuffle``, then per device ``integers``, ``random``
    and, for a recovery, ``integers``), so the traces equal ``repro``'s
    byte for byte.  Returns a list of :class:`FailureTrace` on
    ``device``."""
    assert 0.0 <= failure_rate <= 1.0, failure_rate
    assert rounds >= 1 and max_events >= 1
    head_set = set(topo.heads)
    traces = []
    for _ in range(num_traces):
        failed = np.flatnonzero(
            rng.random(topo.num_devices) < failure_rate)
        rng.shuffle(failed)
        events: list = []
        for d in failed:
            kind = "server" if int(d) in head_set else "client"
            epoch = int(rng.integers(rounds))
            recovers = (rng.random() < recover_prob) and epoch + 1 < rounds
            free = max_events - len(events)
            if free <= 0:
                continue
            if recovers and free < 2:
                recovers = False   # keep the failure, drop the recovery
            events.append(FailureEvent(epoch, kind, device=int(d)))
            if recovers:
                rec = int(rng.integers(epoch + 1, rounds))
                events.append(FailureEvent(rec, kind, device=int(d),
                                           recover=True))
        traces.append(FailureTrace.from_events(events, topo, max_events,
                                               device))
    return traces


def _trace_key(t: FailureTrace) -> tuple:
    return tuple(leaf.cpu().numpy().tobytes()
                 for leaf in (t.epochs, t.devices, t.alive_after, t.kinds))


def sample_rate_grid(rng: np.random.Generator, topo: Topology,
                     p_grid: Sequence[float], rounds: int,
                     traces_per_p: int, max_events: Optional[int] = None,
                     recover_prob: float = 0.5,
                     base_traces: Sequence[FailureTrace] = (),
                     device: DeviceLike = None):
    """Sampled traces for a failure-rate sweep, deduplicated.

    Draws ``traces_per_p`` scenarios per rate via :func:`sample_traces`
    and collapses byte-identical traces to one.  ``max_events`` defaults
    to ``2 * topo.num_devices`` (every device may fail and recover).
    ``base_traces`` (already at ``max_events``) come first and join the
    dedup.  Returns ``(traces, draws)``: the traces on ``device``, and
    ``draws[p]``, one trace index per original draw (a duplicated draw
    repeats its index, so per-p means over those indices equal the
    undeduplicated Monte-Carlo estimate)."""
    if max_events is None:
        max_events = 2 * topo.num_devices
    dev = resolve_device(device)
    traces: list = []
    draws: dict = {}
    idx_of: dict = {}
    for t in base_traces:
        assert t.max_events == max_events, (t.max_events, max_events)
        idx_of.setdefault(_trace_key(t), len(traces))
        traces.append(t.to(dev))
    for p in p_grid:
        idxs = []
        for t in sample_traces(rng, topo, p, max_events=max_events,
                               rounds=rounds, num_traces=traces_per_p,
                               recover_prob=recover_prob, device="cpu"):
            key = _trace_key(t)
            if key not in idx_of:
                idx_of[key] = len(traces)
                traces.append(t.to(dev))
            idxs.append(idx_of[key])
        draws[p] = idxs
    return traces, draws


def _last_fired(trace: FailureTrace, targets: torch.Tensor,
                epoch) -> torch.Tensor:
    """``alive_after`` of the HIGHEST-indexed fired slot per target (1.0
    where none fired), for a trace of (M,) or stacked (S, M) fields:
    (N,) or (S, N).  Events are epoch-sorted (stably), so that slot is
    the most recent event; one reversed argmax finds it.  ``argmax``
    takes no bool (cast to int32) and returns the FIRST maximal index,
    so on the reversed axis it is the last fired slot, which keeps the
    same-epoch list-order tie-break."""
    fired = ((trace.epochs <= epoch)[..., :, None]          # (..., M, N)
             & (trace.devices[..., :, None] == targets))
    any_fired = torch.any(fired, dim=-2)                    # (..., N)
    last = (trace.max_events - 1) - torch.argmax(
        torch.flip(fired, (-2,)).to(torch.int32), dim=-2)
    return torch.where(any_fired, torch.gather(trace.alive_after, -1, last),
                       torch.ones((), dtype=torch.float32,
                                  device=targets.device))


def trace_alive_mask(trace: FailureTrace, num_devices: int, epoch
                     ) -> torch.Tensor:
    """(num_devices,) float alive mask at ``epoch`` (an int or a 0-d
    tensor), computed on the trace's device; (S, num_devices) for a
    stacked trace."""
    return _last_fired(trace, torch.arange(num_devices,
                                           device=trace.epochs.device), epoch)


def trace_faulty_scale(trace: FailureTrace, num_devices: int, epoch
                       ) -> torch.Tensor:
    """(num_devices,) per-device delta scale at ``epoch``; (S,
    num_devices) for a stacked trace.

    Kind-3 events target shadow device ids ``N + d`` and carry the
    transmitted-delta scale in ``alive_after`` (1.0 = clean); the same
    last-event-wins rule as :func:`trace_alive_mask`."""
    return _last_fired(trace, num_devices + torch.arange(
        num_devices, device=trace.epochs.device), epoch)


def alive_mask(failure: Failure, topo: Topology, epoch,
               device: DeviceLike = None) -> torch.Tensor:
    """(N,) float mask of devices still alive at ``epoch``."""
    n = topo.num_devices
    dev = resolve_device(device)
    if isinstance(failure, FailureTrace):
        return trace_alive_mask(failure.to(dev), n, epoch)
    if failure.kind == "none":
        return torch.ones((n,), dtype=torch.float32, device=dev)
    tgt = failure.target(topo)
    dead = (torch.arange(n, device=dev) == tgt) & (epoch >= failure.epoch)
    return (~dead).to(torch.float32)


def effective_weights(alive: torch.Tensor, topo: Topology) -> torch.Tensor:
    """(N,) per-device weight given head-failure semantics, on ``alive``'s
    device: :func:`effective_weights_arrays` with ``topo``'s clusters."""
    cluster_ids = torch.from_numpy(topo.device_cluster_array()).to(
        alive.device)
    heads = torch.tensor(topo.heads, dtype=torch.int64, device=alive.device)
    return effective_weights_arrays(alive, cluster_ids, heads)


def surviving_fraction(alive, topo: Topology) -> float:
    """Mean effective weight: the share of devices still training."""
    a = torch.as_tensor(np.asarray(alive), dtype=torch.float32)
    return float(torch.mean(effective_weights(a, topo)))


def effective_weights_arrays(alive: torch.Tensor, cluster_ids: torch.Tensor,
                             heads: torch.Tensor) -> torch.Tensor:
    """Per-device weight given head-failure semantics:
    ``w_i = alive_i * alive_{head(cluster(i))}`` — a dead head zeroes its
    whole cluster; dead members zero only themselves.  ``alive`` and
    ``cluster_ids`` are (N,) or (S, N), ``heads`` (k,) or (S, k) (int64,
    possibly padded past the real cluster count: padded slots are only
    reachable through ``cluster_ids``, which never names one)."""
    head_alive = torch.gather(alive, -1, heads)             # (..., k)
    return alive * torch.gather(head_alive, -1, cluster_ids)
