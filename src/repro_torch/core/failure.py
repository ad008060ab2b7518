"""Failure model (paper Section II / IV-B) and timed failure traces.

Port of ``repro.core.failure``, the parts the round loop needs.  An
``alive`` mask is computed on the device each round from a
fixed-shape :class:`FailureTrace`, and per-device effective weights are
derived from it, so the round loop never waits on the host.

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
    device's state once event j fires (0 = dead, 1 = recovered)."""
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


def as_trace(failure: Failure, topo: Topology, max_events: int = MAX_EVENTS,
             device: DeviceLike = None) -> FailureTrace:
    """Normalise either failure encoding to a trace on ``device``."""
    if isinstance(failure, FailureTrace):
        return failure.to(resolve_device(device))
    return FailureTrace.from_spec(failure, topo, max_events, device)


def _last_fired(trace: FailureTrace, targets: torch.Tensor,
                epoch) -> torch.Tensor:
    """``alive_after`` of the HIGHEST-indexed fired slot per target (1.0
    where none fired).  Events are epoch-sorted (stably), so that slot is
    the most recent event; one reversed argmax finds it.  ``argmax``
    takes no bool (cast to int32) and returns the FIRST maximal index,
    so on the reversed axis it is the last fired slot, which keeps the
    same-epoch list-order tie-break."""
    fired = ((trace.epochs <= epoch)[:, None]               # (M, N)
             & (trace.devices[:, None] == targets[None, :]))
    any_fired = torch.any(fired, dim=0)                     # (N,)
    last = (trace.max_events - 1) - torch.argmax(
        torch.flip(fired, (0,)).to(torch.int32), dim=0)
    return torch.where(any_fired, trace.alive_after[last],
                       torch.ones((), dtype=torch.float32,
                                  device=targets.device))


def trace_alive_mask(trace: FailureTrace, num_devices: int, epoch
                     ) -> torch.Tensor:
    """(num_devices,) float alive mask at ``epoch`` (an int or a 0-d
    tensor), computed on the trace's device."""
    return _last_fired(trace, torch.arange(num_devices,
                                           device=trace.epochs.device), epoch)


def trace_faulty_scale(trace: FailureTrace, num_devices: int, epoch
                       ) -> torch.Tensor:
    """(num_devices,) per-device delta scale at ``epoch``.

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


def effective_weights_arrays(alive: torch.Tensor, cluster_ids: torch.Tensor,
                             heads: torch.Tensor) -> torch.Tensor:
    """(N,) per-device weight given head-failure semantics:
    ``w_i = alive_i * alive_{head(cluster(i))}`` — a dead head zeroes its
    whole cluster; dead members zero only themselves."""
    head_alive = alive[heads]                     # (k,)
    return alive * head_alive[cluster_ids]
