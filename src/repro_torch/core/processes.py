"""Generative failure processes: declarative fault injection.

Port of ``repro.core.processes`` (host numpy; the traces land on the
caller's device).  A :class:`FailureProcess` is a frozen, hashable spec
of a *stochastic failure model* — a distribution over scenarios.  Each
process is a pure host-side sampler ``sample(rng, topo, n_rounds) ->
FailureTrace`` that lowers to the same fixed-shape
:class:`repro_torch.core.failure.FailureTrace` arrays the round loop
already takes.  The families:

* :class:`IidRateProcess` — every device independently fails once at a
  uniform epoch (the :func:`~repro_torch.core.failure.sample_traces`
  sampler, same draws).
* :class:`MarkovChurnProcess` — per-device two-state fail/recover chain:
  bursty outages with geometric up/down times.
* :class:`ClusterCascadeProcess` — a head failure takes its members down
  with probability ``q`` and the cluster staggers back.
* :class:`StragglerProcess` — flaky clients miss a contiguous window of
  rounds via PAIRED failure+recovery events; they never die.
* :class:`FaultyUpdateProcess` — corrupted deltas: marked devices stay
  alive but transmit scaled updates for a window.

Faulty-update lowering: faulty events ride the SAME trace arrays on a
shadow device range ``[N, 2N)`` with kind code ``KIND_CODES["faulty"]``
and the delta scale in the ``alive_after`` channel.  Alive masks never
match a shadow row, so only the faulty-aware engine
(:class:`repro_torch.core.simulate.FaultySimConfig`) reads them, via
:func:`repro_torch.core.failure.trace_faulty_scale`.

Reproducibility: a draw's numpy generator derives from ``(sample_seed,
repr(process), draw index)`` via SHA-256 (:func:`process_seed`), never
Python's salted ``hash``.  The class names, field names, field order
and defaults are ``repro``'s, so ``repr`` — and with it every seed and
every trace — is ``repro``'s byte for byte.

Slot budgets: like ``sample_traces``, samplers degrade near
``max_events`` — device/cluster order is shuffled first and events pack
group-wise so no trace ends on a dangling recovery
(:func:`_pack_groups`); stragglers pack all-or-nothing per device.
"""
from __future__ import annotations

import hashlib
from dataclasses import dataclass
from typing import ClassVar, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch import DeviceLike, resolve_device
from repro_torch.core.failure import (KIND_CODES, PAD_EPOCH, FailureTrace,
                                      _trace_key, sample_traces)
from repro_torch.core.topology import Topology

#: (epoch, device, alive_after/scale, kind_code) — the raw row form the
#: samplers emit; shadow-device and scale-carrying rows have no
#: FailureEvent equivalent, hence this bypass of ``from_events``.
Row = Tuple[int, int, float, int]

#: canonical family names, the order benches/examples sweep them in
FAMILIES = ("iid", "markov", "cascade", "straggler", "faulty")


def trace_from_rows(rows: Sequence[Row], max_events: int,
                    device: DeviceLike = None) -> FailureTrace:
    """Pack raw event rows into a trace on ``device`` (stable epoch
    sort, PAD fill).

    The row form carries device ids and alive/scale values verbatim —
    unlike ``FailureTrace.from_events`` it can express shadow-device
    faulty rows and fractional scales.  Same tie-break contract:
    same-epoch rows apply in list order, the last-listed wins."""
    dev = resolve_device(device)
    assert len(rows) <= max_events, (len(rows), max_events)
    rows = sorted(rows, key=lambda r: r[0])    # stable
    ep = np.full((max_events,), PAD_EPOCH, np.int32)
    dv = np.full((max_events,), -1, np.int32)
    alv = np.ones((max_events,), np.float32)
    knd = np.zeros((max_events,), np.int32)
    for j, (e, d, a, k) in enumerate(rows):
        ep[j], dv[j], alv[j], knd[j] = e, d, a, k
    return FailureTrace(*(torch.from_numpy(a).to(dev)
                          for a in (ep, dv, alv, knd)))


def _pack_groups(groups: Sequence[Sequence[Row]], max_events: int,
                 pairs_only: bool = False) -> List[Row]:
    """Pack per-device/cluster event groups into a slot budget.

    Each group lists one device's (or one cascade's) events with every
    recovery AFTER its failure in list order, so any prefix is a valid
    history — truncating a group keeps the failure and drops only the
    recovery, ``sample_traces``' degradation rule.  With ``pairs_only``
    a group is kept whole or dropped whole (a straggler's window-miss
    must never truncate into a death).  The caller shuffles the group
    order first so truncation is unbiased."""
    rows: List[Row] = []
    for g in groups:
        free = max_events - len(rows)
        if free <= 0:
            break
        if pairs_only:
            if len(g) <= free:
                rows.extend(g)
        else:
            rows.extend(list(g)[:free])
    return rows


@dataclass(frozen=True)
class FailureProcess:
    """Base spec: a pure host-side sampler of failure scenarios.

    Subclasses are frozen hashable dataclasses (their fields ARE the
    process identity — ``repr`` feeds :func:`process_seed`) and override
    :meth:`sample`.  ``needs_faulty_engine`` marks families whose traces
    only take effect under the faulty-aware engine."""
    family: ClassVar[str] = "process"
    needs_faulty_engine: ClassVar[bool] = False

    def default_max_events(self, topo: Topology) -> int:
        """Slot budget when none is given — enough for every device to
        fail and recover once (``sample_rate_grid``'s default)."""
        return 2 * topo.num_devices

    def sample(self, rng: np.random.Generator, topo: Topology,
               n_rounds: int, max_events: Optional[int] = None,
               device: DeviceLike = None) -> FailureTrace:
        raise NotImplementedError


@dataclass(frozen=True)
class IidRateProcess(FailureProcess):
    """Every device independently fails with probability ``p`` at a
    uniform epoch, recovering later with ``recover_prob`` — exactly
    :func:`~repro_torch.core.failure.sample_traces` (byte-identical
    draws given the same generator state), lifted to a process."""
    p: float = 0.2
    recover_prob: float = 0.5
    family: ClassVar[str] = "iid"

    def sample(self, rng, topo, n_rounds, max_events=None, device=None):
        m = max_events or self.default_max_events(topo)
        return sample_traces(rng, topo, self.p, max_events=m,
                             rounds=n_rounds, num_traces=1,
                             recover_prob=self.recover_prob,
                             device=device)[0]


@dataclass(frozen=True)
class MarkovChurnProcess(FailureProcess):
    """Per-device two-state Markov chain: an alive device fails with
    ``p_fail`` per round, a dead one recovers with ``p_recover`` —
    geometric burst lengths, possibly many outages per device.  Each
    device's whole chain is drawn before packing, so slot-budget
    truncation of one device never shifts another's stream."""
    p_fail: float = 0.05
    p_recover: float = 0.25
    family: ClassVar[str] = "markov"

    def default_max_events(self, topo):
        return 4 * topo.num_devices     # room for repeated outages

    def sample(self, rng, topo, n_rounds, max_events=None, device=None):
        m = max_events or self.default_max_events(topo)
        head_set = set(topo.heads)
        order = np.arange(topo.num_devices)
        rng.shuffle(order)
        groups = []
        for d in order:
            kind = KIND_CODES["server" if int(d) in head_set else "client"]
            u = rng.random(n_rounds)
            alive, g = True, []
            for r in range(n_rounds):
                if alive and u[r] < self.p_fail:
                    g.append((r, int(d), 0.0, kind))
                    alive = False
                elif not alive and u[r] < self.p_recover:
                    g.append((r, int(d), 1.0, kind))
                    alive = True
            if g:
                groups.append(g)
        return trace_from_rows(_pack_groups(groups, m), m, device)


@dataclass(frozen=True)
class ClusterCascadeProcess(FailureProcess):
    """Correlated cluster-level outage — the paper's cascade scenario.

    Each cluster's head fails with ``p_head`` at a uniform epoch ``e``
    (a *server* event); each member then cascades down at ``e + 1`` with
    probability ``q`` (client events — they stay dead even if the head
    returns).  With ``recover_prob`` the cluster staggers back: head at
    ``e + recovery_lag``, then members one per ``stagger`` rounds, any
    recovery past the horizon dropped."""
    p_head: float = 0.2
    q: float = 0.9
    recover_prob: float = 0.5
    recovery_lag: int = 5
    stagger: int = 1
    family: ClassVar[str] = "cascade"

    def sample(self, rng, topo, n_rounds, max_events=None, device=None):
        m = max_events or self.default_max_events(topo)
        lag = max(1, int(self.recovery_lag))
        stag = max(1, int(self.stagger))
        order = np.arange(topo.num_clusters)
        rng.shuffle(order)
        groups = []
        for c in order:
            members = topo.clusters[int(c)]
            head = int(members[0])
            if rng.random() >= self.p_head:
                continue
            e = int(rng.integers(n_rounds))
            g = [(e, head, 0.0, KIND_CODES["server"])]
            fell = []
            for d in members[1:]:
                if rng.random() < self.q:
                    g.append((min(e + 1, n_rounds - 1), int(d), 0.0,
                              KIND_CODES["client"]))
                    fell.append(int(d))
            rec = e + lag
            if rng.random() < self.recover_prob and rec < n_rounds:
                g.append((rec, head, 1.0, KIND_CODES["server"]))
                for i, d in enumerate(fell):
                    rr = rec + stag * (i + 1)
                    if rr < n_rounds:
                        g.append((rr, d, 1.0, KIND_CODES["client"]))
            groups.append(g)
        return trace_from_rows(_pack_groups(groups, m), m, device)


@dataclass(frozen=True)
class StragglerProcess(FailureProcess):
    """Flaky clients: with probability ``p`` a device misses a contiguous
    ``window`` of rounds via a PAIRED (fail@e, recover@e+w) — it always
    comes back, never dies.  The window is clipped so recovery lands
    inside the horizon, and packing is all-or-nothing per device: under
    slot pressure a straggler is dropped entirely rather than truncated
    into a permanent death."""
    p: float = 0.3
    window: int = 5
    family: ClassVar[str] = "straggler"

    def sample(self, rng, topo, n_rounds, max_events=None, device=None):
        m = max_events or self.default_max_events(topo)
        if n_rounds < 2:        # no room for a window that returns
            return FailureTrace.none(m, device)
        w = max(1, min(int(self.window), n_rounds - 1))
        head_set = set(topo.heads)
        order = np.arange(topo.num_devices)
        rng.shuffle(order)
        groups = []
        for d in order:
            if rng.random() >= self.p:
                continue
            e = int(rng.integers(n_rounds - w))    # recover at e+w < rounds
            kind = KIND_CODES["server" if int(d) in head_set else "client"]
            groups.append([(e, int(d), 0.0, kind),
                           (e + w, int(d), 1.0, kind)])
        return trace_from_rows(_pack_groups(groups, m, pairs_only=True), m,
                               device)


@dataclass(frozen=True)
class FaultyUpdateProcess(FailureProcess):
    """Faulty updates: with probability ``p`` a device's transmitted
    deltas are scaled by ``scale`` from a uniform epoch on (for
    ``window`` rounds if set, else to the end) while the device stays
    fully alive — corruption, not death.  Lowers to shadow-device rows
    (``N + d``, kind ``"faulty"``, scale in the alive channel)."""
    p: float = 0.2
    scale: float = -1.0
    window: Optional[int] = None
    family: ClassVar[str] = "faulty"
    needs_faulty_engine: ClassVar[bool] = True

    def sample(self, rng, topo, n_rounds, max_events=None, device=None):
        m = max_events or self.default_max_events(topo)
        n = topo.num_devices
        faulty = KIND_CODES["faulty"]
        order = np.arange(n)
        rng.shuffle(order)
        groups = []
        for d in order:
            if rng.random() >= self.p:
                continue
            e = int(rng.integers(n_rounds))
            g = [(e, n + int(d), float(self.scale), faulty)]
            if self.window is not None and e + int(self.window) < n_rounds:
                g.append((e + int(self.window), n + int(d), 1.0, faulty))
            groups.append(g)
        return trace_from_rows(_pack_groups(groups, m), m, device)


@dataclass(frozen=True)
class ProcessGrid:
    """One generative axis of a campaign's traces: ``n_samples``
    Monte-Carlo draws of ``process``, deduplicated against the cell's
    whole trace pool."""
    process: FailureProcess
    n_samples: int = 4

    def __post_init__(self):
        assert self.n_samples >= 1, self.n_samples


def process_seed(sample_seed: int, process: FailureProcess,
                 draw: int) -> int:
    """Deterministic per-draw numpy seed from (spec seed, process
    identity, draw index) — SHA-256 of the dataclass repr, because
    Python's ``hash`` is salted per interpreter."""
    msg = f"{sample_seed}|{process!r}|{draw}".encode()
    return int.from_bytes(hashlib.sha256(msg).digest()[:8], "little")


def sample_process_grids(processes: Sequence[ProcessGrid], topo: Topology,
                         rounds: int, sample_seed: int, max_events: int,
                         traces: List[FailureTrace],
                         device: DeviceLike = None) -> Dict[int, List[int]]:
    """Lower process grids into a cell's trace pool (in place).

    Appends each distinct draw to ``traces`` on ``device`` (dedup by
    trace bytes against everything already there — an all-none draw
    aliases a no-failure base trace) and returns ``{grid index: [trace
    index per draw]}``.  Every draw gets a FRESH generator from
    :func:`process_seed`, so grids replay bit-identical regardless of
    draw order.  Draws are sampled on the host and moved once."""
    dev = resolve_device(device)
    idx_of: dict = {}
    for i, t in enumerate(traces):
        idx_of.setdefault(_trace_key(t), i)
    out: Dict[int, List[int]] = {}
    for gi, pg in enumerate(processes):
        idxs = []
        for draw in range(pg.n_samples):
            rng = np.random.default_rng(
                process_seed(sample_seed, pg.process, draw))
            t = pg.process.sample(rng, topo, rounds, max_events=max_events,
                                  device="cpu")
            assert t.max_events == max_events, (t.max_events, max_events)
            key = _trace_key(t)
            if key not in idx_of:
                idx_of[key] = len(traces)
                traces.append(t.to(dev))
            idxs.append(idx_of[key])
        out[gi] = idxs
    return out


def family_process(family: str, intensity: float) -> FailureProcess:
    """The canonical process of ``family`` at ``intensity`` in [0, 1] —
    the one knob the per-family E[AUROC] curves sweep.  Intensity maps
    to each family's headline probability; markov scales the per-round
    hazard down by 10x so a full sweep spans comparable outage mass."""
    if family == "iid":
        return IidRateProcess(p=intensity)
    if family == "markov":
        return MarkovChurnProcess(p_fail=0.1 * intensity, p_recover=0.25)
    if family == "cascade":
        return ClusterCascadeProcess(p_head=intensity)
    if family == "straggler":
        return StragglerProcess(p=intensity)
    if family == "faulty":
        return FaultyUpdateProcess(p=intensity)
    raise ValueError(f"unknown process family {family!r}; "
                     f"one of {FAMILIES}")
