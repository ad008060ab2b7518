"""Batched anomaly-scoring service with inference-time failover.

Port of ``repro.serving.anomaly.service``.  The live half of the paper's
failure-tolerance story: clients stream traffic windows, the service
coalesces them into fixed-size batch buckets (one entry point each,
:mod:`repro_torch.serving.anomaly.engine`), routes every window to its
cluster-head model, and — with :func:`~repro_torch.core.failure.
trace_alive_mask` semantics at inference time — fails over to the
client's isolated model while its head is dead, failing back on
recovery.

* **buckets** — ``ServiceConfig.bucket_sizes`` (default 1/8/64), each
  resolved at construction (``compile_sources``: "capture" or "memory"
  on the card, where each bucket is one CUDA graph; "eager" on the CPU).
* **work queue** — :meth:`AnomalyService.submit` enqueues ``(client,
  window)`` FIFO; :meth:`AnomalyService.tick` drains it in chunks of at
  most the largest bucket, groups each chunk by ROUTED MODEL ROW and
  packs every group into the smallest bucket that fits (padding with
  zero windows).  Results come back in submission order and no window is
  dropped.
* **liveness** — one :class:`~repro_torch.core.failure.FailureTrace` (or
  a sampled :class:`~repro_torch.core.processes.FailureProcess`) built
  on the CPU drives the per-tick alive mask, precomputed over the
  horizon as a host table; the service tick IS the trace epoch.
* **routing** — head alive: bank row 0 (the global model); head dead:
  row ``client + 1`` (the isolated model).  Row selection is a gather
  inside the bucket's core, so failover scores are what scoring the
  isolated model directly at the same batch shape gives, bit for bit.

On the card a chunk is dispatched without waiting on the device: its
windows go to a pinned host buffer in group order; each group's rows
are copied into its bucket's static input (tail rows zeroed), its row
into the static row, the graph replays, and its scores are copied into
a device buffer of the chunk.  The chunk's scores then come to the host
in ONE copy, after all its groups are dispatched; latency is taken
after that copy, as ``repro`` takes it after its last group.
``stage_seconds`` splits the host's time in a tick into routing and
grouping, host padding, input copies, replays, score copies, and the
copy to the host with the reassembly in submission order (host clock; on
the card the last holds the wait for the device).

:meth:`AnomalyService.report` summarises a served stream: sustained
windows/sec, p50/p99 latency, failover/failback counts and — when
submissions carry labels — per-regime AUROC.
"""
from __future__ import annotations

import time
from collections import deque
from dataclasses import dataclass, field
from typing import Dict, List, NamedTuple, Optional, Tuple, Union

import numpy as np
import torch

from repro_torch.core.failure import NO_FAILURE, PAD_EPOCH, Failure, as_trace
from repro_torch.core.processes import FailureProcess, process_seed
from repro_torch.serving.anomaly import engine
from repro_torch.serving.anomaly.bank import ModelBank
from repro_torch.training.metrics import auroc

#: the parts of a tick ``AnomalyService.stage_seconds`` times
STAGES = ("route", "pad", "h2d", "replay", "gather", "d2h")


@dataclass(frozen=True)
class ServiceConfig:
    """Static service shape: bucket sizes and window length only."""

    bucket_sizes: Tuple[int, ...] = (1, 8, 64)   # one entry point each
    window: int = 16                             # rows per traffic window

    def __post_init__(self):
        assert self.bucket_sizes, "at least one batch bucket"
        assert all(b > 0 for b in self.bucket_sizes), self.bucket_sizes
        assert self.window > 0, self.window


class ScoredWindow(NamedTuple):
    """One scored traffic window, as returned by :meth:`tick`."""
    client: int
    seq: int                 # per-client submission sequence number
    epoch: int               # service tick it was scored at
    scores: np.ndarray       # (window,) per-row anomaly scores
    served_by: str           # "head" | "isolated"
    latency_s: float         # submit -> scored wall clock


@dataclass
class ServiceReport:
    """Summary of a served stream."""
    windows: int             # windows scored
    dropped: int             # submitted but never scored (always 0)
    batches: int             # bucket dispatches
    windows_per_s: float     # sustained: windows / busy wall
    p50_ms: float            # per-window submit->scored latency
    p99_ms: float
    failovers: int           # head->isolated transitions
    failbacks: int           # isolated->head transitions
    auroc_head: float        # AUROC of head-served windows (nan: no labels)
    auroc_isolated: float    # AUROC of failover-served windows
    bucket_batches: Dict[int, int] = field(default_factory=dict)

    def describe(self) -> str:
        return (f"{self.windows} windows in {self.batches} batches "
                f"({self.windows_per_s:.0f} win/s, p50 "
                f"{self.p50_ms:.2f} ms, p99 {self.p99_ms:.2f} ms), "
                f"{self.failovers} failovers / {self.failbacks} "
                f"failbacks, AUROC head={self.auroc_head:.3f} "
                f"isolated={self.auroc_isolated:.3f}, "
                f"dropped={self.dropped}")


class _Request(NamedTuple):
    client: int
    seq: int
    window: np.ndarray
    labels: Optional[np.ndarray]
    t_submit: float


class AnomalyService:
    """Batched failover scoring service over a trained
    :class:`~repro_torch.serving.anomaly.bank.ModelBank`, on the bank's
    device.

    ``failure`` may be ``None`` (nothing ever fails), a
    :class:`FailureSpec` / :class:`FailureTrace`, or a
    :class:`FailureProcess` — sampled once at construction with the same
    SHA-256-derived seeding as campaign trace grids, so a service stood
    up twice replays the identical outage."""

    def __init__(self, bank: ModelBank,
                 config: ServiceConfig = ServiceConfig(),
                 failure: Union[None, Failure, FailureProcess] = None,
                 sample_seed: int = 0, horizon: int = 256):
        self.bank = bank
        self.config = config
        topo = bank.topology
        if failure is None:
            self._trace = as_trace(NO_FAILURE, topo, device="cpu")
        elif isinstance(failure, FailureProcess):
            rng = np.random.default_rng(
                process_seed(sample_seed, failure, 0))
            self._trace = failure.sample(rng, topo, horizon, device="cpu")
        else:
            self._trace = as_trace(failure, topo, device="cpu")
        self._heads = np.asarray(topo.heads)
        self._cluster_of = np.asarray(topo.device_cluster_array())
        # liveness precomputed over the horizon: a tick indexes a host
        # table
        ep = self._trace.epochs.numpy()
        real = ep[ep < PAD_EPOCH]
        n_epochs = int(max(horizon, (int(real.max()) + 2) if real.size
                           else 1))
        self._alive_table = engine.alive_table(self._trace,
                                               topo.num_devices, n_epochs)
        self._buckets = tuple(sorted(set(config.bucket_sizes)))
        self._pending: deque = deque()
        self._seq: Dict[int, int] = {}
        self._mode: Dict[int, str] = {}       # last served_by per client
        self.epoch = 0
        self.timeline: List[Tuple[int, int, str]] = []
        # counters the report aggregates
        self._submitted = 0
        self._scored = 0
        self._batches = 0
        self._bucket_batches: Dict[int, int] = {b: 0 for b in self._buckets}
        self._failovers = 0
        self._failbacks = 0
        self._busy_s = 0.0
        self._latencies: List[float] = []
        self._regime_scores: Dict[str, list] = {"head": [], "isolated": []}
        self._regime_labels: Dict[str, list] = {"head": [], "isolated": []}
        self.stage_seconds: Dict[str, float] = dict.fromkeys(STAGES, 0.0)
        # every bucket's entry point (memory -> capture; eager on the CPU)
        self._entries: Dict[int, engine.BucketEntry] = {}
        self.compile_sources: Dict[int, str] = {}
        for bs in self._buckets:
            entry, source = engine.score_entry(
                bank.detector, bank.row_params,
                (bs, config.window, bank.input_dim))
            self._entries[bs] = entry
            self.compile_sources[bs] = source
        dev = entry.x.device
        # a chunk's windows in group order (pinned on the card, so their
        # copies to the device do not wait), and its scores on the device
        self._host_x = torch.empty(
            (self._buckets[-1], config.window, bank.input_dim),
            dtype=torch.float32, pin_memory=dev.type == "cuda")
        self._chunk_scores = torch.empty(
            (self._buckets[-1], config.window), dtype=torch.float32,
            device=dev)

    # ------------------------------------------------------------------
    # client side
    # ------------------------------------------------------------------
    def submit(self, client: int, window: np.ndarray,
               labels: Optional[np.ndarray] = None) -> int:
        """Enqueue one traffic window for ``client``; returns the
        client's submission sequence number.  ``window`` is
        ``(config.window, input_dim)`` float32; optional ``labels`` (one
        per row, 1 = anomalous) feed the per-regime AUROC."""
        window = np.asarray(window, np.float32)
        expect = (self.config.window, self.bank.input_dim)
        assert window.shape == expect, (window.shape, expect)
        seq = self._seq.get(client, 0)
        self._seq[client] = seq + 1
        self._pending.append(_Request(
            int(client), seq, window,
            None if labels is None else np.asarray(labels),
            time.perf_counter()))
        self._submitted += 1
        return seq

    @property
    def pending(self) -> int:
        return len(self._pending)

    # ------------------------------------------------------------------
    # service side
    # ------------------------------------------------------------------
    def alive_mask(self, epoch: Optional[int] = None) -> np.ndarray:
        """(N,) liveness at a service tick (default: the current one).
        Epochs past the precomputed table clamp to its last row."""
        e = self.epoch if epoch is None else epoch
        return self._alive_table[min(e, len(self._alive_table) - 1)]

    def _pick_bucket(self, n: int) -> int:
        for b in self._buckets:
            if b >= n:
                return b
        return self._buckets[-1]

    def _dispatch(self, chunk: List[_Request],
                  groups: Dict[int, List[int]]) -> torch.Tensor:
        """Score a chunk's groups through their buckets; returns the
        chunk's (n, window) scores in group order, on the bank's device.
        Nothing here waits on the device."""
        stage = self.stage_seconds
        t = time.perf_counter()
        xs = self._host_x.numpy()
        off = 0
        for members in groups.values():
            for i in members:
                xs[off] = chunk[i].window
                off += 1
        t1 = time.perf_counter()
        stage["pad"] += t1 - t
        off = 0
        for row, members in groups.items():
            m = len(members)
            bs = self._pick_bucket(m)
            entry = self._entries[bs]
            t = time.perf_counter()
            entry.x[:m].copy_(self._host_x[off:off + m], non_blocking=True)
            if m < bs:
                entry.x[m:].zero_()
            entry.row.fill_(row)
            t1 = time.perf_counter()
            entry.replay()
            t2 = time.perf_counter()
            self._chunk_scores[off:off + m].copy_(entry.out[:m])
            t3 = time.perf_counter()
            stage["h2d"] += t1 - t
            stage["replay"] += t2 - t1
            stage["gather"] += t3 - t2
            self._batches += 1
            self._bucket_batches[bs] += 1
            off += m
        return self._chunk_scores[:off]

    def tick(self) -> List[ScoredWindow]:
        """Drain the queue at the current epoch, then advance it.

        Every pending window is scored (zero drops): the queue is
        consumed FIFO in chunks of at most the largest bucket; each chunk
        is grouped by ROUTED BANK ROW and every group dispatched through
        the smallest bucket that fits (remainder rows padded with zero
        windows, sliced off before results are reassembled in submission
        order)."""
        alive = self.alive_mask()
        out: List[ScoredWindow] = []
        stage = self.stage_seconds
        while self._pending:
            t0 = time.perf_counter()
            n = min(len(self._pending), self._buckets[-1])
            chunk = [self._pending.popleft() for _ in range(n)]
            modes: List[str] = []
            groups: Dict[int, List[int]] = {}
            for i, r in enumerate(chunk):
                head = int(self._heads[self._cluster_of[r.client]])
                failover = alive[head] <= 0.0
                modes.append("isolated" if failover else "head")
                row = self.bank.row_index(r.client, failover)
                groups.setdefault(row, []).append(i)
            stage["route"] += time.perf_counter() - t0
            got = self._dispatch(chunk, groups)
            t = time.perf_counter()
            host = got.cpu().numpy()          # the chunk's one copy
            scores = np.empty((n, self.config.window), np.float32)
            off = 0
            for members in groups.values():
                scores[np.asarray(members)] = host[off:off + len(members)]
                off += len(members)
            t1 = time.perf_counter()
            stage["d2h"] += t1 - t
            self._busy_s += t1 - t0
            for i, (r, mode) in enumerate(zip(chunk, modes)):
                prev = self._mode.get(r.client, "head")
                if mode != prev:
                    if mode == "isolated":
                        self._failovers += 1
                        self.timeline.append((self.epoch, r.client,
                                              "failover"))
                    else:
                        self._failbacks += 1
                        self.timeline.append((self.epoch, r.client,
                                              "failback"))
                self._mode[r.client] = mode
                self._scored += 1
                self._latencies.append(t1 - r.t_submit)
                if r.labels is not None:
                    self._regime_scores[mode].append(scores[i])
                    self._regime_labels[mode].append(r.labels)
                out.append(ScoredWindow(r.client, r.seq, self.epoch,
                                        scores[i], mode, t1 - r.t_submit))
        self.epoch += 1
        return out

    def run(self, epochs: int) -> List[ScoredWindow]:
        """Tick ``epochs`` times (anything queued between ticks by the
        caller is scored on the next one)."""
        out: List[ScoredWindow] = []
        for _ in range(epochs):
            out.extend(self.tick())
        return out

    # ------------------------------------------------------------------
    # reporting
    # ------------------------------------------------------------------
    def _regime_auroc(self, regime: str) -> float:
        if not self._regime_scores[regime]:
            return float("nan")
        s = np.concatenate([np.ravel(v)
                            for v in self._regime_scores[regime]])
        y = np.concatenate([np.ravel(v)
                            for v in self._regime_labels[regime]])
        return auroc(s, y)

    def report(self) -> ServiceReport:
        lat = np.asarray(self._latencies) * 1e3 if self._latencies \
            else np.zeros((1,))
        return ServiceReport(
            windows=self._scored,
            dropped=self._submitted - self._scored - len(self._pending),
            batches=self._batches,
            windows_per_s=(self._scored / self._busy_s
                           if self._busy_s > 0 else 0.0),
            p50_ms=float(np.percentile(lat, 50)),
            p99_ms=float(np.percentile(lat, 99)),
            failovers=self._failovers,
            failbacks=self._failbacks,
            auroc_head=self._regime_auroc("head"),
            auroc_isolated=self._regime_auroc("isolated"),
            bucket_batches=dict(self._bucket_batches))
