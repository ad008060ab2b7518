"""Batched score entry points for the anomaly service: one per bucket.

Port of ``repro.serving.anomaly.engine``.  One bucket = one fixed batch
shape ``(B, W, D)`` = ONE entry point.  The core is tiny::

    (row_params, row, x) -> (B, W) anomaly scores

``row_params`` is the service's stacked parameter bank — row 0 the
global (cluster-head) model, rows ``1..N`` the isolated per-client
models (:class:`repro_torch.serving.anomaly.bank.ModelBank`) — and
``row``, a one-element int64 tensor on the bank's device, selects the
ONE model the whole batch scores against (``index_select`` on every
leaf).  The service groups a tick's windows by routed row and runs one
bucket per distinct row.  Row selection is a gather, so scoring a
failed-over group against row ``c + 1`` computes exactly what scoring
the isolated model directly computes (:func:`score_windows`).  ``x`` is
scored as one ``(B·W, D)`` batch through ``det.anomaly_scores``, each
layer one product with weights shared by the batch, as ``repro``'s vmap
lowers; the products are the row-stable kernel's
(:mod:`repro_torch.kernels.row_dense`), so a window's scores do not
depend on the bucket it is padded into, ``repro``'s contract (on the CPU
its plain version, ``dense_apply``'s arithmetic).  Every other operation
of both detector bodies (elementwise passes, the scan, the row sums) is
row-stable already.

On CUDA each bucket is one ``torch.cuda.CUDAGraph`` over static ``x``,
``row`` and output buffers (:class:`BucketEntry`): the caller copies a
group's windows into ``entry.x``, writes the row into ``entry.row`` and
replays.  The graph is warmed up on a side stream and captured with TF32
off (the graph fixes the GEMMs it captured).  A capture that fails
raises: there is no eager fallback on the card.  Entries live in an
in-process cache (:func:`score_entry`: ``source`` "capture" or
"memory"), keyed by the detector spec, the bucket shape and the identity
of the bank's ``row_params`` tensors: a graph reads those tensors at the
addresses it captured, so a second bank never hits the first bank's
graphs, and a cached entry holds its bank's tensors so their memory is
never handed to another tensor while the graph lives.  Services over
one bank share its entries and their static buffers, so they tick one
at a time.  :func:`clear_score_cache` drops the graphs (and with them
those references).  On the CPU the core runs eagerly into the same buffers,
and ``source`` is "eager".

Not ported here: ``repro``'s persistent executable cache (``source ==
"disk"``, ``core/compilecache``) and the plancheck budget of the score
core (``score_budget_name``); both belong to the compile-cache and
analysis slice (ROADMAP queue 1, item 11).
"""
from __future__ import annotations

import threading
from dataclasses import dataclass
from typing import Callable, Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core.failure import FailureTrace, trace_alive_mask
from repro_torch.kernels import row_dense
from repro_torch.models import detector as D
from repro_torch.models.detector import ModelLike
from repro_torch.models.params import Params, tree_items, tree_map_with_path

_SCORE_CACHE: Dict[tuple, "BucketEntry"] = {}
_SCORE_LOCK = threading.Lock()
#: CUDA graphs captured in this process, so a run can show that a warm
#: service captures nothing more
CAPTURES = 0


def score_windows(model: ModelLike, params: Params, x: torch.Tensor
                  ) -> torch.Tensor:
    """(B, W) scores of the window batch x (B, W, D) against one model's
    ``params``, as one (B·W, D) batch whose products are row-stable."""
    B, W, Dm = x.shape
    return D.as_detector(model).anomaly_scores(
        params, x.reshape(B * W, Dm), dense=row_dense.dense_apply
    ).reshape(B, W)


def score_core(model: ModelLike) -> Callable:
    """(row_params, row, x) -> (B, W) scores: ``row`` (a one-element
    int64 tensor) gathers one bank row from every leaf, ``x`` is the
    (B, W, D) window batch scored against it (:func:`score_windows`)."""
    det = D.as_detector(model)

    def score(row_params: Params, row: torch.Tensor, x: torch.Tensor
              ) -> torch.Tensor:
        rows = tree_map_with_path(lambda _, p: p.index_select(0, row)[0],
                                  row_params)
        return score_windows(det, rows, x)

    return score


@dataclass(eq=False)
class BucketEntry:
    """One bucket's entry point: static ``x`` (B, W, D), ``row`` (1,)
    int64 and ``out`` (B, W) buffers on the bank's device.  On CUDA
    :meth:`replay` launches the captured graph; on the CPU it runs the
    core eagerly into ``out``."""
    x: torch.Tensor
    row: torch.Tensor
    out: torch.Tensor
    graph: Optional["torch.cuda.CUDAGraph"]
    core: Callable
    row_params: Params           # the tensors the graph reads: held

    def replay(self) -> None:
        if self.graph is not None:
            self.graph.replay()
        else:
            self.out.copy_(self.core(self.row_params, self.row, self.x))


def _leaves(row_params: Params) -> Tuple[torch.Tensor, ...]:
    return tuple(leaf for _, leaf in tree_items(row_params))


def _capture(model: ModelLike, row_params: Params,
             shape: Tuple[int, int, int]) -> BucketEntry:
    """Warm the core up on a side stream, then capture it in a graph."""
    global CAPTURES
    dev = _leaves(row_params)[0].device
    core = score_core(model)
    x = torch.zeros(shape, dtype=torch.float32, device=dev)
    row = torch.zeros((1,), dtype=torch.int64, device=dev)
    torch.backends.cuda.matmul.allow_tf32 = False
    side = torch.cuda.Stream(dev)
    side.wait_stream(torch.cuda.current_stream(dev))
    with torch.cuda.stream(side):
        for _ in range(2):
            core(row_params, row, x)
    torch.cuda.current_stream(dev).wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = core(row_params, row, x)
    CAPTURES += 1
    return BucketEntry(x, row, out, graph, core, row_params)


def score_entry(model: ModelLike, row_params: Params,
                shape: Sequence[int]) -> Tuple[BucketEntry, str]:
    """The entry point of bucket ``shape`` = (B, W, D) for the bank
    ``row_params``: ``(entry, source)``.  On CUDA the in-process cache
    answers ("memory") or the graph is captured now ("capture"); on the
    CPU a fresh eager entry ("eager")."""
    shape = tuple(int(s) for s in shape)
    leaves = _leaves(row_params)
    dev = leaves[0].device
    if dev.type != "cuda":
        core = score_core(model)
        entry = BucketEntry(
            torch.zeros(shape, dtype=torch.float32, device=dev),
            torch.zeros((1,), dtype=torch.int64, device=dev),
            torch.zeros(shape[:2], dtype=torch.float32, device=dev),
            None, core, row_params)
        return entry, "eager"
    key = (("serve_score", D.as_detector(model), shape, str(dev))
           + tuple(id(leaf) for leaf in leaves))
    with _SCORE_LOCK:
        hit = _SCORE_CACHE.get(key)
        if hit is not None:
            return hit, "memory"
        entry = _capture(model, row_params, shape)
        _SCORE_CACHE[key] = entry
    return entry, "capture"


def alive_table(trace: FailureTrace, num_devices: int, n_epochs: int
                ) -> np.ndarray:
    """(n_epochs, num_devices) float32 liveness table — every epoch's
    :func:`~repro_torch.core.failure.trace_alive_mask` in one call on the
    trace's device (the trace broadcast to one row an epoch), as host
    numpy: a service tick then indexes a host array."""
    m = trace.max_events
    stacked = FailureTrace(*(t.expand(n_epochs, m).contiguous() for t in (
        trace.epochs, trace.devices, trace.alive_after, trace.kinds)))
    epochs = torch.arange(n_epochs, dtype=torch.int32,
                          device=trace.epochs.device)[:, None]
    return trace_alive_mask(stacked, num_devices, epochs).cpu().numpy()


def clear_score_cache() -> None:
    """Drop the in-process bucket cache and the graphs it holds."""
    with _SCORE_LOCK:
        _SCORE_CACHE.clear()
