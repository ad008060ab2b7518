"""Clustered-FL baselines the paper compares against (Section V-A).

Port of ``repro.core.baselines``.

* **FedGroup** [arXiv:2010.06870] — static grouping by a data-driven
  measure: devices are clustered once (cosine similarity of their initial
  local updates, k-means in gradient space), then per-group FedAvg.
* **IFCA** [NeurIPS'20] — iterative: every round each device picks the
  model with the lowest loss on its local data, trains it, and models are
  aggregated over their adopters.
* **FeSEM** [arXiv:2005.01026] — multi-center EM: devices are assigned to
  the nearest center in parameter space after a local step; centers move
  to the weighted mean of their members.

All train M model instances.  Reporting matches the paper's columns:
``best`` (*) = highest test AUROC of any single instance; ``multi`` (†) =
per-sample min reconstruction error over instances (the multi-model
oracle score).

Where ``repro`` jits one scenario core and vmaps it over stacked traces,
the port runs ONE round loop with a leading scenario axis S
(:func:`_multimodel_loop`): :func:`run_multimodel` runs it at S = 1,
:func:`repro_torch.core.campaign.run_multimodel_campaign` over a whole
(trace x seed) grid.  Each model is one flat f32 vector
(:class:`FlatLayout`), so a loop holds (S, M, P) models, and a round is

* the alive masks as device tensors: client events -> (S, N) devices,
  server events -> (S, M) models (a server event kills model 0's
  aggregator, whatever device it names);
* the assignment: IFCA's loss of every model on every device, (S, N, M),
  from one batched forward pass; FeSEM's one-step-updated params and
  their squared distance to every model; FedGroup's static k-means
  groups;
* one batched forward and backward pass for each device's gradient on
  its assigned model, (S, N, P), and the per-model weighted mean as
  batched products with a one-hot built by comparison;
* the test scores of every model, (S, M, T), and the round's loss: the
  mean over the test rows of the minimum over LIVE models.

The loop never waits on the host.  ``cfg.num_models`` is only the length
of the model axis: the live count of each scenario arrives in
``model_valid`` (S, M), so cells with different M run padded in one loop.
A padded slot never wins an assignment, aggregates zero devices (so it
stays at its init) and stays out of the loss and the metrics: live
results equal the unpadded run's.

Failure semantics: a *client* failure removes that device; a *server*
failure kills the aggregator of group 0 — that instance freezes and its
devices stop contributing (they keep their last model for evaluation).
A legacy ``FailureSpec`` with ``device=None`` kills device N-1 for a
client failure (there are no cluster heads here) and device 0 for a
server failure.

RNG, by the port's rule that random draws are operands.  Per seed the
loop takes the M model inits, FedGroup's probe init, its k-means
permutation (the first m entries of a permutation of N) and its reseed
indices ((iters, m) in [0, N)), and nothing else; :class:`MultiDraws`
holds one seed's (parity tests pass ``repro``'s).  Without them,
:func:`default_draws` takes each from a CPU ``torch.Generator`` seeded
from (seed, stream, j): model j's init and center j's reseed indices
depend on (seed, j) only, and a permutation's first m entries not on m,
so padding the model axis never moves a live model (``repro``'s
``fold_in`` discipline).  Dropout draws from one generator on the loop's
device seeded with ``dropout_seed`` (``cfg.seed`` in
:func:`run_multimodel`, the campaign's chunk rule in a campaign):
FedGroup's probe masks first, then one keep mask a hidden layer each
round, (S, N, n_max, width), which IFCA's probe of every model, FeSEM's
e-step and the round's training gradient all apply — in ``repro`` one
per-device key drives those three.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch import DeviceLike, resolve_device
from repro_torch.core import simulate as sim
from repro_torch.core.failure import (KIND_CODES, MAX_EVENTS, NO_FAILURE,
                                      PAD_EPOCH, Failure, FailureTrace,
                                      stack_traces, trace_alive_mask,
                                      trace_faulty_scale)
from repro_torch.models import detector as D
from repro_torch.models.detector import DetectorModel, ModelLike
from repro_torch.models.params import FlatLayout, Params
from repro_torch.training.metrics import auroc_batch

SCHEMES = ("fedgroup", "ifca", "fesem")
#: Lloyd iterations of FedGroup's k-means (``repro``'s default)
KMEANS_ITERS = 20
_HASH_BASE = 1_000_003
_MOD = 1 << 63
_INIT, _PROBE, _PERM, _RESEED = range(4)     # default_draws' streams


@dataclass(frozen=True)
class MultiModelConfig:
    scheme: str = "ifca"          # fedgroup | ifca | fesem
    num_devices: int = 10
    num_models: int = 3
    rounds: int = 100
    lr: float = 1e-4
    dropout: bool = True
    seed: int = 0


@dataclass(frozen=True)
class FaultyMultiModelConfig(MultiModelConfig):
    """Faulty-update variant of the multi-model engine: per-device
    deltas are scaled by the ORIGINAL trace's faulty channel before the
    per-model aggregation (assignment probes stay clean — a faulty
    device corrupts what it sends, not how it measures).  A distinct
    frozen subclass, as :class:`repro_torch.core.simulate.FaultySimConfig`:
    class identity selects the faulty path."""
    faulty_updates: bool = True


@dataclass
class MultiModelResult:
    best_auroc: float             # the paper's * column
    multi_auroc: float            # the paper's dagger column
    loss_curve: np.ndarray
    assignments: np.ndarray       # final device -> model map


class MultiOutputs(NamedTuple):
    """Raw outputs of S multi-model scenarios (pre-AUROC), on the device."""
    losses: torch.Tensor          # (S, rounds) per-sample-min test loss
    final_scores: torch.Tensor    # (S, M, T) per-instance anomaly scores
    assignments: torch.Tensor     # (S, N) int64 final device -> model map


class MultiDraws(NamedTuple):
    """One seed's random draws (see the module docstring).  ``inits``
    holds at least as many param trees as the loop has models; FedGroup
    also needs ``probe`` (a param tree), ``perm`` (a permutation of the N
    devices, or at least its first m entries) and ``reseed`` ((iters, >=
    m) device indices)."""
    inits: Sequence[Params]
    probe: Optional[Params] = None
    perm: Optional[np.ndarray] = None
    reseed: Optional[np.ndarray] = None


def _generator(seed: int, stream: int, j: int = 0) -> torch.Generator:
    return torch.Generator().manual_seed(
        ((int(seed) * _HASH_BASE + stream) * _HASH_BASE + j) % _MOD)


def default_draws(model: ModelLike, seed: int, num_devices: int,
                  num_models: int) -> MultiDraws:
    """The draws of scenario seed ``seed`` when none are given, on the
    CPU: model j's init and center j's reseed indices from generators
    seeded from (seed, j), the permutation from one seeded from seed."""
    det = D.as_detector(model)
    inits = [det.init_params(_generator(seed, _INIT, j), device="cpu")
             for j in range(num_models)]
    probe = det.init_params(_generator(seed, _PROBE), device="cpu")
    perm = torch.randperm(num_devices,
                          generator=_generator(seed, _PERM)).numpy()
    reseed = np.stack([torch.randint(0, num_devices, (KMEANS_ITERS,),
                                     generator=_generator(seed, _RESEED,
                                                          j)).numpy()
                       for j in range(num_models)], axis=1)
    return MultiDraws(inits, probe, perm, reseed)


class _Tables(NamedTuple):
    """Draws of D seeds on the device, one row a seed."""
    layout: FlatLayout
    inits: torch.Tensor                 # (D, m, P)
    probe: Optional[torch.Tensor]       # (D, P)
    perm: Optional[torch.Tensor]        # (D, m) int64
    reseed: Optional[torch.Tensor]      # (D, iters, m) int64

    def rows(self, r: torch.Tensor):
        """(inits, probe, perm, reseed) of the scenarios whose seed rows
        are ``r`` (a device index tensor: no host sync)."""
        return tuple(None if t is None else t[r]
                     for t in (self.inits, self.probe, self.perm,
                               self.reseed))


def _draw_tables(det: DetectorModel, scheme: str, seeds: Sequence[int],
                 draws: Optional[Sequence[MultiDraws]], n: int, m: int,
                 dev: torch.device) -> _Tables:
    """Each seed's draws (``default_draws`` when ``draws`` is None),
    checked on the host and stacked on the device for ``m`` models and
    ``n`` devices; FedGroup's grouping draws only for FedGroup."""
    seeds = [int(s) for s in seeds]
    if draws is None:
        draws = [default_draws(det, s, n, m) for s in seeds]
    elif len(draws) != len(seeds):
        raise ValueError(f"draws for {len(draws)} seeds, but {len(seeds)} "
                         f"seeds")
    layout = FlatLayout.of(draws[0].inits[0])
    for d in draws:
        if len(d.inits) < m:
            raise ValueError(f"draws hold {len(d.inits)} model inits for "
                             f"{m} models")
    inits = torch.stack([torch.stack([layout.flatten(t).to(dev)
                                      for t in d.inits[:m]]) for d in draws])
    if scheme != "fedgroup":
        return _Tables(layout, inits, None, None, None)
    _check_centers(m, n)
    perm, reseed = [], []
    for d in draws:
        if d.probe is None or d.perm is None or d.reseed is None:
            raise ValueError("fedgroup needs the probe, perm and reseed "
                             "draws")
        p, r = np.asarray(d.perm), np.asarray(d.reseed)
        if (p.ndim != 1 or len(p) < m or r.ndim != 2 or r.shape[1] < m
                or min(p.min(), r.min()) < 0 or max(p.max(), r.max()) >= n):
            raise ValueError(f"bad k-means draws for {m} centers over {n} "
                             f"devices: perm {p.shape}, reseed {r.shape}")
        perm.append(p[:m])
        reseed.append(r[:, :m])
    probe = torch.stack([layout.flatten(d.probe).to(dev) for d in draws])
    return _Tables(layout, inits, probe,
                   torch.as_tensor(np.stack(perm), dtype=torch.int64,
                                   device=dev),
                   torch.as_tensor(np.stack(reseed), dtype=torch.int64,
                                   device=dev))


def _check_centers(m: int, n: int) -> None:
    if m > n:
        raise ValueError(
            f"FedGroup k-means needs num_models <= num_devices to seed "
            f"distinct centers; got num_models={m} > num_devices={n}")


def _kmeans_groups(vectors: torch.Tensor, m: int, perm: torch.Tensor,
                   reseed: torch.Tensor,
                   center_valid: Optional[torch.Tensor] = None
                   ) -> torch.Tensor:
    """FedGroup's static gradient-similarity grouping: k-means with the
    cosine metric (rows are L2-normalised), for (n, D) ``vectors`` or a
    stack (S, n, D); returns the (n,) or (S, n) int64 groups.

    Centers seed from the data rows ``perm[..., :m]``; a group that
    empties during the Lloyd iterations is RE-SEEDED on data row
    ``reseed[..., i, j]`` (``reseed`` is (iters, m) or (S, iters, m))
    instead of keeping a stale center.  ``center_valid`` ((m,) or (S, m),
    1 = real) keeps padded center slots from winning any row; the draws
    of center j do not depend on m, so the valid centers' groups are the
    same whatever m they are padded to."""
    n = vectors.shape[-2]
    _check_centers(m, n)
    v = vectors / (torch.linalg.vector_norm(vectors, dim=-1, keepdim=True)
                   + 1e-9)
    slots = torch.arange(m, device=v.device)
    neg_inf = torch.full((), float("-inf"), device=v.device)

    def rows(idx):
        # int64: the CPU gather misreads an expanded int32 index
        idx = idx.to(torch.int64)
        return torch.gather(v, -2, idx[..., None].expand(*idx.shape,
                                                         v.shape[-1]))

    def assign(centers):
        sim_ = v @ centers.transpose(-1, -2)                  # (..., n, m)
        if center_valid is not None:
            sim_ = torch.where(center_valid[..., None, :] > 0, sim_, neg_inf)
        return torch.argmax(sim_, dim=-1)

    centers = rows(perm[..., :m])
    for i in range(reseed.shape[-2]):
        onehot = (assign(centers)[..., None] == slots).to(v.dtype)
        cnt = onehot.sum(-2)                                  # (..., m)
        means = (onehot.transpose(-1, -2) @ v
                 / torch.clamp_min(cnt[..., None], 1.0))
        means = means / (torch.linalg.vector_norm(means, dim=-1,
                                                  keepdim=True) + 1e-9)
        centers = torch.where(cnt[..., None] > 0, means,
                              rows(reseed[..., i, :m]))
    return assign(centers)


def as_multimodel_trace(failure: Failure, num_devices: int,
                        max_events: int = MAX_EVENTS,
                        device: DeviceLike = None) -> FailureTrace:
    """Normalise a failure to a trace on ``device`` with the BASELINE
    default targets: a legacy single-event ``FailureSpec`` with
    ``device=None`` resolves to device N-1 for a client failure (there
    are no cluster heads here) and to device 0 for a server failure
    (server events kill group 0 whatever device they name)."""
    dev = resolve_device(device)
    if isinstance(failure, FailureTrace):
        return failure.to(dev)
    if failure.kind == "none":
        return FailureTrace.none(max_events, dev)
    target = failure.device
    if target is None:
        target = num_devices - 1 if failure.kind == "client" else 0
    ep = np.full((max_events,), PAD_EPOCH, np.int32)
    dv = np.full((max_events,), -1, np.int32)
    alv = np.ones((max_events,), np.float32)
    knd = np.zeros((max_events,), np.int32)
    ep[0], dv[0], alv[0] = failure.epoch, target, 0.0
    knd[0] = KIND_CODES[failure.kind]
    return FailureTrace(*(torch.from_numpy(a).to(dev)
                          for a in (ep, dv, alv, knd)))


def _split_trace(trace: FailureTrace) -> Tuple[FailureTrace, FailureTrace]:
    """Split a trace ((M_ev,) or stacked (S, M_ev) fields) into (client
    events -> device mask, server events -> group-0 mask) on the device;
    the slots of the other kind keep ``PAD_EPOCH`` and never fire."""
    pad = torch.full((), PAD_EPOCH, dtype=trace.epochs.dtype,
                     device=trace.epochs.device)
    client_tr = FailureTrace(
        torch.where(trace.kinds == KIND_CODES["client"], trace.epochs, pad),
        trace.devices, trace.alive_after, trace.kinds)
    # server events all target group 0, whatever device they named
    server_tr = FailureTrace(
        torch.where(trace.kinds == KIND_CODES["server"], trace.epochs, pad),
        torch.zeros_like(trace.devices), trace.alive_after, trace.kinds)
    return client_tr, server_tr


#: ``repro``'s name for the device arrays of the multi-model engine
prepare_multimodel_arrays = sim.device_arrays


def _multimodel_loop(det: DetectorModel, cfg: MultiModelConfig,
                     layout: FlatLayout, models0: torch.Tensor,
                     model_valid: torch.Tensor, dx: torch.Tensor,
                     counts: torch.Tensor, valid: torch.Tensor,
                     tx: torch.Tensor, trace: FailureTrace,
                     probe: Optional[torch.Tensor] = None,
                     perm: Optional[torch.Tensor] = None,
                     reseed: Optional[torch.Tensor] = None,
                     dropout_seed: int = 0
                     ) -> Tuple[MultiOutputs, torch.Tensor]:
    """The round loop of ``repro``'s ``_build_multimodel_core`` for S
    scenarios at once: returns the outputs (each with a leading S axis)
    and the final models (S, M, P).

    Per scenario: ``models0`` (S, M, P), ``model_valid`` (S, M), a stacked
    ``trace`` of (S, M_ev) fields and, for FedGroup, the probe params
    ``probe`` (S, P) and the k-means draws ``perm`` (S, M) and ``reseed``
    (S, iters, M).  The device data ``dx`` (N, n_max, D), ``counts`` (N,),
    ``valid`` (N, n_max) and the test rows ``tx`` (T, D) are shared.
    ``cfg`` gives the scheme, rounds, lr, dropout and (by its class) the
    faulty channel; the model count is ``models0``'s."""
    if cfg.scheme not in SCHEMES:
        raise ValueError(f"unknown multi-model scheme {cfg.scheme!r}; "
                         f"known: {SCHEMES}")
    dev = dx.device
    S, M, P = models0.shape
    N, n_max, R = dx.shape[0], dx.shape[1], cfg.rounds
    faulty = bool(getattr(cfg, "faulty_updates", False))
    generator = (sim.device_generator(dev, dropout_seed)
                 if cfg.dropout else None)
    # one (S, N, n_max, D) copy for the whole loop, as simulate._round_loop
    dxs = dx.repeat(S, 1, 1, 1)
    client_tr, server_tr = _split_trace(trace)
    live = model_valid > 0                                   # (S, M)
    slots = torch.arange(M, device=dev)
    inf = torch.full((), float("inf"), device=dev)

    def masks():
        return (det.dropout_masks((S, N, n_max), generator, dev)
                if generator is not None else None)

    def grads(flat, keep):
        return sim._device_grads(det, layout, flat, dxs, valid, None, keep)

    def assigned(models, assign):
        """(S, N, P): each device's copy of its assigned model."""
        return torch.gather(models, 1, assign[..., None].expand(S, N, P))

    def scores_of(models):
        return det.anomaly_scores(layout.unflatten(models), tx)  # (S, M, T)

    if cfg.scheme == "fedgroup":
        g0 = grads(probe[:, None, :].expand(S, N, P), masks())
        assign = _kmeans_groups(g0, M, perm, reseed, model_valid)
    else:
        m_live = torch.clamp_min(model_valid.sum(-1), 1.0).to(torch.int64)
        assign = torch.arange(N, device=dev) % m_live[:, None]

    models = models0
    losses = torch.empty((S, R), dtype=torch.float32, device=dev)
    for epoch in range(R):
        a_dev = trace_alive_mask(client_tr, N, epoch)        # (S, N)
        a_grp = trace_alive_mask(server_tr, M, epoch)        # (S, M)
        keep = masks()

        # ---- (re)assignment; padded slots never win: loss/distance +inf
        if cfg.scheme == "ifca":
            # every model on every device: params (S, M, 1, ...) against
            # data (S, 1, N, n_max, D), one keep mask per device for all M
            probe_keep = None if keep is None else [k[:, None] for k in keep]
            lm = det.loss(layout.unflatten(models[:, :, None, :]),
                          dxs[:, None], valid, None,
                          probe_keep).transpose(1, 2)        # (S, N, M)
            assign = torch.argmin(torch.where(live[:, None, :], lm, inf),
                                  dim=-1)
        elif cfg.scheme == "fesem":
            # e-step: distance between the one-step-updated local params
            # and each center, in parameter space
            p_cur = assigned(models, assign)
            upd = p_cur - cfg.lr * grads(p_cur, keep)
            d = torch.sum(torch.square(upd[:, :, None, :]
                                       - models[:, None, :, :]), dim=-1)
            assign = torch.argmin(torch.where(live[:, None, :], d, inf),
                                  dim=-1)
        # fedgroup: static

        # ---- local grads on the assigned model ----
        gs = grads(assigned(models, assign), keep)           # (S, N, P)
        if faulty:
            # the faulty channel lives on the ORIGINAL trace's shadow
            # device range: _split_trace pads kind-3 rows out of both
            gs = gs * trace_faulty_scale(trace, N, epoch)[..., None]

        # ---- per-model weighted aggregation ----
        onehot_t = (assign[:, None, :] == slots[None, :, None]).to(
            torch.float32)                                   # (S, M, N)
        w = counts * a_dev                                   # (S, N)
        denom = torch.bmm(onehot_t, w[..., None])[..., 0]    # (S, M)
        num = torch.bmm(onehot_t, gs * w[..., None])         # (S, M, P)
        mean = num / torch.clamp_min(denom, 1e-30)[..., None]
        gate = (denom > 0).to(torch.float32) * a_grp
        models = models - cfg.lr * gate[..., None] * mean

        # per-sample min over LIVE models only (padded slots hold
        # untrained inits whose scores must not leak into the loss)
        scores = scores_of(models)
        losses[:, epoch] = torch.where(live[..., None], scores,
                                       inf).amin(1).mean(-1)
    return MultiOutputs(losses, scores_of(models), assign), models


def run_multimodel(model: ModelLike, device_x: np.ndarray,
                   device_counts: np.ndarray, test_x: np.ndarray,
                   test_y: np.ndarray, cfg: MultiModelConfig,
                   failure: Failure = NO_FAILURE,
                   draws: Optional[MultiDraws] = None,
                   device: DeviceLike = None) -> MultiModelResult:
    """One scenario: the round loop at S = 1.  ``draws`` are ``cfg.seed``'s
    (default: :func:`default_draws`); dropout draws from a generator
    seeded with ``cfg.seed``."""
    dev = resolve_device(device)
    sim._use_f32_matmul()
    det = D.as_detector(model)
    dx, counts, valid = prepare_multimodel_arrays(device_x, device_counts,
                                                  dev)
    if dx.shape[0] != cfg.num_devices:
        raise ValueError(f"device data for {dx.shape[0]} devices, but the "
                         f"config has {cfg.num_devices}")
    tx = torch.as_tensor(np.asarray(test_x, np.float32), device=dev)
    trace = stack_traces([as_multimodel_trace(failure, cfg.num_devices,
                                              device=dev)])
    M = cfg.num_models
    tables = _draw_tables(det, cfg.scheme, [cfg.seed],
                          None if draws is None else [draws],
                          cfg.num_devices, M, dev)
    out, _ = _multimodel_loop(
        det, cfg, tables.layout, tables.inits,
        torch.ones((1, M), dtype=torch.float32, device=dev), dx, counts,
        valid, tx, trace, tables.probe, tables.perm, tables.reseed,
        dropout_seed=cfg.seed)
    out = sim.outputs_to_host(out)      # the one copy to the host
    final_scores = out.final_scores[0]                       # (M, T)
    per_model = auroc_batch(final_scores, np.asarray(test_y))
    multi = auroc_batch(final_scores.min(axis=0, keepdims=True),
                        np.asarray(test_y))[0]
    return MultiModelResult(float(np.max(per_model)), float(multi),
                            out.losses[0], out.assignments[0])
