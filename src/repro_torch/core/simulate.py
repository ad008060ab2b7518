"""Paper-scale Tol-FL simulator (Tables III-VI, Figures 4-5) in PyTorch.

Port of ``repro.core.simulate``.  N federated devices train a detector
body (the paper's autoencoder, or ``SeqDetector``, whose gradient runs
through the RG-LRU scan's backward kernel) with the single-model
schemes — Batch (centralised), FL (k=1), SBT (k=N), Tol-FL (1<k<N) —
under client / server failures.
Where ``repro`` jits one ``lax.scan`` over rounds, the port runs a
Python loop over rounds on one device, for S scenarios at once (a leading
scenario axis; ``run_simulation`` and ``trained_params`` run S = 1,
:mod:`repro_torch.core.campaign` a whole grid):

* the S*N per-device gradients come from ONE batched forward pass
  (params with leading scenario and device axes) and one
  ``torch.autograd.grad`` of the summed per-device losses; devices are
  independent, so row (s, i) of the gradient is device i's gradient in
  scenario s;
* params are one flat f32 vector a scenario (:class:`FlatLayout`), so a
  round's gradients are an (S, N, P) tensor; the per-cluster FedAvg, the
  streaming combine across cluster heads and the SGD step are one
  hand-written CUDA kernel (``aggregation.round_update``) that reads
  them once, for all S scenarios.
  ``combine="direct"`` runs ``repro``'s direct form instead, in plain
  PyTorch: ``cluster_reduce`` then ``weighted_mean``;
* failure masks, head-failure weights and the update gate stay device
  tensors that multiply: the loop never waits on the host.  Losses and
  scores are copied to the host once, after the loop.

FL server failure triggers the paper's fallback: remaining devices
continue training *isolated* local models (Section V-C / Fig 4); the
reported metric then averages the independent devices.

RNG: torch cannot reproduce ``repro``'s threefry draws.  Both entry
points take ``params0`` (e.g. ``repro``'s init through
:func:`repro_torch.models.params.from_numpy_tree`); without it the port
draws its own init from a CPU ``torch.Generator`` seeded with
``cfg.seed``.  Dropout draws from a generator on the simulation device
seeded with ``cfg.seed``.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch import DeviceLike, resolve_device
from repro_torch.core import aggregation as agg
from repro_torch.core.failure import (NO_FAILURE, Failure, FailureTrace,
                                      as_trace, effective_weights_arrays,
                                      stack_traces, trace_alive_mask,
                                      trace_faulty_scale)
from repro_torch.core.topology import Topology
from repro_torch.models import detector as D
from repro_torch.models.detector import DetectorModel, ModelLike
from repro_torch.models.params import FlatLayout, Params, tree_items
from repro_torch.training.metrics import auroc, auroc_batch


@dataclass(frozen=True)
class SimConfig:
    scheme: str = "tolfl"          # batch | fl | sbt | tolfl
    num_devices: int = 10
    num_clusters: int = 5          # k (tolfl); fl -> 1, sbt -> N
    rounds: int = 100
    lr: float = 1e-3
    local_epochs: int = 1          # E local steps per round
    combine: str = "streaming"     # streaming (faithful) | direct
    dropout: bool = True
    seed: int = 0

    def topology(self) -> Topology:
        if self.scheme == "batch":
            return Topology(1, 1)
        if self.scheme == "fl":
            return Topology(self.num_devices, 1)
        if self.scheme == "sbt":
            return Topology(self.num_devices, self.num_devices)
        return Topology(self.num_devices, self.num_clusters)


@dataclass(frozen=True)
class FaultySimConfig(SimConfig):
    """The faulty-update engine variant: identical training except the
    TRANSMITTED per-device deltas are scaled by the trace's faulty
    channel (:func:`repro_torch.core.failure.trace_faulty_scale`) before
    the hierarchical combine.  Local/isolated training stays clean."""
    faulty_updates: bool = True


@dataclass
class SimResult:
    final_auroc: float
    iso_auroc: float               # mean of isolated devices (fl fallback)
    auroc_used: float              # what the paper would report
    loss_curve: np.ndarray         # (rounds,) REPORTED test loss: global
    #                                model, except that FL server-dead
    #                                rounds carry the isolated mean (Fig 4)
    auroc_curve: np.ndarray        # (rounds,) reported AUROC, same switch
    iso_loss_curve: np.ndarray     # (rounds,) alive-mean isolated loss
    iso_active: bool
    rounds_to_loss: Optional[int] = None


class SimOutputs(NamedTuple):
    """Raw outputs of one simulated scenario (pre-AUROC), on the device."""
    losses: torch.Tensor            # (rounds,) global-model test loss
    iso_losses: torch.Tensor        # (rounds,) alive-mean isolated loss
    final_scores: torch.Tensor      # (T,) anomaly scores of the final model
    iso_final_scores: torch.Tensor  # (N, T) per-device isolated scores
    final_alive: torch.Tensor       # (N,) alive mask at the last round
    server_dead: torch.Tensor       # () 1.0 iff every cluster head is dead
    server_dead_rounds: torch.Tensor  # (rounds,) 1.0 where all heads dead
    score_hist: torch.Tensor        # (rounds, T) or (rounds, 0)
    iso_score_hist: torch.Tensor    # (rounds, N, T) or (rounds, 0, 0)


def _use_f32_matmul() -> None:
    """The reference is f32: keep the card's float32 products and
    convolutions out of TF32 on the simulator's path."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def _device_grads(det: DetectorModel, layout: FlatLayout,
                  flat: torch.Tensor, dx: torch.Tensor, valid: torch.Tensor,
                  generator: Optional[torch.Generator],
                  dropout_masks: Optional[Sequence[torch.Tensor]] = None
                  ) -> torch.Tensor:
    """(S, N, P) per-device params -> (S, N, P) per-device loss
    gradients, from one batched forward pass over the S*N parameter rows
    and one backward pass.  The gradients are taken with respect to the
    per-layer views and concatenated once: with respect to the flat
    tensor, each view's backward would scatter into a zero (S, N, P)
    tensor of its own and the sum of those would move P / layer-size
    times the gradient's bytes.  Dropout draws from ``generator`` or
    applies ``dropout_masks`` (see ``DetectorModel.loss``)."""
    leaf = flat.detach().contiguous().requires_grad_(True)
    with torch.enable_grad():
        tree = layout.unflatten(leaf)
        views = [v for _, v in tree_items(tree)]
        losses = det.loss(tree, dx, valid, generator, dropout_masks)
        grads = torch.autograd.grad(losses.sum(), views)
    lead = flat.shape[:-1]
    return torch.cat([g.reshape(*lead, -1) for g in grads], dim=-1)


def _local_delta(det: DetectorModel, cfg: SimConfig, layout: FlatLayout,
                 flat: torch.Tensor, dx: torch.Tensor, valid: torch.Tensor,
                 generator: Optional[torch.Generator]) -> torch.Tensor:
    """E local SGD steps; returns the (negated-gradient-like) delta/lr.
    With E=1 this is exactly the local gradient (paper Algorithm 1)."""
    if cfg.local_epochs == 1:
        return _device_grads(det, layout, flat, dx, valid, generator)
    p = flat
    for _ in range(cfg.local_epochs):
        p = p - cfg.lr * _device_grads(det, layout, p, dx, valid, generator)
    # pseudo-gradient: (theta - theta_local) / lr
    return (flat - p) / cfg.lr


def _round_loop(det: DetectorModel, cfg: SimConfig, layout: FlatLayout,
                params0: torch.Tensor, dx: torch.Tensor, counts: torch.Tensor,
                valid: torch.Tensor, tx: torch.Tensor,
                cluster_ids: torch.Tensor, heads: torch.Tensor,
                head_valid: torch.Tensor, trace: FailureTrace,
                num_clusters: int, track_iso: bool, score_history: bool,
                dropout_seed: int
                ) -> Tuple[SimOutputs, torch.Tensor, torch.Tensor]:
    """The round loop of ``repro``'s ``_build_core_arrays`` for S
    scenarios at once: returns the outputs (each with a leading S axis),
    the final flat params (S, P) and the isolated params (S, N, P).

    Per scenario: ``params0`` (S, P), ``cluster_ids`` (S, N) int32 (the
    caller checks that they lie in [0, num_clusters)), ``heads`` and
    ``head_valid`` (S, num_clusters) and a stacked ``trace`` of (S, M)
    fields.  The device data ``dx`` (N, n_max, D), ``counts`` (N,),
    ``valid`` (N, n_max) and the test rows ``tx`` (T, D) are shared.
    Padded cluster slots (``head_valid`` 0, named by no device) are exact
    no-ops; zeros in ``head_valid`` everywhere make every round an
    all-heads-dead round, so each device trains its own isolated model
    (:func:`trained_params` with ``isolated=True``).

    A round is one batched forward and backward pass over the S*N
    parameter rows, one ``agg.round_update`` launch for all S scenarios
    and the masks as (S, N) device tensors: the loop never waits on the
    host.  Dropout draws from one generator on the device seeded with
    ``dropout_seed``, an (S, N, n_max, width) block a layer, so S = 1
    draws what a single scenario drew before the scenario axis."""
    dev = dx.device
    S, N, R, T = params0.shape[0], dx.shape[0], cfg.rounds, tx.shape[0]
    P = layout.size
    k = num_clusters
    faulty = bool(getattr(cfg, "faulty_updates", False))
    generator = (torch.Generator(device=dev).manual_seed(dropout_seed)
                 if cfg.dropout else None)
    zero = torch.zeros((), dtype=torch.float32, device=dev)
    # one (S, N, n_max, D) copy for the whole loop: the first layer's
    # product and its backward then run as one (S*N)-batched product
    dxs = dx.expand(S, *dx.shape).contiguous()
    ids = cluster_ids.long()                 # for gather; the kernel: int32

    def heads_alive_max(alive):
        """(S,) max over VALID heads only: padded head slots never argue
        the server back to life."""
        return torch.where(head_valid > 0, torch.gather(alive, -1, heads),
                           zero).amax(-1)

    def scores_of(flat):
        return det.anomaly_scores(layout.unflatten(flat), tx)

    params = params0
    iso = params0[:, None, :].expand(S, N, P).clone()
    losses = torch.empty((S, R), dtype=torch.float32, device=dev)
    iso_losses = torch.empty((S, R), dtype=torch.float32, device=dev)
    dead_rounds = torch.empty((S, R), dtype=torch.float32, device=dev)
    score_hist = torch.empty((S, R, T if score_history else 0),
                             dtype=torch.float32, device=dev)
    iso_shape = ((S, R, N, T) if (track_iso and score_history)
                 else (S, R, 0, 0))
    iso_score_hist = torch.empty(iso_shape, dtype=torch.float32, device=dev)

    for epoch in range(R):
        alive = trace_alive_mask(trace, N, epoch)             # (S, N)
        w = effective_weights_arrays(alive, ids, heads)
        head_dead = 1.0 - heads_alive_max(alive)             # (S,)
        if track_iso:
            # One N-way gradient serves BOTH the global combine and the
            # isolated fallback.  While any head is alive the iso rows
            # are reset to ``params``, so these ARE the global-path
            # gradients; on all-heads-dead rounds every effective weight
            # is zero, so the combine is gated off (has_update == 0).
            iso = torch.where(head_dead[:, None, None] > 0, iso,
                              params[:, None, :].expand(S, N, P))
            gs = _local_delta(det, cfg, layout, iso, dxs, valid, generator)
        else:
            gs = _local_delta(det, cfg, layout,
                              params[:, None, :].expand(S, N, P), dxs,
                              valid, generator)
        # the faulty channel corrupts the TRANSMITTED deltas only: the
        # isolated fallback keeps the clean ``gs``
        scale = trace_faulty_scale(trace, N, epoch) if faulty else None
        # ---- Tol-FL hierarchical combine (Algorithm 1) and SGD step ----
        if cfg.combine == "streaming":
            params, _ = agg.round_update(gs, counts, w, scale, cluster_ids,
                                         params, cfg.lr, k)
        else:
            stepped = []
            for s in range(S):
                gs_tx = gs[s] if scale is None else gs[s] * scale[s, :, None]
                cluster_gs, n_c = agg.cluster_reduce(gs_tx, counts * w[s],
                                                     ids[s], k)
                g = agg.weighted_mean(cluster_gs, n_c)
                has_update = (torch.sum(n_c) > 0).to(torch.float32)
                stepped.append(params[s] - cfg.lr * has_update * g)
            params = torch.stack(stepped)

        # ---- isolated fallback (fl server failure) ----
        if track_iso:
            iso_step = head_dead[:, None] * alive  # only alive devices train
            iso = iso - cfg.lr * iso_step[:, :, None] * gs
            iso_scores = scores_of(iso)                      # (S, N, T)
            # Fig 4 reporting averages the surviving devices only
            iso_losses[:, epoch] = (
                torch.sum(alive * iso_scores.mean(-1), -1)
                / torch.clamp_min(torch.sum(alive, -1), 1.0))
            if score_history:
                iso_score_hist[:, epoch] = iso_scores
        else:
            iso_losses[:, epoch] = zero
        scores = scores_of(params)                           # (S, T)
        losses[:, epoch] = scores.mean(-1)
        if score_history:
            score_hist[:, epoch] = scores
        dead_rounds[:, epoch] = head_dead

    final_alive = trace_alive_mask(trace, N, R - 1)
    iso_final = (scores_of(iso) if track_iso
                 else torch.zeros((S, N, 0), dtype=torch.float32, device=dev))
    out = SimOutputs(losses, iso_losses, scores_of(params), iso_final,
                     final_alive, 1.0 - heads_alive_max(final_alive),
                     dead_rounds, score_hist, iso_score_hist)
    return out, params, iso


def outputs_to_host(out):
    """A NamedTuple of device tensors (:class:`SimOutputs`, or
    ``baselines.MultiOutputs``) as numpy arrays, in ONE copy from the
    device: every field travels as float32 in one flat tensor and is split
    again on the host.  Integer fields (the multi-model assignments) get
    their dtype back; float32 holds them exactly below 2**24."""
    flat = torch.cat([t.reshape(-1).to(torch.float32)
                      for t in out]).cpu().numpy()
    parts, off = [], 0
    for t in out:
        n = t.numel()
        part = flat[off:off + n].reshape(tuple(t.shape))
        if t.dtype != torch.float32:
            part = part.astype(_HOST_DTYPES[t.dtype])
        parts.append(part)
        off += n
    return type(out)(*parts)


_HOST_DTYPES = {torch.int64: np.int64, torch.int32: np.int32}


def _prepare_arrays(cfg: SimConfig, device_x: np.ndarray,
                    device_counts: np.ndarray, device: torch.device):
    """Scheme-aware device arrays: batch centralises all data onto the
    single server device."""
    if cfg.scheme == "batch":
        flat = np.concatenate([device_x[i, :device_counts[i]]
                               for i in range(len(device_counts))], 0)
        device_x = flat[None]
        device_counts = np.array([len(flat)])
    return device_arrays(device_x, device_counts, device)


def device_arrays(device_x: np.ndarray, device_counts: np.ndarray,
                  device: DeviceLike = None):
    """(dx (N, n_max, D), counts (N,), valid (N, n_max)) float32 on
    ``device``, from padded per-device rows and their counts."""
    device = resolve_device(device)
    dx = torch.as_tensor(np.asarray(device_x, np.float32), device=device)
    counts = torch.as_tensor(np.asarray(device_counts), device=device).to(
        torch.float32)
    valid = (torch.arange(dx.shape[1], device=device)[None, :]
             < counts[:, None]).to(torch.float32)          # (N, n_max)
    return dx, counts, valid


def topology_arrays(topo: Topology, k_pad: Optional[int] = None):
    """(cluster_ids (N,) int32, heads (k_pad,) int64, head_valid (k_pad,)
    float32) of ``topo`` as numpy, the cluster axis padded to ``k_pad``
    (default: no padding).  Padded head slots point at device 0 and are
    invalid; no device maps to a padded cluster.  Checked here, on the
    host, once: the fused kernel takes the ids unchecked."""
    k_pad = topo.num_clusters if k_pad is None else k_pad
    cids, head_ids = topo.device_cluster_array(), np.array(topo.heads)
    if (k_pad < topo.num_clusters or cids.shape != (topo.num_devices,)
            or cids.min() < 0 or cids.max() >= topo.num_clusters
            or head_ids.shape != (topo.num_clusters,) or head_ids.min() < 0
            or head_ids.max() >= topo.num_devices):
        raise ValueError(f"bad topology arrays: cluster ids {cids}, heads "
                         f"{head_ids} for {topo} padded to {k_pad}")
    heads = np.zeros(k_pad, np.int64)
    heads[:topo.num_clusters] = head_ids
    head_valid = np.zeros(k_pad, np.float32)
    head_valid[:topo.num_clusters] = 1.0
    return cids.astype(np.int32), heads, head_valid


def _scenario(model: ModelLike, device_x: np.ndarray,
              device_counts: np.ndarray, test_x: Optional[np.ndarray],
              cfg: SimConfig, failure: Failure, params0: Optional[Params],
              device: DeviceLike, isolated: bool, track_iso: bool,
              score_history: bool):
    """Set up one scenario on the device and run the round loop at S = 1.

    Returns (outputs, trace, layout, final flat params, iso flat params),
    without the scenario axis.  ``test_x=None`` scores one zero row: the
    params export needs no test sweep.  ``isolated`` zeroes the
    cluster-head validity mask."""
    dev = resolve_device(device)
    _use_f32_matmul()
    det = D.as_detector(model)
    topo = cfg.topology()
    trace = as_trace(failure, topo, device=dev)
    dx, counts, valid = _prepare_arrays(cfg, device_x, device_counts, dev)
    assert dx.shape[0] == topo.num_devices, (dx.shape, topo.num_devices)
    tx = (torch.zeros((1, dx.shape[-1]), dtype=dx.dtype, device=dev)
          if test_x is None
          else torch.as_tensor(np.asarray(test_x, np.float32), device=dev))
    cids, heads, head_valid = (torch.as_tensor(a, device=dev)[None]
                               for a in topology_arrays(topo))
    if isolated:
        head_valid = torch.zeros_like(head_valid)
    if params0 is None:
        params0 = det.init_params(torch.Generator().manual_seed(cfg.seed),
                                  device=dev)
    layout = FlatLayout.of(params0)
    out, params, iso = _round_loop(
        det, cfg, layout, layout.flatten(params0).to(dev)[None], dx, counts,
        valid, tx, cids, heads, head_valid, stack_traces([trace]),
        topo.num_clusters, track_iso=track_iso, score_history=score_history,
        dropout_seed=cfg.seed)
    return SimOutputs(*(t[0] for t in out)), trace, layout, params[0], iso[0]


# ---------------------------------------------------------------------------
# Params export (the serving layer's model bank)
# ---------------------------------------------------------------------------
def trained_params(model: ModelLike, device_x: np.ndarray,
                   device_counts: np.ndarray, cfg: SimConfig,
                   failure: Failure = NO_FAILURE, isolated: bool = False,
                   params0: Optional[Params] = None,
                   device: DeviceLike = None):
    """Train one scenario and export its parameters.

    Returns ``(global_params, iso_params, final_alive)`` on the device:
    the scheme's final global model, the per-device isolated models
    (leaves carry a leading ``(N,)`` axis), and the final alive mask.
    With ``isolated=True`` the cluster-head validity mask is zeroed so
    every device trains its OWN model on its local shard from the shared
    init — the isolated failover models a scoring service banks."""
    out, _, layout, params, iso = _scenario(
        model, device_x, device_counts, None, cfg, failure, params0, device,
        isolated=isolated, track_iso=True, score_history=False)
    return layout.unflatten(params), layout.unflatten(iso), out.final_alive


def iso_mean_auroc(iso_scores: np.ndarray, final_alive: np.ndarray,
                   test_y: np.ndarray) -> float:
    """Paper Fig 4 reporting: mean AUROC over the *alive* isolated
    devices (the dead server keeps its frozen model and is excluded)."""
    per_dev = [auroc(iso_scores[i], test_y)
               for i in range(iso_scores.shape[0]) if final_alive[i] > 0]
    return float(np.mean(per_dev)) if per_dev else float("nan")


def run_simulation(model: ModelLike, device_x: np.ndarray,
                   device_counts: np.ndarray, test_x: np.ndarray,
                   test_y: np.ndarray, cfg: SimConfig,
                   failure: Failure = NO_FAILURE,
                   target_loss: Optional[float] = None,
                   params0: Optional[Params] = None,
                   device: DeviceLike = None) -> SimResult:
    """device_x: (N, n_max, D) padded; device_counts: (N,).

    ``model`` is a :class:`repro_torch.models.detector.DetectorModel` or
    a raw :class:`AutoencoderConfig`; ``failure`` a single-event
    :class:`FailureSpec` or a multi-event :class:`FailureTrace`."""
    track_iso = (cfg.scheme == "fl")
    out, trace, _, _, _ = _scenario(
        model, device_x, device_counts, test_x, cfg, failure, params0,
        device, isolated=False, track_iso=track_iso, score_history=True)
    out = outputs_to_host(out)      # the one copy to the host, after the loop
    N = cfg.topology().num_devices

    losses = out.losses.copy()
    aurocs = auroc_batch(out.score_hist, np.asarray(test_y))
    final = float(aurocs[-1])

    # isolated final AUROC: mean over alive devices of per-device AUROC
    dead_rounds = out.server_dead_rounds > 0                # (rounds,)
    fl_server_fallback = track_iso and bool(dead_rounds[-1])
    iso_final = float("nan")
    if fl_server_fallback:
        iso_final = iso_mean_auroc(out.iso_final_scores, out.final_alive,
                                   test_y)

    # Fig 4 semantics: from the round the FL server dies the global model
    # is frozen and meaningless — the reported curves switch to the
    # isolated-mean curve for every server-dead round (a later recovery
    # switches back).
    if track_iso and dead_rounds.any():
        host_trace = trace.to(torch.device("cpu"))
        for t in np.flatnonzero(dead_rounds):
            alive_t = trace_alive_mask(host_trace, N, int(t)).numpy()
            aurocs[t] = iso_mean_auroc(out.iso_score_hist[t], alive_t,
                                       test_y)
            losses[t] = out.iso_losses[t]

    used = iso_final if fl_server_fallback else final
    r2l = None
    if target_loss is not None:
        hit = np.where(losses <= target_loss)[0]
        r2l = int(hit[0]) + 1 if len(hit) else None
    return SimResult(final, iso_final, used, losses, aurocs,
                     out.iso_losses, fl_server_fallback, r2l)


# ---------------------------------------------------------------------------
# Resource-usage models (Table II / VI, Fig 5)
# ---------------------------------------------------------------------------
def comm_transfers_per_round(scheme: str, n: int, k: int) -> int:
    """Model transfers per training round (Table VI accounting)."""
    if scheme == "batch":
        return 0
    if scheme == "fl":
        return 2 * n                       # broadcast + gather
    if scheme == "sbt":
        return n - 1                       # sequential ring pass
    if scheme == "tolfl":
        # members -> heads (n - k), head chain (k - 1), head broadcast (k)
        return n + k - 1
    raise ValueError(scheme)


def _resolve_model_bytes(model_bytes) -> int:
    """``model_bytes`` may be a raw byte count or any detector spec /
    AutoencoderConfig (sized over its actual parameter tree)."""
    if isinstance(model_bytes, (int, float, np.integer, np.floating)):
        return int(model_bytes)
    return D.as_detector(model_bytes).param_bytes()


def comm_mb_per_round(scheme: str, n: int, k: int, model_bytes) -> float:
    return (comm_transfers_per_round(scheme, n, k)
            * _resolve_model_bytes(model_bytes) / 1e6)


def round_time_model(scheme: str, n: int, k: int, samples: int,
                     model_bytes, flops_per_sample: float,
                     device_flops: float = 5e9, link_bw: float = 10e6
                     ) -> float:
    """Seconds per round under the paper's Section IV-A task-sequencing
    model: parallel stages take the max over participants, sequential
    stages sum.  link_bw in bytes/s (wireless-ish)."""
    t_model = _resolve_model_bytes(model_bytes) / link_bw
    per_dev = samples / max(n, 1) * flops_per_sample / device_flops
    if scheme == "batch":
        return samples * flops_per_sample / device_flops
    if scheme == "fl":
        return per_dev + 2 * t_model
    if scheme == "sbt":
        return per_dev + (n - 1) * t_model
    if scheme == "tolfl":
        return per_dev + 2 * t_model + (k - 1) * t_model
    raise ValueError(scheme)
