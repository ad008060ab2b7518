"""Tol-FL aggregation algebra (paper Algorithm 1 / 2, Appendix A eq. 1-2).

Port of ``repro.core.aggregation`` on stacked tensors (a params tree goes
through :class:`repro_torch.models.params.FlatLayout` first).  The
streaming weighted mean

    n <- n + n_i
    r  = n_i / n
    g <- r g_i + (1 - r) g

equals the direct sample-weighted mean regardless of grouping (the
paper's k-invariance).  :func:`stacked_streaming_mean` runs the
hand-written ``tolfl_combine`` kernel on a CUDA tensor and its plain
PyTorch version on a CPU tensor.  :func:`round_update`, the simulator's
aggregation, runs :func:`cluster_reduce`, the streaming combine and the
SGD step as one kernel the same way.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.kernels import ops


def combine_pair(n_a: torch.Tensor, g_a: torch.Tensor, n_b: torch.Tensor,
                 g_b: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """One streaming-mean step: absorb (n_b, g_b) into running (n_a, g_a).

    Weights are sample counts; zero-count operands are absorbed as no-ops
    (the failure-masking path)."""
    n = n_a + n_b
    r = torch.where(n > 0, n_b / torch.clamp_min(n, 1e-30),
                    torch.zeros_like(n))
    # the weights in g's dtype, as repro casts them (a no-op for float32)
    return n, (1.0 - r).to(g_a.dtype) * g_a + r.to(g_a.dtype) * g_b


def stacked_streaming_mean(gs: torch.Tensor, ns: torch.Tensor
                           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The streaming mean over the leading axis of ``gs`` (k, ...) with
    counts ``ns`` (k,): returns (total count, combined (...)).  The
    combine is the ``tolfl_combine`` kernel over the flattened trailing
    axes."""
    k = gs.shape[0]
    g = ops.tolfl_combine(gs.reshape(k, -1), ns, device=gs.device)
    return torch.sum(ns), g.reshape(gs.shape[1:])


def round_update(gs: torch.Tensor, counts: torch.Tensor, w: torch.Tensor,
                 scale: Optional[torch.Tensor], cluster_ids: torch.Tensor,
                 params: torch.Tensor, lr: float, num_clusters: int
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """A round's aggregation over a leading scenario axis S: the
    per-cluster FedAvg of the device deltas ``gs`` (S, N, P), each scaled
    by ``scale`` (S, N) (the faulty channel, or None) and weighted by
    ``counts * w``; the streaming combine over the clusters; then
    ``params - lr * has_update * g`` on ``params`` (S, P).  Returns the
    new params (S, P) and the total counts (S,).  The fused
    ``tolfl_round_update`` kernel reads each delta once; the cluster sums
    run in device order, one fused multiply-add a term, where
    :func:`cluster_reduce` forms a one-hot product."""
    return ops.tolfl_round_update(gs, counts, w, scale, cluster_ids, params,
                                  lr, num_clusters, device=gs.device)


def weighted_mean(gs: torch.Tensor, ns: torch.Tensor) -> torch.Tensor:
    """Direct sample-weighted mean over the leading axis (the
    algebraically-equal one-reduction form)."""
    w = ns / torch.clamp_min(torch.sum(ns), 1e-30)
    return torch.sum(w.reshape((-1,) + (1,) * (gs.dim() - 1)) * gs, dim=0)


def cluster_reduce(gs: torch.Tensor, ns: torch.Tensor,
                   cluster_ids: torch.Tensor, num_clusters: int
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-cluster FedAvg (Algorithm 1 inner loop): stacked device grads
    (N, ...) -> cluster grads (k, ...) + counts (k,).  A cluster with no
    samples gets a zero gradient and a zero count."""
    # one-hot by comparison: F.one_hot checks its indices on the host,
    # which would cost the round loop a device sync
    onehot = (cluster_ids[:, None] == torch.arange(
        num_clusters, device=cluster_ids.device)[None, :]).to(torch.float32)
    n_c = onehot.T @ ns                                      # (k,)
    flat = gs.reshape(gs.shape[0], -1).to(torch.float32)
    num = onehot.T @ (flat * ns[:, None])
    red = num / torch.clamp_min(n_c[:, None], 1e-30)
    return red.reshape((num_clusters,) + tuple(gs.shape[1:])), n_c
