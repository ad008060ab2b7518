"""Evaluation metrics: exact AUROC (rank statistic), ROC curve, loss stats.

Port of ``repro.training.metrics``.  The AUROC and ROC functions are host
numpy, copied so they give identical outputs; ``reconstruction_error``
is torch.  AUROC is computed via the Mann-Whitney U statistic with
average ranks for ties.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np
import torch


def auroc(scores: np.ndarray, labels: np.ndarray) -> float:
    """labels: 1 = anomalous (positive), 0 = normal.  Higher score => more
    anomalous.  Returns P(score_pos > score_neg) + 0.5 P(equal)."""
    scores = np.asarray(scores, np.float64).ravel()
    labels = np.asarray(labels).ravel().astype(bool)
    n_pos = int(labels.sum())
    n_neg = labels.size - n_pos
    if n_pos == 0 or n_neg == 0:
        return float("nan")
    order = np.argsort(scores, kind="mergesort")
    ranks = np.empty_like(scores)
    ranks[order] = np.arange(1, scores.size + 1, dtype=np.float64)
    # average ranks for ties
    sorted_scores = scores[order]
    i = 0
    while i < scores.size:
        j = i
        while j + 1 < scores.size and sorted_scores[j + 1] == sorted_scores[i]:
            j += 1
        if j > i:
            avg = 0.5 * (i + 1 + j + 1)
            ranks[order[i:j + 1]] = avg
        i = j + 1
    r_pos = ranks[labels].sum()
    u = r_pos - n_pos * (n_pos + 1) / 2.0
    return float(u / (n_pos * n_neg))


def auroc_batch(scores: np.ndarray, labels: np.ndarray) -> np.ndarray:
    """(B,) AUROC of every row of ``scores`` (B, T) against one shared
    ``labels`` (T,) — exactly :func:`auroc`, vectorized across rows (tie
    groups found with running max/min scans over the sorted axis)."""
    scores = np.asarray(scores, np.float64)
    assert scores.ndim == 2, scores.shape
    labels = np.asarray(labels).ravel().astype(bool)
    B, T = scores.shape
    assert labels.shape == (T,), (labels.shape, T)
    n_pos = int(labels.sum())
    n_neg = T - n_pos
    if n_pos == 0 or n_neg == 0:
        return np.full(B, np.nan)
    order = np.argsort(scores, axis=1, kind="mergesort")
    srt = np.take_along_axis(scores, order, axis=1)
    pos = np.broadcast_to(np.arange(T, dtype=np.float64), (B, T))
    is_start = np.ones((B, T), bool)
    is_start[:, 1:] = srt[:, 1:] != srt[:, :-1]
    is_end = np.ones((B, T), bool)
    is_end[:, :-1] = is_start[:, 1:]
    start = np.maximum.accumulate(np.where(is_start, pos, 0.0), axis=1)
    end = np.minimum.accumulate(
        np.where(is_end, pos, T - 1.0)[:, ::-1], axis=1)[:, ::-1]
    avg_rank_sorted = 0.5 * (start + end) + 1.0   # 1-based average rank
    ranks = np.empty_like(avg_rank_sorted)
    np.put_along_axis(ranks, order, avg_rank_sorted, axis=1)
    r_pos = ranks[:, labels].sum(axis=1)
    u = r_pos - n_pos * (n_pos + 1) / 2.0
    return u / (n_pos * n_neg)


def roc_curve(scores: np.ndarray, labels: np.ndarray, points: int = 200
              ) -> Tuple[np.ndarray, np.ndarray]:
    """(fpr, tpr) arrays at ascending thresholds, closed at BOTH ends:
    score quantiles plus the exact minimum (the (1, 1) corner) and a +inf
    sentinel (the (0, 0) corner)."""
    scores = np.asarray(scores, np.float64).ravel()
    labels = np.asarray(labels).ravel().astype(bool)
    thr = np.quantile(scores, np.linspace(0, 1, points))
    thr = np.unique(np.concatenate([[scores.min()], thr, [np.inf]]))
    tpr = np.array([(scores[labels] >= t).mean() for t in thr])
    fpr = np.array([(scores[~labels] >= t).mean() for t in thr])
    return fpr, tpr


def reconstruction_error(x: torch.Tensor, x_hat: torch.Tensor
                         ) -> torch.Tensor:
    """Per-sample squared L2 reconstruction error (the anomaly score)."""
    d = (x - x_hat).reshape(x.shape[0], -1).to(torch.float32)
    return torch.sum(torch.square(d), dim=-1)
