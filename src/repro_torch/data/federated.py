"""Federated data partitioning (paper Section V-A / Appendix B).

The port's copy of ``repro.data.federated`` (pure numpy): the same seed
gives byte-identical arrays.

Datasets are cast as anomaly-detection tasks by designating one or more
classes "anomalous"; the remaining classes are divided amongst devices.
Where clusters are present, data is assigned one class (or class group)
per cluster, then subdivided equally amongst the cluster's devices —
|D_i| = N_i <= ceil(N/k) per the paper.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import List, Sequence, Tuple

import numpy as np


@dataclass
class FederatedSplit:
    """Per-device training arrays + shared test set."""
    device_data: List[np.ndarray]            # N arrays (n_i, D)
    test_x: np.ndarray                       # (T, D)
    test_y: np.ndarray                       # (T,) 1 = anomalous
    clusters: List[List[int]]                # device ids per cluster

    @property
    def num_devices(self) -> int:
        return len(self.device_data)

    def sample_counts(self) -> np.ndarray:
        return np.array([len(d) for d in self.device_data])


def make_split(X: np.ndarray, y: np.ndarray, num_devices: int,
               num_clusters: int, anomaly_classes: Sequence[int],
               seed: int = 0, test_frac: float = 0.25) -> FederatedSplit:
    """Class-per-cluster partitioning.

    Normal classes are grouped round-robin over clusters; each cluster's
    pool is split equally over its devices.  The test set mixes held-out
    normal samples with all anomaly-class samples (labelled 1).
    """
    assert num_devices % num_clusters == 0, (num_devices, num_clusters)
    rng = np.random.default_rng(seed)
    anomaly_classes = set(anomaly_classes)
    normal_classes = [c for c in sorted(set(y.tolist()))
                      if c not in anomaly_classes]
    per_cluster = num_devices // num_clusters
    clusters = [list(range(i * per_cluster, (i + 1) * per_cluster))
                for i in range(num_clusters)]

    # assign normal classes to clusters round-robin
    cluster_pool: List[List[np.ndarray]] = [[] for _ in range(num_clusters)]
    test_norm = []
    for j, c in enumerate(normal_classes):
        idx = np.where(y == c)[0]
        rng.shuffle(idx)
        n_test = int(len(idx) * test_frac)
        test_norm.append(X[idx[:n_test]])
        cluster_pool[j % num_clusters].append(X[idx[n_test:]])

    device_data: List[np.ndarray] = [None] * num_devices  # type: ignore
    for ci, devs in enumerate(clusters):
        pool = (np.concatenate(cluster_pool[ci], 0) if cluster_pool[ci]
                else np.zeros((0, X.shape[1]), X.dtype))
        rng.shuffle(pool)
        parts = np.array_split(pool, len(devs))
        for d, part in zip(devs, parts):
            device_data[d] = part.astype(np.float32)

    anom = X[np.isin(y, list(anomaly_classes))]
    test_x = np.concatenate(test_norm + [anom], 0).astype(np.float32)
    test_y = np.concatenate([np.zeros(sum(len(t) for t in test_norm)),
                             np.ones(len(anom))]).astype(np.int32)
    return FederatedSplit(device_data, test_x, test_y, clusters)


def pad_devices(split: FederatedSplit) -> Tuple[np.ndarray, np.ndarray]:
    """Stack device datasets into a dense (N, max_n, D) tensor + count
    vector, so the whole federation vmaps (simulator engine)."""
    n_max = max(len(d) for d in split.device_data)
    D = split.device_data[0].shape[1]
    out = np.zeros((split.num_devices, n_max, D), np.float32)
    cnt = np.zeros((split.num_devices,), np.int32)
    for i, d in enumerate(split.device_data):
        out[i, :len(d)] = d
        cnt[i] = len(d)
    return out, cnt
