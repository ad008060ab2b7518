"""Tol-FL topology: cluster structure over the federated device set.

The port's copy of ``repro.core.topology`` (pure numpy, byte-identical
arrays).  k clusters partition the N devices into contiguous blocks;
member 0 of each block is the cluster head.  The mesh-engine plumbing
(psum index groups, ppermute ring) comes with the mesh-engine slice.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import List, Tuple

import numpy as np


@dataclass(frozen=True)
class Topology:
    num_devices: int          # simulated N
    num_clusters: int         # k

    def __post_init__(self):
        assert 1 <= self.num_clusters <= self.num_devices
        assert self.num_devices % self.num_clusters == 0, \
            "clusters must evenly partition the device set"

    @property
    def members_per_cluster(self) -> int:
        return self.num_devices // self.num_clusters

    @property
    def clusters(self) -> List[List[int]]:
        m = self.members_per_cluster
        return [list(range(c * m, (c + 1) * m))
                for c in range(self.num_clusters)]

    @property
    def heads(self) -> List[int]:
        """Cluster-head device index per cluster (member 0)."""
        return [c[0] for c in self.clusters]

    def cluster_of(self, device: int) -> int:
        return device // self.members_per_cluster

    def is_head(self, device: int) -> bool:
        return device % self.members_per_cluster == 0

    # ---------------- collective plumbing ----------------
    def psum_index_groups(self) -> List[List[int]]:
        """Rank groups of the intra-cluster FedAvg all-reduce."""
        return self.clusters

    def ring_perms(self) -> List[List[Tuple[int, int]]]:
        """One (source, target) pair per sequential SBT hop: hop i moves
        the running (n, g) pair from head_i to head_{i+1}."""
        h = self.heads
        return [[(h[i], h[i + 1])] for i in range(len(h) - 1)]

    def device_cluster_array(self) -> np.ndarray:
        """(N,) int cluster id per device."""
        return np.arange(self.num_devices) // self.members_per_cluster

    def head_mask(self) -> np.ndarray:
        """(N,) bool: True where device is a cluster head."""
        return np.arange(self.num_devices) % self.members_per_cluster == 0


def special_cases(n: int) -> dict:
    """The paper's named special cases of Tol-FL(k)."""
    return {"fl": Topology(n, 1), "sbt": Topology(n, n)}
