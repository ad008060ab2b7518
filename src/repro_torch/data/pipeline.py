"""Token data pipeline for the model zoo's training path.

Port of ``repro.data.pipeline``.  A synthetic corpus: a mixture of
Zipfian unigram draws and repeated n-gram motifs (so the LM loss
actually decreases), sharded per Tol-FL data group with disjoint motif
inventories (the federated non-IID layout at datacenter scale).  The
pipeline is numpy only and yields the same host batches as ``repro``'s
for every seed; :func:`shard_batch` puts this rank's rows on its device.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Iterator, Optional

import numpy as np
import torch

from repro_torch.sharding.logical import current_mesh


@dataclasses.dataclass
class TokenPipeline:
    vocab_size: int
    seq_len: int
    global_batch: int
    seed: int = 0
    num_groups: int = 1          # Tol-FL data groups (non-IID shards)
    zipf_a: float = 1.2
    n_motifs: int = 64
    motif_len: int = 16

    def __post_init__(self):
        rng = np.random.default_rng(self.seed)
        v = min(self.vocab_size, 50000)
        self.motifs = rng.integers(
            0, v, size=(self.num_groups, self.n_motifs, self.motif_len),
            dtype=np.int64)
        ranks = np.arange(1, v + 1, dtype=np.float64)
        p = ranks ** (-self.zipf_a)
        self.probs = p / p.sum()
        self.v = v

    def _sample_doc(self, rng, group: int) -> np.ndarray:
        out = rng.choice(self.v, size=self.seq_len + 1, p=self.probs)
        # splice in group-specific motifs (~30% of positions)
        n_splice = (self.seq_len // self.motif_len) // 3
        for _ in range(n_splice):
            m = self.motifs[group, rng.integers(self.n_motifs)]
            pos = rng.integers(0, self.seq_len + 1 - self.motif_len)
            out[pos:pos + self.motif_len] = m
        return out

    def batches(self, num_steps: Optional[int] = None
                ) -> Iterator[Dict[str, np.ndarray]]:
        rng = np.random.default_rng(self.seed + 1)
        step = 0
        per_group = self.global_batch // self.num_groups
        while num_steps is None or step < num_steps:
            docs = np.stack([
                self._sample_doc(rng, g)
                for g in range(self.num_groups) for _ in range(per_group)])
            yield {"tokens": docs[:, :-1].astype(np.int32),
                   "labels": docs[:, 1:].astype(np.int32)}
            step += 1


def shard_batch(batch: Dict[str, np.ndarray], mesh
                ) -> Dict[str, torch.Tensor]:
    """This rank's rows of a host batch on the mesh's device: the batch
    dim is split over the federated groups (pod x data) in rank order, as
    ``repro`` shards it over the mesh.  Integer fields become int64
    tensors (the indices of the embedding and the loss's gather);
    floating ones keep their dtype.  Under an active mesh
    (``repro_torch.sharding.activate_mesh``) each field is a DTensor of
    these rows: ``Shard(0)`` over the pod / data dims, ``Replicate`` over
    model."""
    out = {}
    for k, v in batch.items():
        rows = v.shape[0] // mesh.num_groups
        part = np.ascontiguousarray(v[mesh.group * rows:
                                      (mesh.group + 1) * rows])
        t = torch.from_numpy(part)
        if not t.is_floating_point():
            t = t.to(torch.int64)
        out[k] = t.to(mesh.device)
    if current_mesh() is None:
        return out
    from torch.distributed.tensor import DTensor, Replicate, Shard
    place = [Shard(0) if n in ("pod", "data") else Replicate()
             for n in mesh.axis_names]
    return {k: DTensor.from_local(t, mesh.device_mesh, place,
                                  run_check=False) for k, t in out.items()}
