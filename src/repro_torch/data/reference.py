"""Synthetic stand-ins for the paper's reference datasets (Table VII).

The port's copy of ``repro.data.reference`` (pure numpy): the same seed
gives byte-identical arrays in the same interpreter.  The generator is
seeded with ``seed + hash(name) % 65536``, and Python salts its str hash
per interpreter, so two processes (or two packages compared across
processes) agree only under the same ``PYTHONHASHSEED``.

The container is offline, so FMNIST / CIFAR-10 / CIFAR-100 cannot be
downloaded.  We generate class-structured datasets with the same sample
shapes and class counts.  Each class occupies a *disjoint set of 2-D
Fourier components* (its "texture signature"); samples draw random
amplitudes/phases on their class's components plus pixel noise.  An
autoencoder trained on a subset of classes learns (a basis of) their
joint frequency subspace, so held-out classes — which live on unseen
frequencies — reconstruct badly.  This mirrors the property the paper's
experiments exercise (class-structured anomaly detection); AUROC
magnitudes will not numerically match the paper's tables (different
data); orderings between training schemes — the paper's actual claims —
are reproduced.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Tuple

import numpy as np


@dataclass(frozen=True)
class RefSpec:
    name: str
    shape: Tuple[int, ...]
    n_classes: int
    samples_per_class: int


SPECS: Dict[str, RefSpec] = {
    "fmnist": RefSpec("fmnist", (28, 28), 10, 700),
    "cifar10": RefSpec("cifar10", (32, 32, 3), 10, 700),
    "cifar100": RefSpec("cifar100", (32, 32, 3), 100, 70),
    # paper uses 7000/class (FMNIST, CIFAR-10) and 500/class (CIFAR-100);
    # we scale down 10x for CPU-budget experiment runtime, preserving the
    # class structure.  Override samples_per_class to match exactly.
}

COMPONENTS_PER_CLASS = 6


def _class_basis(rng, h: int, w: int, n_comp: int, pool: np.ndarray
                 ) -> np.ndarray:
    """(n_comp, h, w) cosine basis images on class-specific frequencies."""
    idx = rng.choice(len(pool), n_comp, replace=False)
    basis = []
    for kx, ky in pool[idx]:
        ph = rng.uniform(0, 2 * np.pi)
        basis.append(np.cos(2 * np.pi * (kx * np.arange(h)[:, None] / h
                                         + ky * np.arange(w)[None, :] / w)
                            + ph))
    return np.stack(basis)


def generate(name: str, seed: int = 0, samples_per_class: int = 0
             ) -> Tuple[np.ndarray, np.ndarray]:
    """Returns (X (N, prod(shape)) float32 standardised, y)."""
    spec = SPECS[name]
    n_per = samples_per_class or spec.samples_per_class
    rng = np.random.default_rng(seed + hash(name) % 65536)
    ch = spec.shape[2] if len(spec.shape) == 3 else 1
    h, w = spec.shape[0], spec.shape[1]
    # global frequency pool, partitioned DISJOINTLY over classes (large
    # enough that even 100 classes get non-overlapping signatures)
    freqs = np.array([(kx, ky) for kx in range(1, 16) for ky in range(1, 16)])
    rng.shuffle(freqs)
    per_class = max(len(freqs) // spec.n_classes, 1)
    xs, ys = [], []
    for c in range(spec.n_classes):
        lo = (c * per_class) % len(freqs)
        pool = freqs[lo:lo + per_class] if per_class > 1 else \
            freqs[[c % len(freqs)]]
        basis = np.stack([_class_basis(rng, h, w,
                                       min(COMPONENTS_PER_CLASS, len(pool)),
                                       pool)
                          for _ in range(ch)], -1)   # (n_comp, h, w, ch)
        n_comp = basis.shape[0]
        # class prototype: a fixed strong combination of the class's own
        # components (the "mean image" — what makes class c look like c)
        proto = np.tensordot(2.0 + rng.standard_normal(n_comp), basis,
                             axes=1)
        for_cls = []
        for _ in range(n_per):
            amps = 0.5 * rng.standard_normal(n_comp)
            img = proto + np.tensordot(amps, basis, axes=1)   # (h, w, ch)
            img = img * (1.0 + 0.1 * rng.standard_normal()) \
                + 0.1 * rng.standard_normal(img.shape)
            for_cls.append(img.ravel())
        xs.append(np.stack(for_cls).astype(np.float32))
        ys.append(np.full(n_per, c, np.int32))
    X = np.concatenate(xs, 0)
    y = np.concatenate(ys, 0)
    mu, sd = X.mean(0, keepdims=True), X.std(0, keepdims=True) + 1e-6
    return ((X - mu) / sd).astype(np.float32), y
