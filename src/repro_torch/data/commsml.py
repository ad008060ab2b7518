"""Synthetic Comms-ML-style wireless dataset generator.

The port's copy of ``repro.data.commsml`` (pure numpy): the same seed
gives byte-identical arrays.

The paper's Comms-ML tool [15] simulates SDR networks and emits per-sample
feature vectors of 112 features: indices 0-11 are network-statistics
features (packet rates, airtime occupancy, RSSI stats, MCS histogram
moments, ...) and indices 11+ are raw physical-signal readings (wideband
spectral magnitudes).  The public generator needs a full SDR simulation
stack; offline we reproduce its *statistical shape*: each traffic class is
a distinct stationary process over the 112 features — distinct spectral
occupancy patterns + correlated statistics — and anomaly classes perturb
the communication pattern (rate shifts) or add novel emitters (new
spectral lines), exactly the two anomaly families described in Section V-A.

Classes (4, as in Table VII; 3000 samples/class):
  0: wifi_sparse    — baseline WLAN, low duty cycle
  1: wifi_dense     — same emitters, high duty cycle
  2: rate_anomaly   — class-0 emitters with shifted tx pattern (resource
                      misuse anomaly)
  3: bluetooth_intrusion — novel narrowband hopper added (novel-device
                      anomaly)
"""
from __future__ import annotations

from typing import Tuple

import numpy as np

N_FEATURES = 112
N_STATS = 12          # statistics features [0, 12)
N_SIGNAL = N_FEATURES - N_STATS
N_CLASSES = 4
SAMPLES_PER_CLASS = 3000


def _spectral_template(rng: np.random.Generator, centers, widths, powers
                       ) -> np.ndarray:
    """Mean wideband magnitude profile over N_SIGNAL bins."""
    f = np.arange(N_SIGNAL, dtype=np.float64)
    prof = np.full(N_SIGNAL, 0.05)
    for c, w, p in zip(centers, widths, powers):
        prof += p * np.exp(-0.5 * ((f - c) / w) ** 2)
    return prof


_CLASS_DEFS = {
    0: dict(duty=0.2, rate=10.0, centers=[20, 60], widths=[6, 8],
            powers=[1.0, 0.8]),
    1: dict(duty=0.7, rate=40.0, centers=[20, 60], widths=[6, 8],
            powers=[1.6, 1.3]),
    2: dict(duty=0.9, rate=120.0, centers=[20, 60], widths=[6, 8],
            powers=[1.1, 0.9]),                       # rate misuse
    3: dict(duty=0.25, rate=12.0, centers=[20, 60, 85], widths=[6, 8, 1.5],
            powers=[1.0, 0.8, 2.2]),                  # bluetooth hopper
}


def _stats_features(rng, duty, rate, n) -> np.ndarray:
    """12 correlated statistics features."""
    pkt_rate = rng.gamma(shape=rate, scale=1.0, size=n) / max(rate, 1)
    airtime = np.clip(duty + 0.08 * rng.standard_normal(n), 0, 1)
    rssi_mean = -55 + 8 * airtime + 1.5 * rng.standard_normal(n)
    rssi_std = 2.5 + 1.2 * airtime + 0.3 * rng.standard_normal(n)
    retries = rng.poisson(lam=2 + 8 * duty, size=n).astype(np.float64)
    mcs_lo = np.clip(0.6 - 0.4 * duty + 0.1 * rng.standard_normal(n), 0, 1)
    mcs_hi = 1.0 - mcs_lo
    iat_mean = 1.0 / np.maximum(pkt_rate * rate, 0.3)
    iat_cv = 0.8 + 0.5 * duty + 0.1 * rng.standard_normal(n)
    chan_util = np.clip(airtime + 0.05 * rng.standard_normal(n), 0, 1)
    n_src = np.round(2 + 3 * duty + rng.standard_normal(n) * 0.5)
    noise_floor = -95 + 1.0 * rng.standard_normal(n)
    return np.stack([pkt_rate, airtime, rssi_mean, rssi_std, retries,
                     mcs_lo, mcs_hi, iat_mean, iat_cv, chan_util,
                     n_src, noise_floor], axis=1)


def generate_class(cls: int, n: int, seed: int = 0) -> np.ndarray:
    rng = np.random.default_rng(seed * N_CLASSES + cls + 1)
    d = _CLASS_DEFS[cls]
    prof = _spectral_template(rng, d["centers"], d["widths"], d["powers"])
    # per-sample signal: template x log-normal fading + burst modulation
    fade = rng.lognormal(mean=0.0, sigma=0.25, size=(n, 1))
    bursts = d["duty"] + (1 - d["duty"]) * rng.beta(2, 5, size=(n, 1))
    sig = prof[None, :] * fade * bursts + 0.03 * rng.standard_normal(
        (n, N_SIGNAL))
    if cls == 3:   # hopping: the narrowband line moves around bin 85+-7
        hop = rng.integers(-7, 8, size=n)
        for i in range(n):
            sig[i] = np.roll(sig[i], hop[i])
    stats = _stats_features(rng, d["duty"], d["rate"], n)
    return np.concatenate([stats, sig], axis=1).astype(np.float32)


def generate(seed: int = 0, samples_per_class: int = SAMPLES_PER_CLASS
             ) -> Tuple[np.ndarray, np.ndarray]:
    """Returns (X (N, 112) float32, y (N,) int class labels)."""
    xs, ys = [], []
    for c in range(N_CLASSES):
        xc = generate_class(c, samples_per_class, seed)
        xs.append(xc)
        ys.append(np.full(samples_per_class, c, np.int32))
    X = np.concatenate(xs, 0)
    y = np.concatenate(ys, 0)
    # standardise with class-0 statistics (the "typical" traffic)
    mu = X[y == 0].mean(0, keepdims=True)
    sd = X[y == 0].std(0, keepdims=True) + 1e-6
    return ((X - mu) / sd).astype(np.float32), y
