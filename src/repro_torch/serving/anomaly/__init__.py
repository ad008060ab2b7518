"""Live anomaly-scoring service under failure (the Tol-FL serving layer).

Port of ``repro.serving.anomaly``.  Surface:

* :func:`~repro_torch.serving.anomaly.bank.train_model_bank` /
  :class:`~repro_torch.serving.anomaly.bank.ModelBank` — params export
  from a training scenario (global + isolated-per-client models);
* :class:`~repro_torch.serving.anomaly.service.AnomalyService` /
  :class:`~repro_torch.serving.anomaly.service.ServiceConfig` — the
  batched failover scoring service (fixed-size buckets, coalescing work
  queue, trace-driven liveness routing);
* :class:`~repro_torch.serving.anomaly.service.ServiceReport` —
  sustained throughput, latency percentiles, failover/failback counts
  and per-regime AUROC;
* :func:`~repro_torch.serving.anomaly.engine.score_entry` — a bucket's
  entry point (on the card one CUDA graph, cached in-process) in place of
  ``repro``'s ``score_executable``; :func:`clear_score_cache` drops them.

``repro``'s ``score_budget_name`` (the plancheck budget) is not ported.
"""
from repro_torch.serving.anomaly.bank import ModelBank, train_model_bank
from repro_torch.serving.anomaly.engine import clear_score_cache, score_entry
from repro_torch.serving.anomaly.service import (AnomalyService,
                                                 ScoredWindow, ServiceConfig,
                                                 ServiceReport)

__all__ = [
    "ModelBank", "train_model_bank",
    "AnomalyService", "ServiceConfig", "ServiceReport", "ScoredWindow",
    "score_entry", "clear_score_cache",
]
