"""The service's parameter bank: trained models a scoring router picks.

Port of ``repro.serving.anomaly.bank``.  A :class:`ModelBank` holds, for
one finished training scenario,

* ``global_params`` — the scheme's final global model, the one every
  cluster head serves (Tol-FL trains ONE global model hierarchically;
  "route to the cluster-head model" means this row);
* ``iso_params`` — N genuinely-isolated per-client models, each trained
  on its own local shard from the shared init with NO communication
  (``simulate.trained_params(..., isolated=True)``) — the failover
  targets served while a client's head is dead;
* ``row_params`` — the two stacked into a tree of ``(N + 1, ...)``
  leaves on the bank's device (row 0 global, row ``c + 1`` client
  ``c``'s isolated model), so a bucket's score core selects a batch's
  row with one gather (:mod:`repro_torch.serving.anomaly.engine`).

Both exports run the simulator's own round loop
(:func:`repro_torch.core.simulate.trained_params`): on the card each
round launches the fused aggregation kernel once, so a bank of R rounds
launches it 2R times.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from repro_torch import DeviceLike
from repro_torch.core.failure import NO_FAILURE, Failure
from repro_torch.core.simulate import SimConfig, trained_params
from repro_torch.core.topology import Topology
from repro_torch.models import detector as D
from repro_torch.models.detector import DetectorModel, ModelLike
from repro_torch.models.params import Params, tree_items, tree_map_with_path


@dataclass(frozen=True, eq=False)
class ModelBank:
    """Trained params + routing geometry for one deployed detector."""

    detector: DetectorModel
    topology: Topology
    input_dim: int               # feature dim D of a window row
    global_params: Params        # tree, the served cluster-head model
    iso_params: Params           # tree, leaves (N, ...) isolated models
    row_params: Params           # tree, leaves (N + 1, ...): stacked

    @property
    def num_clients(self) -> int:
        return self.topology.num_devices

    def row_index(self, client: int, failover: bool) -> int:
        """Bank row serving ``client``: the global model while its head
        is alive, its isolated model (row ``client + 1``) on failover."""
        assert 0 <= client < self.num_clients, client
        return client + 1 if failover else 0

    def client_iso_params(self, client: int) -> Params:
        """Client ``client``'s isolated model (a convenience for parity
        checks; the service gathers from ``row_params``)."""
        return tree_map_with_path(lambda _, p: p[client], self.iso_params)


def train_model_bank(model: ModelLike, device_x: np.ndarray,
                     device_counts: np.ndarray, cfg: SimConfig,
                     failure: Failure = NO_FAILURE,
                     params0: Optional[Params] = None,
                     device: DeviceLike = None) -> ModelBank:
    """Train one scenario and bank its params for serving.

    The global model trains under ``cfg``/``failure`` exactly as the
    campaign engine would; the isolated failover models train clean
    (pre-deployment provisioning: each client's fallback is its own
    local model, independent of whatever outage the global run saw).
    Both runs start from the same ``params0`` (the port's init for
    ``cfg.seed`` when it is None), as ``repro``'s two runs start from
    one PRNGKey."""
    det = D.as_detector(model)
    topo = cfg.topology()
    global_params, _, _ = trained_params(det, device_x, device_counts, cfg,
                                         failure=failure, params0=params0,
                                         device=device)
    _, iso_params, _ = trained_params(det, device_x, device_counts, cfg,
                                      isolated=True, params0=params0,
                                      device=device)
    iso = dict(tree_items(iso_params))
    row_params = tree_map_with_path(
        lambda path, g: torch.cat([g[None], iso[path]], dim=0),
        global_params)
    return ModelBank(detector=det, topology=topo,
                     input_dim=int(device_x.shape[-1]),
                     global_params=global_params, iso_params=iso_params,
                     row_params=row_params)
