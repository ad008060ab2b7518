"""Quickstart: Tol-FL anomaly detection on a wireless network in ~40 lines.

The port's twin of ``examples/quickstart.py``: trains the paper's
autoencoder over a 10-device federation (5 clusters) on the synthetic
Comms-ML wireless dataset, then kills a cluster head halfway through a
second run to show the failure tolerance.

Run:  PYTHONPATH=src python -m repro_torch.examples.quickstart
      PYTHONPATH=src python -m repro_torch.examples.quickstart --smoke --device cpu
"""
from __future__ import annotations

import argparse
from typing import Dict

from repro_torch.api import (NO_FAILURE, AutoencoderConfig, FailureSpec,
                             SimConfig, run_simulation)
from repro_torch.data import commsml, federated


def main(argv=None) -> Dict[str, float]:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda", help="cuda or cpu")
    ap.add_argument("--smoke", action="store_true",
                    help="seconds-scale: 8 rounds on 60 samples a class")
    args = ap.parse_args(argv)
    rounds, samples = (8, 60) if args.smoke else (40, 200)

    # 1. A wireless-network dataset: 4 traffic classes, class 3 = intrusion.
    X, y = commsml.generate(seed=0, samples_per_class=samples)
    split = federated.make_split(X, y, num_devices=10, num_clusters=5,
                                 anomaly_classes=[3], seed=0)
    device_x, device_counts = federated.pad_devices(split)

    # 2. The paper's autoencoder anomaly detector.
    ae_cfg = AutoencoderConfig()          # 128-64-32-64-128, dropout 0.2

    # 3. Train with Tol-FL: k=5 clusters over 10 devices.
    sim_cfg = SimConfig(scheme="tolfl", num_devices=10, num_clusters=5,
                        rounds=rounds, lr=1e-3, seed=0)

    def run(cfg, failure):
        return run_simulation(ae_cfg, device_x, device_counts, split.test_x,
                              split.test_y, cfg, failure,
                              device=args.device)

    res = run(sim_cfg, NO_FAILURE)
    print(f"Tol-FL (k=5), no failures:     AUROC = {res.final_auroc:.3f}")

    # 4. Kill a cluster head at round 5: only that cluster drops out;
    #    the other 4 clusters keep training collaboratively.
    fail = FailureSpec(epoch=5, kind="server")
    res_f = run(sim_cfg, fail)
    print(f"Tol-FL (k=5), head failure:    AUROC = {res_f.auroc_used:.3f}")

    # 5. The same failure under plain FL (k=1): the server IS the head, so
    #    the remaining devices fall back to isolated local training (V-C).
    fl_cfg = SimConfig(scheme="fl", num_devices=10, num_clusters=1,
                       rounds=rounds, lr=1e-3, seed=0)
    res_fl = run(fl_cfg, fail)
    print(f"FL (k=1),     server failure:  AUROC = {res_fl.auroc_used:.3f} "
          f"(isolated fallback)")
    print(f"\nTol-FL advantage under server failure: "
          f"+{(res_f.auroc_used - res_fl.auroc_used) * 100:.1f}% AUROC")
    return {"tolfl": res.final_auroc, "tolfl_head_failure": res_f.auroc_used,
            "fl_server_failure": res_fl.auroc_used}


if __name__ == "__main__":
    main()
