"""Live anomaly scoring under failure: train -> serve -> fail over.

The port's twin of ``examples/score_stream.py``, on the card
(``--device cpu`` for the CPU).  End-to-end demo of the serving half of
the paper's failure-tolerance story (:mod:`repro_torch.serving.anomaly`):

1. train a tiny Tol-FL scenario and bank its params — the global
   (cluster-head) model plus one genuinely-isolated model per client;
2. stand up the batched scoring service (fixed batch buckets, each one
   CUDA graph on the card, an eager entry on the CPU);
3. stream traffic windows from every client while a sampled cluster
   cascade kills heads MID-STREAM: windows route to the global model
   until the client's head dies, fail over ResiliNet-style to the
   client's isolated model (bit-identical to scoring it directly —
   asserted below), and fail back on recovery;
4. print the failover timeline and the :class:`ServiceReport`
   (sustained windows/sec, latency percentiles, per-regime AUROC) —
   with ZERO dropped windows, also asserted.

Run:  PYTHONPATH=src python -m repro_torch.examples.score_stream [--epochs 40]
      PYTHONPATH=src python -m repro_torch.examples.score_stream --smoke
"""
import argparse

import numpy as np
import torch

from repro_torch.api import (AnomalyService, AutoencoderConfig,
                             ClusterCascadeProcess, ServiceConfig, SimConfig,
                             train_model_bank)
from repro_torch.data import commsml, federated
from repro_torch.serving.anomaly.engine import score_windows

WINDOW = 8


def build_bank(args):
    X, y = commsml.generate(seed=0, samples_per_class=args.samples)
    split = federated.make_split(X, y, args.devices, args.clusters,
                                 anomaly_classes=[3], seed=0)
    dx, counts = federated.pad_devices(split)
    model = AutoencoderConfig(input_dim=commsml.N_FEATURES,
                              hidden=(32, 16), code_dim=8, dropout=0.2)
    cfg = SimConfig(scheme="tolfl", num_devices=args.devices,
                    num_clusters=args.clusters, rounds=args.rounds,
                    lr=1e-3, dropout=False)
    print(f"training bank: tolfl k={args.clusters} N={args.devices} "
          f"rounds={args.rounds} ...")
    bank = train_model_bank(model, dx, counts, cfg, device=args.device)
    return bank, split


def stream(bank, split, args):
    # every head fails at a sampled epoch, cascades to members, and the
    # cluster staggers back -- the paper's correlated-outage scenario,
    # now driving SERVICE-time liveness instead of training rounds
    cascade = ClusterCascadeProcess(p_head=1.0, q=0.5, recover_prob=1.0,
                                    recovery_lag=max(2, args.epochs // 4))
    svc = AnomalyService(
        bank, ServiceConfig(bucket_sizes=(1, 8, 64), window=WINDOW),
        failure=cascade, sample_seed=1, horizon=args.epochs)
    print("bucket compile sources:",
          {bs: src for bs, src in sorted(svc.compile_sources.items())})

    tx = np.asarray(split.test_x, np.float32)
    ty = np.asarray(split.test_y)
    n_win = tx.shape[0] // WINDOW
    wins = tx[:n_win * WINDOW].reshape(n_win, WINDOW, tx.shape[-1])
    labs = ty[:n_win * WINDOW].reshape(n_win, WINDOW)

    scored = []
    for t in range(args.epochs):
        for c in range(bank.num_clients):
            i = (t * bank.num_clients + c) % n_win
            svc.submit(c, wins[i], labels=labs[i])
        scored.extend(svc.tick())

    # ---- the serving contract, asserted live ----
    submitted = args.epochs * bank.num_clients
    assert len(scored) == submitted, "dropped windows!"
    fo = [r for r in scored if r.served_by == "isolated"]
    assert fo, "cascade never triggered a failover"
    r = fo[0]
    i = (r.epoch * bank.num_clients + r.client) % n_win
    x = torch.from_numpy(wins[i][None]).to(args.device)
    direct = score_windows(bank.detector, bank.client_iso_params(r.client),
                           x)[0].cpu().numpy()
    assert np.array_equal(r.scores, direct), \
        "failover scores are not bit-identical to the isolated model"

    print("\nfailover timeline (service epoch, client, event):")
    for epoch, client, event in svc.timeline:
        head = bank.topology.heads[bank.topology.cluster_of(client)]
        print(f"  t={epoch:>3}  client {client} "
              f"{'->' if event == 'failover' else '<-'} "
              f"{event:<8} (head device {head})")
    rep = svc.report()
    print(f"\n{rep.describe()}")
    print(f"head-served windows: AUROC {rep.auroc_head:.3f} | "
          f"failover-served: AUROC {rep.auroc_isolated:.3f}")
    print("zero dropped windows; failover scores bit-identical to the "
          "isolated models (asserted)")
    return rep, scored


def main(argv=None):
    """Stream and print; returns (the bank, the report, every scored
    window)."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--devices", type=int, default=10)
    ap.add_argument("--clusters", type=int, default=5)
    ap.add_argument("--rounds", type=int, default=40)
    ap.add_argument("--samples", type=int, default=400)
    ap.add_argument("--epochs", type=int, default=40,
                    help="service ticks to stream")
    ap.add_argument("--smoke", action="store_true",
                    help="seconds-scale train + stream")
    ap.add_argument("--device", default="cuda", help="cuda or cpu")
    args = ap.parse_args(argv)
    if args.smoke:
        args.rounds, args.samples, args.epochs = 3, 60, 12

    bank, split = build_bank(args)
    return (bank, *stream(bank, split, args))


if __name__ == "__main__":
    main()
