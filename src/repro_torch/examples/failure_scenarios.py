"""Failure-rate sweep: the paper's robustness story, Monte-Carlo style.

The port's twin of ``examples/failure_scenarios.py``, with its options,
defaults and tables, on the card (``--device cpu`` for the CPU).

ONE declarative :class:`repro_torch.api.ExperimentSpec` describes the whole
study: every scheme is a cell — the single-model schemes (Tol-FL / FL /
SBT / Batch) and the multi-model baselines (FedGroup / IFCA / FeSEM) —
crossed with a :class:`TraceSpec` holding the canonical
no/client/server-failure conditions (Tables III/IV/V in miniature) AND
sampled multi-event failure-and-recovery grids at increasing per-device
failure rates (paper Section IV-B's expected performance E[AUROC](p)).

``plan(spec)`` lowers that to dispatch buckets — the trace grids are
sampled per TOPOLOGY (a tolfl head is a plain client under fl; batch
has no clients at all, so its client column is n/a), identical draws
are deduplicated, and the non-batch single-model cells fuse per
iso-tracking kind: tolfl and sbt share ONE round loop over the
flattened (scheme x trace x seed) axis.  ``execute`` runs the buckets;
the per-draw result mapping comes back on the plan.  ``--shard`` splits
each bucket's scenarios over the local cards, one shard and one host
thread a card; on one card or the CPU it warns and runs unsharded.  The
results are the same either way, bit for bit with dropout off.

Run:  PYTHONPATH=src python -m repro_torch.examples.failure_scenarios [--rounds 60]
      PYTHONPATH=src python -m repro_torch.examples.failure_scenarios --smoke
      PYTHONPATH=src python -m repro_torch.examples.failure_scenarios \
          --process {iid,markov,cascade,straggler,faulty,all}
The --process path swaps the canonical/rate tables for generative
failure-process studies (repro_torch.core.processes): one E[AUROC] table
per family, one intensity column per ProcessGrid.
The --smoke path shrinks the grid to seconds-scale and prints the
execution plan before running it.
"""
import argparse

import numpy as np

from repro_torch.api import (FAMILIES, NO_FAILURE, AutoencoderConfig,
                             CellSpec, DataSpec, ExecPlan, ExperimentSpec,
                             FailureSpec, ProcessGrid, SeedSpec, SimConfig,
                             TraceSpec, execute, family_process, mean_ci95,
                             plan)
from repro_torch.data import commsml, federated

SINGLE = [("Tol-FL", "tolfl", 5), ("FL", "fl", 1), ("SBT", "sbt", 10),
          ("Batch", "batch", 1)]
MULTI = ["fedgroup", "ifca", "fesem"]
P_GRID = (0.05, 0.2, 0.4)


COL = 21


def fmt(vals):
    mean, std, _ = mean_ci95(np.asarray(vals))
    return f"{f'{mean:.3f} +- {std:.3f}':<{COL}}"


def build_spec(args, p_grid):
    """The whole study as one spec; returns (spec, canonical labels)."""
    singles = [c for c in SINGLE if c[1] in args.single]
    X, y = commsml.generate(seed=0, samples_per_class=args.samples)
    split = federated.make_split(X, y, args.devices, 5,
                                 anomaly_classes=[3], seed=0)
    dx, counts = federated.pad_devices(split)

    canonical = [
        ("no failure", NO_FAILURE),
        ("client fail", FailureSpec(epoch=args.rounds // 4,
                                    kind="client")),
        ("server fail", FailureSpec(epoch=args.rounds // 4,
                                    kind="server")),
    ]
    spec = ExperimentSpec(
        data=DataSpec(model=AutoencoderConfig(), device_x=dx,
                      device_counts=counts, test_x=split.test_x,
                      test_y=split.test_y, name="commsml"),
        base=SimConfig(num_devices=args.devices, rounds=args.rounds,
                       lr=1e-3),
        cells=(tuple(CellSpec(s, k) for _, s, k in singles)
               + tuple(CellSpec(m, args.multi_k) for m in args.multi)),
        traces=TraceSpec(traces=tuple(f for _, f in canonical),
                         p_grid=tuple(p_grid),
                         traces_per_p=args.traces_per_p),
        seeds=SeedSpec.range(args.seeds),
        exec_plan=ExecPlan(shard=args.shard, chunk_size=args.chunk_size))
    return spec, canonical


def build_process_spec(args, families, intensities):
    """One generative-process study per listed family, as ONE spec per
    family (the one-spec-per-study pattern): the schemes crossed with a
    ProcessGrid per intensity of the family's canonical process."""
    singles = [c for c in SINGLE if c[1] in args.single]
    X, y = commsml.generate(seed=0, samples_per_class=args.samples)
    split = federated.make_split(X, y, args.devices, 5,
                                 anomaly_classes=[3], seed=0)
    dx, counts = federated.pad_devices(split)
    data = DataSpec(model=AutoencoderConfig(), device_x=dx,
                    device_counts=counts, test_x=split.test_x,
                    test_y=split.test_y, name="commsml")
    specs = {}
    for family in families:
        specs[family] = ExperimentSpec(
            data=data,
            base=SimConfig(num_devices=args.devices, rounds=args.rounds,
                           lr=1e-3),
            cells=(tuple(CellSpec(s, k) for _, s, k in singles)
                   + tuple(CellSpec(m, args.multi_k) for m in args.multi)),
            traces=TraceSpec.generated(
                *(ProcessGrid(family_process(family, x),
                              args.traces_per_p)
                  for x in intensities)),
            seeds=SeedSpec.range(args.seeds),
            exec_plan=ExecPlan(shard=args.shard,
                               chunk_size=args.chunk_size))
    return specs


def run_process_study(args, intensities):
    """--process path: one E[AUROC]-vs-intensity table per family;
    returns each family's result."""
    families = FAMILIES if args.process == "all" else [args.process]
    specs = build_process_spec(args, families, intensities)
    labels = {s: label for label, s, _ in SINGLE}
    out = {}
    for family, spec in specs.items():
        ep = plan(spec)
        if args.smoke:
            print(ep.describe())
            print()
        res = out[family] = execute(ep, device=args.device)
        per = res.per_process()
        header = (f"{family + ' process':<12}"
                  + "".join(f"{f'E[AUROC] x={x:.2f}':<{COL}}"
                            for x in intensities))
        print(header)
        print("-" * len(header))
        for cplan in ep.cells:
            scheme = cplan.cfg.scheme
            name = (scheme + "*" if cplan.kind == "multi"
                    else labels[scheme])
            row = f"{name:<12}"
            for gi, _ in enumerate(intensities):
                row += fmt(per[cplan.key][gi])
            print(row)
        print()
    print("* = best single instance of a multi-model scheme; intensity "
          "x is each family's\ncanonical probability knob "
          "(repro_torch.core.processes.family_process).")
    return out


def main(argv=None):
    """Print the tables; returns the experiment's result (a dict of them
    by family with --process)."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--rounds", type=int, default=60)
    ap.add_argument("--devices", type=int, default=10)
    ap.add_argument("--samples", type=int, default=400)
    ap.add_argument("--seeds", type=int, default=3)
    ap.add_argument("--traces-per-p", type=int, default=4)
    ap.add_argument("--chunk-size", type=int, default=None,
                    help="host-side scenario chunking: bound device "
                         "memory for large grids (one compile either way)")
    ap.add_argument("--shard", action="store_true",
                    help="shard the scenario batch across the local "
                         "cards, one shard a card (one card or the CPU "
                         "warns and runs unsharded)")
    ap.add_argument("--smoke", action="store_true",
                    help="tiny grid (seconds-scale), plan printed before "
                         "execution")
    ap.add_argument("--device", default="cuda", help="cuda or cpu")
    ap.add_argument("--process", choices=list(FAMILIES) + ["all"],
                    default=None,
                    help="generative failure-process study instead of "
                         "the canonical + rate-grid tables: one "
                         "E[AUROC]-vs-intensity table for this family "
                         "(or every family with 'all')")
    args = ap.parse_args(argv)
    args.single = [s for _, s, _ in SINGLE]
    args.multi, args.multi_k = MULTI, 3
    p_grid = P_GRID
    intensities = (0.05, 0.2, 0.4)
    if args.smoke:
        # tiny grid, seconds-scale: one fused non-fl bucket (tolfl+sbt),
        # the fl fallback bucket, one multi bucket — the whole spec ->
        # plan -> execute surface without the batch cell
        args.rounds, args.samples, args.seeds = 5, 40, 1
        args.traces_per_p, args.multi, args.multi_k = 1, ["ifca"], 2
        args.single = ["tolfl", "fl", "sbt"]
        p_grid = (0.2,)
        intensities = (0.3,)

    if args.process:
        return run_process_study(args, intensities)

    spec, canonical = build_spec(args, p_grid)
    ep = plan(spec)          # pure: inspectable before anything runs
    if args.smoke:
        print(ep.describe())
        print()
    res = execute(ep, device=args.device)

    p_labels = [f"E[AUROC] p={p:.2f}" for p in p_grid]
    header = (f"{'scheme':<12}"
              + "".join(f"{s:<{COL}}" for s, _ in canonical)
              + "".join(f"{s:<{COL}}" for s in p_labels))
    print(header)
    print("-" * len(header))

    labels = {s: label for label, s, _ in SINGLE}
    for cplan, cres in zip(ep.cells, res.results):
        scheme = cplan.cfg.scheme
        if cplan.kind == "multi":
            row = f"{scheme + '*':<12}"
            sel = (lambda i: cres.select(i, "best"))
        else:
            row = f"{labels[scheme]:<12}"
            sel = cres.select
        for j, _ in enumerate(canonical):
            idx = cplan.explicit_index[j]
            if idx is None:       # batch centralises: no clients to fail
                row += f"{'n/a (no clients)':<{COL}}"
                continue
            row += fmt(sel(idx))
        for p in p_grid:
            row += fmt(np.concatenate([sel(i) for i in cplan.draws[p]]))
        print(row)

    print("\n* = best single instance of a multi-model scheme (paper's "
          "starred columns)")
    print("E[AUROC] p=x columns: mean over sampled multi-event failure-"
          "and-recovery traces\nwhere every device independently fails "
          "with probability x (section IV-B).")
    print("Expected ordering (paper Table V): under server failure Tol-FL "
          "stays collaborative\nwhile FL collapses to isolated devices.")
    return res


if __name__ == "__main__":
    main()
