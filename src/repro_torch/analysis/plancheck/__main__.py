"""CLI: ``PYTHONPATH=src python -m repro_torch.analysis.plancheck``.

Runs the full battery from the repo root, on the CPU (no card needed):

1. the **AST lint** over ``src/repro_torch``;
2. the **cache-key completeness** check (``PC-KEY``) against the live
   ``engine._graph_key`` / ``engine._capture`` / ``ServiceConfig``;
3. the **dispatch pass** on a small built-in demo plan that holds every
   bucket kind (fused single, fl with its isolated fallback, multi-model)
   — one round each on the meta device, nothing executes.

Findings are filtered against ``baseline.toml`` beside this file
(committed suppressions, each with a reason).  Exit status 1 iff NEW
findings remain.  ``--report PATH`` writes the full report as JSON;
``--write-baseline`` rewrites the baseline from the current findings
(then edit in real reasons); ``--skip-plan`` skips the dispatch pass.
"""
from __future__ import annotations

import argparse
import os
import sys

from repro_torch.analysis.plancheck import (Report, apply_baseline,
                                            check_cache_keys, check_plan,
                                            check_repo, format_baseline,
                                            load_baseline)

_HERE = os.path.dirname(os.path.abspath(__file__))
#: src/repro_torch, found relative to this file so the CLI works from any cwd
SRC_PORT = os.path.normpath(os.path.join(_HERE, os.pardir, os.pardir))
BASELINE = os.path.join(_HERE, "baseline.toml")


def demo_plan():
    """A small ExecutionPlan holding every bucket kind."""
    import dataclasses

    import numpy as np

    from repro_torch.api import (AutoencoderConfig, CellSpec, DataSpec,
                                 ExperimentSpec, SeedSpec, SimConfig,
                                 TraceSpec, plan)
    from repro_torch.core.failure import sample_traces
    from repro_torch.data import commsml, federated

    ae = AutoencoderConfig(input_dim=commsml.N_FEATURES, hidden=(16,),
                           code_dim=4, dropout=0.2)
    X, y = commsml.generate(seed=0, samples_per_class=40)
    split = federated.make_split(X, y, num_devices=6, num_clusters=3,
                                 anomaly_classes=[3], seed=0)
    dx, counts = federated.pad_devices(split)
    base = SimConfig(num_devices=6, rounds=2, lr=1e-3)
    tcfg = dataclasses.replace(base, scheme="tolfl", num_clusters=3)
    traces = sample_traces(np.random.default_rng(0), tcfg.topology(),
                           0.5, max_events=6, rounds=2, num_traces=1,
                           device="cpu")
    spec = ExperimentSpec(
        data=DataSpec(model=ae, device_x=dx, device_counts=counts,
                      test_x=split.test_x, test_y=split.test_y,
                      name="plancheck-demo"),
        base=base,
        cells=(CellSpec("tolfl", 2), CellSpec("fl", 1),
               CellSpec("ifca", 2)),
        traces=TraceSpec(traces=tuple(traces)), seeds=SeedSpec((0,)))
    return plan(spec)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis.plancheck",
        description="static analysis of the port: repo lint + score-graph "
                    "key contract + plan-time dispatch checks")
    ap.add_argument("--baseline", default=BASELINE,
                    help="suppression baseline (default: %(default)s)")
    ap.add_argument("--report", default=None,
                    help="write the JSON report here")
    ap.add_argument("--write-baseline", action="store_true",
                    help="rewrite --baseline from current findings")
    ap.add_argument("--skip-plan", action="store_true",
                    help="skip the dispatch pass over the demo plan")
    ap.add_argument("--src", default=SRC_PORT,
                    help="source tree for the AST pass")
    args = ap.parse_args(argv)

    findings, inline_suppressed = check_repo(args.src,
                                             rel_prefix="src/repro_torch/")
    findings += check_cache_keys()
    buckets = []
    if not args.skip_plan:
        plan_report = check_plan(demo_plan())
        findings += plan_report.findings
        buckets = plan_report.buckets

    if args.write_baseline:
        with open(args.baseline, "w", encoding="utf-8") as f:
            f.write(format_baseline(findings))
        print(f"wrote {len(findings)} suppression(s) to {args.baseline}"
              f" -- now fill in the reasons")
        return 0

    new, baselined = apply_baseline(findings, load_baseline(args.baseline))
    report = Report(findings=new, suppressed=baselined + inline_suppressed,
                    buckets=buckets)
    if args.report:
        with open(args.report, "w", encoding="utf-8") as f:
            f.write(report.to_json() + "\n")
    print(report.describe())
    return 0 if report.clean else 1


if __name__ == "__main__":
    sys.exit(main())
