"""plancheck: plan-time static analysis for the port's experiment pipeline.

Port of ``repro.analysis.plancheck``.  Two passes plus a cache-key check:

* the **dispatch pass** (:mod:`.dispatchpass`) runs one round of every
  bucket of a :class:`repro_torch.core.experiment.ExecutionPlan` at its
  plan-predicted shapes on the meta device (nothing executes) and flags
  host syncs and op counts over their budgets (:mod:`.budgets`);
* the **AST pass** (:mod:`.astpass`) lints ``src/repro_torch`` for jax or
  repro imports, Python-loop metrics, draws from the global generator
  and nondeterminism in nested functions;
* :mod:`.cachekey` checks that every knob that changes a captured score
  graph reaches ``engine._graph_key`` (or is allowlisted with a reason).

Run the whole battery from the repo root::

    PYTHONPATH=src python -m repro_torch.analysis.plancheck

or get a report straight off a plan::

    plan = experiment.plan(spec, check=True)
    print(plan.describe())          # includes the static-report section

Findings are suppressed inline (``# plancheck: ignore[RULE]``) or via
the committed ``baseline.toml`` beside this file (:mod:`.findings`).
"""
from repro_torch.analysis.plancheck.astpass import check_repo, check_source
from repro_torch.analysis.plancheck.budgets import (BUDGETS, Budget,
                                                    HostSync, OpCounter,
                                                    check_budget,
                                                    constant_across,
                                                    op_count)
from repro_torch.analysis.plancheck.cachekey import (check_cache_keys,
                                                     classify_field)
from repro_torch.analysis.plancheck.dispatchpass import check_plan, round_ops
from repro_torch.analysis.plancheck.findings import (RULES, BucketOps,
                                                     Finding, Report,
                                                     apply_baseline,
                                                     apply_inline,
                                                     format_baseline,
                                                     load_baseline)

__all__ = [
    "BUDGETS", "BucketOps", "Budget", "Finding", "HostSync", "OpCounter",
    "RULES", "Report", "apply_baseline", "apply_inline", "check_budget",
    "check_cache_keys", "check_plan", "check_repo", "check_source",
    "classify_field", "constant_across", "format_baseline",
    "load_baseline", "op_count", "round_ops",
]
