"""The port's plancheck: one planted violation per rule, plus clean runs.

Ports the AST, baseline, suppression and cache-key cases of
``tests/test_plancheck.py`` to the port's rules, and adds the dispatch
pass's: each rule fires on a snippet that has its defect and not on the
fixed twin; ``src/repro_torch`` (and ``chip_smoke.py``) come out clean
against the port's baseline; one generated case a ``ServiceConfig``
field; ``trace_alive_mask``'s op count is constant across
``max_events`` and a round's across the scenario count; a round with a
planted host sync gives ``PC-TORCH-SYNC``; ``plan(spec, check=True)`` is
clean.
"""
import dataclasses
import os
import textwrap
from pathlib import Path

import numpy as np
import pytest
import torch
import torch_threads  # noqa: F401  (one torch thread a module)

from repro_torch import api as T
from repro_torch.analysis import plancheck
from repro_torch.analysis.plancheck import __main__ as pc_main
from repro_torch.analysis.plancheck import budgets as pc_budgets
from repro_torch.analysis.plancheck import cachekey as pc_cachekey
from repro_torch.analysis.plancheck.findings import (apply_inline, finding,
                                                     inline_suppressions)
from repro_torch.core import failure as F
from repro_torch.core import simulate as sim
from repro_torch.models.params import tree_map_with_path
from repro_torch.serving.anomaly import engine
from repro_torch.serving.anomaly.service import ServiceConfig

one_torch_thread = torch_threads.one_torch_thread
ROOT = Path(__file__).resolve().parents[1]
SRC_PORT = str(ROOT / "src" / "repro_torch")


def _rules(findings):
    return [f.rule for f in findings]


# ---------------------------------------------------------------------------
# findings / suppression layer
# ---------------------------------------------------------------------------
def test_finding_requires_registered_rule():
    with pytest.raises(AssertionError):
        finding("PC-NOPE", "x.py", 1, "bogus")
    for gone in ("PC-JAX-RETRACE", "PC-JAX-CONST", "PC-AST-JIT",
                 "PC-AST-KEYREUSE"):
        assert gone not in plancheck.RULES


def test_inline_suppression_own_line_covers_next_line():
    src = textwrap.dedent("""\
        x = 1
        # plancheck: ignore[PC-AST-IMPORT]
        y = 2
        z = 3  # plancheck: ignore
    """)
    supp = inline_suppressions(src)
    assert supp[2] == {"PC-AST-IMPORT"} and supp[3] == {"PC-AST-IMPORT"}
    assert supp[4] is None                     # bare ignore = all rules
    fs = [finding("PC-AST-IMPORT", "m.py", 3, "a"),
          finding("PC-AST-NONDET", "m.py", 3, "b"),
          finding("PC-AST-GENERATOR", "m.py", 4, "c")]
    kept, silenced = apply_inline(fs, src)
    assert _rules(kept) == ["PC-AST-NONDET"]
    assert len(silenced) == 2


def test_baseline_roundtrip_and_reason_required(tmp_path):
    fs = [finding("PC-AST-IMPORT", "src/x.py", 9, "imports jax",
                  tag="L9:jax")]
    path = tmp_path / "baseline.toml"
    path.write_text(plancheck.format_baseline(fs, reason="legacy"))
    entries = plancheck.load_baseline(str(path))
    assert entries[0]["rule"] == "PC-AST-IMPORT"
    kept, silenced = plancheck.apply_baseline(fs, entries)
    assert not kept and len(silenced) == 1
    path.write_text('[[suppress]]\nrule = "PC-AST-IMPORT"\n')
    with pytest.raises(ValueError, match="reason"):
        plancheck.load_baseline(str(path))
    assert plancheck.load_baseline(str(tmp_path / "missing.toml")) == []


def test_port_baseline_is_empty_and_parses():
    assert plancheck.load_baseline(pc_main.BASELINE) == []


# ---------------------------------------------------------------------------
# AST lint (one planted violation per rule, and its fixed twin)
# ---------------------------------------------------------------------------
def _lint(src, relpath="core/somefile.py"):
    fs, _ = plancheck.check_source(textwrap.dedent(src), relpath)
    return fs


@pytest.mark.parametrize("src", [
    "import jax\n",
    "import jax.numpy as jnp\n",
    "from jax import random\n",
    "from repro.core import campaign\n",
    "import repro.api as J\n",
    "def f():\n    import jax\n    return jax\n",
])
def test_ast_flags_jax_or_repro_import(src):
    assert _rules(_lint(src, "models/x.py")) == ["PC-AST-IMPORT"]


def test_ast_import_fixed_twin_is_clean():
    assert _lint("""\
        import torch
        import repro_torch
        from repro_torch.core import campaign
        import numpy as np
    """) == []


@pytest.mark.parametrize("call", [
    "torch.rand(3)", "torch.randn(2, 3)", "torch.randint(0, 5, (3,))",
    "torch.randperm(4)", "torch.bernoulli(p)", "torch.multinomial(p, 2)",
    "torch.normal(0.0, 1.0, (3,))", "torch.rand_like(p)",
    "torch.randn_like(p)"])
def test_ast_flags_draw_without_generator(call):
    src = f"import torch\ndef draw(p, g):\n    return {call}\n"
    assert _rules(_lint(src)) == ["PC-AST-GENERATOR"]
    fixed = call[:-1] + (", " if not call.endswith("()") else "") + \
        "generator=g)"
    assert _lint(f"import torch\ndef draw(p, g):\n    return {fixed}\n") \
        == []


def test_ast_generator_rule_is_for_core_modules_and_resolves_imports():
    src = "from torch import randn as rn\nx = rn(3)\n"
    assert _rules(_lint(src, "serving/anomaly/x.py")) == ["PC-AST-GENERATOR"]
    assert _lint(src, "examples/x.py") == []
    assert _lint(src, "launch/x.py") == []


def test_ast_flags_loop_metric():
    fs = _lint("""\
        from repro_torch.training.metrics import auroc
        def report(scores, ys):
            return [auroc(s, ys) for s in scores]
    """)
    assert _rules(fs) == ["PC-AST-LOOPMETRIC"]
    assert _lint("""\
        from repro_torch.training.metrics import auroc_batch
        def report(scores, ys):
            return auroc_batch(scores, ys)
    """) == []


def test_ast_flags_nondet_in_nested_function_only():
    fs = _lint("""\
        import time
        def build_round(cfg):
            def one(x):
                return x * time.time()
            return one
    """)
    assert _rules(fs) == ["PC-AST-NONDET"]
    assert _lint("""\
        import time
        def bench(fn):
            t0 = time.perf_counter()
            fn()
            return time.perf_counter() - t0
    """) == []
    assert _rules(_lint("""\
        import numpy as np
        def build(cfg):
            def one(x):
                return x + np.random.rand()
            return one
    """)) == ["PC-AST-NONDET"]


def test_ast_inline_ignore_silences_the_rule():
    fs, silenced = plancheck.check_source(textwrap.dedent("""\
        # plancheck: ignore[PC-AST-IMPORT]
        import jax
    """), "core/somefile.py")
    assert fs == [] and _rules(silenced) == ["PC-AST-IMPORT"]


def test_repo_ast_pass_is_clean_against_the_port_baseline():
    fs, silenced = plancheck.check_repo(SRC_PORT,
                                        rel_prefix="src/repro_torch/")
    new, _ = plancheck.apply_baseline(fs, plancheck.load_baseline(
        pc_main.BASELINE))
    assert new == [], "\n".join(f.describe() for f in new)
    # the one deliberate exception, justified inline
    assert [(f.rule, f.file) for f in silenced] == [
        ("PC-AST-LOOPMETRIC", "src/repro_torch/core/simulate.py")]


def test_chip_smoke_imports_neither_jax_nor_repro():
    source = (ROOT / "chip_smoke.py").read_text()
    fs, _ = plancheck.check_source(source, "chip_smoke.py")
    assert [f for f in fs if f.rule == "PC-AST-IMPORT"] == []


# ---------------------------------------------------------------------------
# PC-KEY: the score-graph key
# ---------------------------------------------------------------------------
def test_cache_key_contract_holds_on_repo():
    assert plancheck.check_cache_keys() == []


def test_cache_key_flags_planted_missing_knob():
    fs = plancheck.check_cache_keys(extra_service_fields=["dtype"])
    assert _rules(fs) == ["PC-KEY"]
    assert fs[0].tag == "ServiceConfig.dtype"


def test_cache_key_flags_signature_drift(monkeypatch):
    def capture(model, row_params, shape, dtype):
        raise AssertionError("never called")
    monkeypatch.setattr(engine, "_capture", capture)
    fs = plancheck.check_cache_keys()
    assert [f.tag for f in fs] == ["_capture.signature"]


def test_cache_key_flags_a_spec_class_that_is_not_frozen(monkeypatch):
    @dataclasses.dataclass
    class Loose:
        width: int = 4
    from repro_torch.models import detector
    monkeypatch.setattr(detector, "spec_classes", lambda: (Loose,))
    fs = plancheck.check_cache_keys()
    assert [f.tag for f in fs] == ["Loose.containment"]


@pytest.mark.parametrize("field_name", [f.name for f in
                                        dataclasses.fields(ServiceConfig)])
def test_every_service_field_is_keyed_or_allowlisted(field_name):
    verdict = pc_cachekey.classify_field("ServiceConfig", field_name)
    assert verdict in ("covered", "allowlisted"), (
        f"ServiceConfig.{field_name} is neither mapped to a component of "
        f"engine._graph_key (plancheck.cachekey.FIELD_COVERAGE) nor "
        f"allowlisted with a reason (plancheck.cachekey.ALLOWLIST)")


def test_graph_key_is_canonical_across_model_spellings():
    cfg = T.AutoencoderConfig(input_dim=112, hidden=(8,), code_dim=4)
    params = T.AutoencoderDetector(cfg).init_params(
        torch.Generator().manual_seed(0), device="cpu")
    bank = tree_map_with_path(lambda _, t: t[None], params)
    shape = (1, 16, 112)
    assert engine._graph_key(cfg, bank, shape) == engine._graph_key(
        T.AutoencoderDetector(cfg), bank, shape)
    assert engine.score_budget_name() == "serving_score_core"
    assert engine.score_budget_name("seq") == "serving_score_core:seq"
    assert T.SeqDetector.budget_family == "seq"


# ---------------------------------------------------------------------------
# budgets
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("fn,name", [(F.trace_alive_mask, "trace_alive_mask"),
                                     (F.trace_faulty_scale,
                                      "trace_faulty_scale")])
def test_trace_reader_is_constant_across_max_events(fn, name):
    def count(m):
        tr = F.stack_traces([F.FailureTrace.none(m, device="cpu")] * 3)
        return pc_budgets.op_count(fn, tr, 10, 3)
    assert pc_budgets.constant_across(count, (4, 8, 20, 40))
    assert pc_budgets.check_budget(name, count(8)) is None


def test_budget_breach_and_unknown_budget_are_findings():
    f = pc_budgets.check_budget("trace_alive_mask", 31)
    assert f.rule == "PC-TORCH-BUDGET" and f.tag == "trace_alive_mask"
    assert pc_budgets.check_budget("trace_alive_mask", 30) is None
    f = pc_budgets.check_budget("campaign_core_multi:lstm", 10)
    assert f.rule == "PC-TORCH-BUDGET" and "no named budget" in f.message
    unrolled = lambda x: [x := torch.where(x > 0, x * 2, x)  # noqa: E731
                          for _ in range(40)]
    n = pc_budgets.op_count(unrolled, torch.zeros(4))
    assert pc_budgets.check_budget("trace_alive_mask", n) is not None


@pytest.mark.parametrize("kind", ["ae", "seq"])
def test_score_core_is_constant_and_fits_its_budget(kind):
    det = (T.AutoencoderDetector(T.AutoencoderConfig(input_dim=112,
                                                     hidden=(16,),
                                                     code_dim=4))
           if kind == "ae" else T.SeqDetector(input_dim=112, window=16,
                                              d_model=8))
    params = det.init_params(torch.Generator().manual_seed(0), device="cpu")
    core = engine.score_core(det)
    counts = set()
    for rows in (2, 5):
        bank = tree_map_with_path(
            lambda _, t: t.expand(rows, *t.shape).contiguous(), params)
        for B, W in ((1, 16), (8, 16), (8, 32)):
            counts.add(pc_budgets.op_count(
                core, bank, torch.zeros(1, dtype=torch.int64),
                torch.zeros(B, W, 112)))
    assert len(counts) == 1
    name = engine.score_budget_name(det.budget_family)
    assert pc_budgets.check_budget(name, counts.pop()) is None


# ---------------------------------------------------------------------------
# the dispatch pass over a real ExecutionPlan
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def plancheck_spec(tiny_ae_cfg, tiny_split, tiny_padded):
    dx, counts = tiny_padded
    base = T.SimConfig(num_devices=10, rounds=2, lr=1e-3, dropout=True)
    tcfg = dataclasses.replace(base, scheme="tolfl", num_clusters=5)
    traces = F.sample_traces(np.random.default_rng(1), tcfg.topology(),
                             0.5, max_events=6, rounds=2, num_traces=1,
                             device="cpu")
    ae = T.AutoencoderConfig(**{f.name: getattr(tiny_ae_cfg, f.name)
                                for f in dataclasses.fields(tiny_ae_cfg)})
    return T.ExperimentSpec(
        data=T.DataSpec(model=ae, device_x=dx, device_counts=counts,
                        test_x=tiny_split.test_x, test_y=tiny_split.test_y,
                        name="plancheck"),
        base=base,
        cells=(T.CellSpec("tolfl", 2), T.CellSpec("fl", 1),
               T.CellSpec("ifca", 2), T.CellSpec("fedgroup", 2)),
        traces=T.TraceSpec(traces=tuple(traces)), seeds=T.SeedSpec((0, 1)))


def test_plan_static_report_is_clean_on_real_buckets(plancheck_spec):
    p = T.plan(plancheck_spec, check=True)
    assert p.report is not None and p.report.clean, p.report.describe()
    assert "static analysis: clean" in p.describe()
    assert [b.bucket for b in p.report.buckets] == [0, 1, 2, 3]
    assert all(b.device == "meta" and not b.no_meta_op and b.ops > 0
               and b.ops <= b.max_ops for b in p.report.buckets)
    assert T.plan(plancheck_spec).report is None
    assert p.static_report() is p.report


@pytest.mark.parametrize("body", ["ae", "seq"])
def test_round_count_is_constant_across_scenarios(plancheck_spec, body):
    spec = plancheck_spec
    if body == "seq":
        spec = dataclasses.replace(spec, data=dataclasses.replace(
            spec.data, model=T.SeqDetector(input_dim=112, window=16,
                                           d_model=8)))
    p = T.plan(spec)
    for b in p.buckets:
        cells = [p.cells[i] for i in b.cell_indices]
        assert pc_budgets.constant_across(
            lambda s: plancheck.round_ops(spec.data, b, cells, scenarios=s),
            (1, 4)), b.describe()


def _sync_item(alive, *args):
    alive.sum().item()
    return _effective(alive, *args)


def _sync_mask(alive, *args):
    alive[alive > 0.5]
    return _effective(alive, *args)


def _sync_copy(alive, *args):
    alive.cpu()
    return _effective(alive, *args)


_effective = sim.effective_weights_arrays


@pytest.mark.parametrize("planted,op", [
    (_sync_item, "aten::_local_scalar_dense"),
    (_sync_mask, "aten::index.Tensor"),
    (_sync_copy, "aten::_to_copy")])
def test_planted_host_sync_in_a_round(plancheck_spec, monkeypatch, planted,
                                      op):
    monkeypatch.setattr(sim, "effective_weights_arrays", planted)
    rep = plancheck.check_plan(T.plan(plancheck_spec))
    syncs = [f for f in rep.findings if f.rule == "PC-TORCH-SYNC"]
    # the two single-model buckets call it; the multi-model ones do not
    assert len(syncs) == 2 and len(rep.findings) == 2
    assert all(f.file == "src/repro_torch/core/simulate.py"
               and f.tag == op for f in syncs)
    line = Path(SRC_PORT, "core", "simulate.py").read_text().splitlines()[
        syncs[0].line - 1]
    assert "effective_weights_arrays(" in line


def test_round_that_grows_with_scenarios_is_a_finding(plancheck_spec,
                                                      monkeypatch):
    def per_scenario(alive, *args):
        for s in range(alive.shape[0]):          # a Python loop over S
            alive[s] * 1.0
        return _effective(alive, *args)
    monkeypatch.setattr(sim, "effective_weights_arrays", per_scenario)
    rep = plancheck.check_plan(T.plan(plancheck_spec))
    assert _rules(rep.findings) == ["PC-TORCH-BUDGET"] * 2
    assert all(f.tag.endswith(":scenarios") for f in rep.findings)


def test_op_without_meta_kernel_falls_back_to_the_cpu(plancheck_spec,
                                                      monkeypatch):
    def no_meta(alive, *args):
        if alive.device.type == "meta":
            torch.ops.aten.add(alive, 0.0)
            raise NotImplementedError("planted: no meta kernel")
        return _effective(alive, *args)
    monkeypatch.setattr(sim, "effective_weights_arrays", no_meta)
    rep = plancheck.check_plan(T.plan(plancheck_spec))
    assert rep.clean, rep.describe()
    single = [b for b in rep.buckets if b.budget.startswith(
        "campaign_core_single")]
    assert [b.device for b in single] == ["cpu", "cpu"]
    assert all(b.no_meta_op == "aten::add.Tensor" for b in single)
    assert "has no meta kernel" in rep.describe()


def test_cli_runs_clean(tmp_path, capsys):
    out = tmp_path / "report.json"
    assert pc_main.main(["--report", str(out)]) == 0
    text = capsys.readouterr().out
    assert text.startswith("plancheck: 0 finding(s)")
    assert '"buckets"' in out.read_text()
    assert os.path.exists(pc_main.BASELINE)
