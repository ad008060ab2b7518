"""``ExecPlan(aot=True)`` and the compile report in the port, on the CPU.

Port of ``tests/test_aot.py``'s CPU contracts:

* **bit-identical parity** — ``aot=True`` gives the same result arrays as
  ``aot=False`` for the tolfl, fl and IFCA buckets (and with chunks), and
  every bucket's predicted operand shapes match the ones its round
  loops got (``aval_match``);
* **the report** — its buckets' (index, kind, fused, aot) equal those of
  ``repro``'s ``execute`` with ``ExecPlan(aot=True)`` on the CPU;
  ``describe()`` is a header line plus one line a bucket; on the CPU
  nothing compiles (``cache == ""``, no nvcc, ``traces == 0``);
* ``clear_executable_caches`` drops the resolved libraries, the score
  graphs and the counters.

The card's half (the warm-up rounds, "compiled" / "disk" / "memory" and
the cross-process cache) is in ``tests/test_torch_cuda.py`` and
``chip_smoke.py``'s ``[aot]``.
"""
import dataclasses

import numpy as np
import pytest
import torch_threads  # noqa: F401  (one torch thread a module)
from repro import api as J

from repro_torch import api as T
from repro_torch.core import campaign as TC
from repro_torch.core import compilecache as TCC
from repro_torch.core import experiment as TX
from repro_torch.kernels import _build
from repro_torch.serving.anomaly import engine

one_torch_thread = torch_threads.one_torch_thread

FIELDS = ("loss_curves", "iso_loss_curves", "auroc_used", "final_auroc",
          "iso_auroc", "iso_active", "rounds_to_loss")
MULTI_FIELDS = ("best_auroc", "multi_auroc", "loss_curves", "assignments")


def _spec(A, ae, data, *, aot, chunk=None, model=None):
    dx, counts, tx, ty = data
    return A.ExperimentSpec(
        data=A.DataSpec(model=model or ae, device_x=dx, device_counts=counts,
                        test_x=tx, test_y=ty, name="aot"),
        base=A.SimConfig(num_devices=10, rounds=3, lr=1e-3, dropout=True),
        cells=(A.CellSpec("tolfl", 5), A.CellSpec("fl", 1),
               A.CellSpec("ifca", 2)),
        traces=A.TraceSpec(traces=(A.NO_FAILURE, A.FailureSpec(1, "server")),
                           p_grid=(0.3,), traces_per_p=2),
        seeds=A.SeedSpec((0, 1)),
        exec_plan=A.ExecPlan(aot=aot, chunk_size=chunk))


@pytest.fixture(scope="module")
def data(tiny_padded, tiny_split):
    dx, counts = tiny_padded
    return dx, counts, tiny_split.test_x, tiny_split.test_y


@pytest.fixture(scope="module")
def ae():
    return T.AutoencoderConfig(input_dim=112, hidden=(16,), code_dim=4,
                               dropout=0.2)


def _assert_same(a, b):
    names = FIELDS if hasattr(a, "auroc_used") else MULTI_FIELDS
    for name in ("trace_index", "seed") + names:
        np.testing.assert_array_equal(getattr(a, name), getattr(b, name),
                                      err_msg=name)


@pytest.mark.parametrize("chunk", [None, 5])
def test_aot_bit_identical_to_plain(ae, data, chunk):
    plain = T.run_experiment(_spec(T, ae, data, aot=False, chunk=chunk),
                             device="cpu")
    res = T.run_experiment(_spec(T, ae, data, aot=True, chunk=chunk),
                           device="cpu")
    assert {c.cfg.scheme for c in res.plan.cells} == {"tolfl", "fl", "ifca"}
    for a, b in zip(plain.results, res.results):
        _assert_same(a, b)
    rep = res.compile_report
    assert rep.aot and not plain.compile_report.aot
    assert all(b.aval_match is True for b in rep.buckets)
    assert all(b.aval_match is None for b in plain.compile_report.buckets)
    # on the CPU nothing compiles
    assert all(b.cache == "" and b.lower_s == 0.0 and b.compile_s == 0.0
               for b in rep.buckets)
    assert rep.traces == 0 and rep.xla["misses"] == 0
    assert rep.cache_dir == TCC.persistent_cache_dir()
    assert all(b.execute_s > 0 for b in rep.buckets)
    assert rep.execute_s == pytest.approx(sum(b.execute_s
                                              for b in rep.buckets))


def test_aot_bit_identical_seq_body(data):
    seq = T.SeqDetector(input_dim=112, window=16, d_model=8)
    spec = _spec(T, None, data, aot=False, model=seq)
    plain = T.run_experiment(spec, device="cpu")
    res = T.run_experiment(dataclasses.replace(
        spec, exec_plan=T.ExecPlan(aot=True)), device="cpu")
    for a, b in zip(plain.results, res.results):
        _assert_same(a, b)
    assert all(b.aval_match for b in res.compile_report.buckets)


def test_compile_report_buckets_match_repro(ae, data):
    jae = J.AutoencoderConfig(input_dim=112, hidden=(16,), code_dim=4,
                              dropout=0.2)
    want = J.execute(J.plan(_spec(J, jae, data, aot=True))).compile_report
    got = T.run_experiment(_spec(T, ae, data, aot=True),
                           device="cpu").compile_report
    key = [(b.bucket, b.kind, b.fused, b.aot) for b in want.buckets]
    assert [(b.bucket, b.kind, b.fused, b.aot) for b in got.buckets] == key
    assert got.aot == want.aot
    assert [f.name for f in dataclasses.fields(T.CompileReport)] == \
        [f.name for f in dataclasses.fields(J.CompileReport)]
    assert [f.name for f in dataclasses.fields(T.BucketCompileStats)] == \
        [f.name for f in dataclasses.fields(J.BucketCompileStats)]
    assert set(got.xla) == set(want.xla)


def test_describe_has_a_line_a_bucket(ae, data):
    rep = T.run_experiment(_spec(T, ae, data, aot=True),
                           device="cpu").compile_report
    lines = rep.describe().splitlines()
    assert lines[0].startswith("CompileReport: aot=True traces=0 xla=")
    assert len(lines) == 1 + len(rep.buckets)
    for line, b in zip(lines[1:], rep.buckets):
        assert line.startswith(f"  bucket {b.bucket} ({b.kind}")
        assert "aval_match=True" in line and "cache=" not in line


def test_predicted_shapes_of_every_bucket_kind(ae, data):
    """``_bucket_shapes`` equals the operand shapes of the first chunk's
    round loop for fused, per-cell, batch and FedGroup buckets."""
    dx, counts, tx, ty = data
    spec = TX.ExperimentSpec(
        data=TX.DataSpec(model=ae, device_x=dx, device_counts=counts,
                         test_x=tx, test_y=ty),
        base=T.SimConfig(num_devices=10, rounds=2, lr=1e-3, dropout=False),
        cells=(T.CellSpec("tolfl", 5), T.CellSpec("batch", 1),
               T.CellSpec("fedgroup", 2), T.CellSpec("fesem", 2)),
        traces=T.TraceSpec(traces=(T.NO_FAILURE,)), seeds=T.SeedSpec((3,)),
        fuse=False, exec_plan=T.ExecPlan(aot=True))
    res = TX.execute(TX.plan(spec), device="cpu")
    assert [b.aval_match for b in res.compile_report.buckets] == \
        [True] * 4


def test_clear_executable_caches_resets_counters(monkeypatch):
    TCC.count_resolution(hit=False)
    TCC.count_resolution(hit=True)
    monkeypatch.setitem(_build._RESOLVED, _build.CSRC / "x.so", "disk")
    engine._SCORE_CACHE[("planted",)] = object()
    assert TCC.xla_compile_stats()["requests"] >= 2
    T.clear_executable_caches()
    assert TCC.xla_compile_stats()["requests"] == 0
    assert not _build._RESOLVED and not engine._SCORE_CACHE
    assert _build.load.cache_info().currsize == 0
    assert T.clear_executable_caches is TC.clear_executable_caches
