"""Scenario sharding (``ExecPlan(shard=True)`` over several devices) on
the CPU, through the one source of the shard devices,
``campaign._local_devices``, patched to four CPU devices.

* **Bit for bit against the unsharded run**: ``ExecPlan(shard=True,
  chunk_size=C)`` over D = 4 devices equals ``ExecPlan(chunk_size=
  ceil(min(C, B) / 4))`` unsharded, every result array byte for byte,
  with dropout on and off (each shard is one chunk of that run: the same
  rows, padding rows and dropout seed).  A Tol-FL cell of B = 10 (not
  divisible by 4) at chunk 6, an FL cell whose isolated fallback engages,
  a fused ``sweep_grid`` with padded k, a FedGroup grid with a padded-M
  cell and a ``SeqDetector`` cell.
* **Against ``repro``**: ``repro``'s sharded ``execute`` over four XLA
  host devices (a subprocess with ``--xla_force_host_platform_device_count
  =4``, as ``tests/test_campaign_exec.py`` runs it), dropout off, against
  the port's sharded run with ``repro``'s inits and draws: curves within
  rtol 1e-4 / atol 1e-5, AUROCs within 1e-3 (``test_torch_campaign.py``'s
  tolerances), traces, seeds, ``iso_active`` and assignments exact; and
  the two plans' ``describe()`` text equal.
* ``scenario_shard_map`` itself: the split, the replication (once for
  the same broadcast object), one named thread a shard, errors.
"""
import dataclasses
import json
import math
import os
import subprocess
import sys
import textwrap
import threading
import warnings
from pathlib import Path

import numpy as np
import pytest
import torch

import repro_torch.api as T
import repro_torch.sharding as TSH
from repro_torch.core import campaign as TC
from repro_torch.core import simulate as TS
from repro_torch.models.detector import SeqDetector
from repro_torch.sharding import logical as TL
from test_torch_experiment import _repro_draws
from torch_threads import one_torch_thread  # noqa: F401

SHARDS = 4
ROUNDS = 4
SEEDS = (0, 1)
CHUNK = 6
RTOL, ATOL, AUROC_ATOL = 1e-4, 1e-5, 1e-3  # the port against repro
ROOT = Path(__file__).resolve().parent.parent


@pytest.fixture
def four_cpus(monkeypatch):
    monkeypatch.setattr(TC, "_local_devices",
                        lambda: [torch.device("cpu")] * SHARDS)


def _ae(tiny_ae_cfg):
    return T.AutoencoderConfig(**dataclasses.asdict(tiny_ae_cfg))


def _traces():
    """Five conditions: B = 10 scenarios a cell over two seeds, a server
    failure among them (FL's isolated fallback)."""
    return [T.NO_FAILURE, T.FailureSpec(1, "client"),
            T.FailureSpec(1, "server"), T.FailureSpec(2, "server"),
            T.FailureSpec(2, "client")]


def _cfg(scheme="tolfl", k=5, dropout=False, lr=1e-3):
    return T.SimConfig(scheme=scheme, num_devices=10, num_clusters=k,
                       rounds=ROUNDS, lr=lr, dropout=dropout)


def _case(name, dropout, data, ae):
    """``run(exec_plan)`` of one case -> its list of results, and B (the
    largest bucket's scenarios)."""
    dx, counts, tx, ty = data
    tl = _traces()
    if name == "tolfl":
        return (lambda plan: [T.run_campaign(
            ae, dx, counts, tx, ty, _cfg(dropout=dropout), tl, SEEDS,
            exec_plan=plan, device="cpu")], 10)
    if name == "fl":
        return (lambda plan: [T.run_campaign(
            ae, dx, counts, tx, ty, _cfg("fl", 1, dropout), tl, SEEDS,
            exec_plan=plan, device="cpu")], 10)
    if name == "sweep":
        cells = [("tolfl", 2), ("sbt", 10)]          # one bucket, k_pad 10
        return (lambda plan: list(T.sweep_grid(
            ae, dx, counts, tx, ty, _cfg(dropout=dropout), cells, tl,
            SEEDS, exec_plan=plan, device="cpu").values()), 20)
    if name == "fedgroup":
        cells = [("fedgroup", 3), ("fedgroup", 2)]
        return (lambda plan: list(T.sweep_grid(
            ae, dx, counts, tx, ty, _cfg(dropout=dropout), cells, tl,
            SEEDS, exec_plan=plan, device="cpu").values()), 20)
    assert name == "seq"
    det = SeqDetector(input_dim=112, window=16, d_model=8, dropout=0.3)
    return (lambda plan: [T.run_campaign(
        det, dx, counts, tx, ty, _cfg(dropout=dropout, lr=1e-4), tl,
        SEEDS, exec_plan=plan, device="cpu")], 10)


def _fields(res):
    return {f.name: getattr(res, f.name) for f in dataclasses.fields(res)
            if f.name != "cfg"}


def _bitwise(got, want):
    for g, w in zip(got, want, strict=True):
        assert g.cfg == w.cfg
        for name, a in _fields(g).items():
            b = _fields(w)[name]
            assert a.dtype == b.dtype and a.shape == b.shape, name
            assert a.tobytes() == b.tobytes(), name


@pytest.mark.parametrize("dropout", [False, True], ids=["dropout_off",
                                                        "dropout_on"])
@pytest.mark.parametrize("name", ["tolfl", "fl", "sweep", "fedgroup",
                                  "seq"])
def test_sharded_equals_unsharded_at_the_shard_chunk(
        name, dropout, four_cpus, tiny_padded, tiny_split, tiny_ae_cfg,
        monkeypatch):
    data = (*tiny_padded, tiny_split.test_x, tiny_split.test_y)
    run, B = _case(name, dropout, data, _ae(tiny_ae_cfg))
    loops, loop = [], TS._round_loop

    def spy(*args, **kwargs):
        loops.append((threading.current_thread().name,
                      int(args[3].shape[0])))
        # the card's kernels take row-major operands only
        ops = [a for a in args if isinstance(a, torch.Tensor)] + [
            getattr(args[11], f) for f in ("epochs", "devices",
                                           "alive_after", "kinds")]
        assert all(t.is_contiguous() for t in ops)
        return loop(*args, **kwargs)

    monkeypatch.setattr(TS, "_round_loop", spy)
    with warnings.catch_warnings():
        warnings.simplefilter("error")          # no degrade warning
        got = run(T.ExecPlan(shard=True, chunk_size=CHUNK))
    sharded_loops = list(loops)
    want = run(T.ExecPlan(chunk_size=math.ceil(min(CHUNK, B) / SHARDS)))
    _bitwise(got, want)
    if name == "fl":
        assert got[0].iso_active.any() and not got[0].iso_active.all()
    if name != "fedgroup":
        # single-model loops: D shards of chunk / D scenarios, each on a
        # thread of its own; every shard of a chunk ran
        chunk = math.ceil(CHUNK / SHARDS) * SHARDS
        assert {s for _, s in sharded_loops} == {chunk // SHARDS}
        assert sorted({t for t, _ in sharded_loops}) == [
            f"scenario-shard-{d}" for d in range(SHARDS)]
        assert len(sharded_loops) % SHARDS == 0


def test_sharded_plan_geometry_and_aot(four_cpus, tiny_padded, tiny_split,
                                       tiny_ae_cfg):
    """The plan rounds the chunk up to a multiple of the shard width and
    says so; ``aot=True`` predicts each shard's operand shapes; no
    warning when sharding."""
    dx, counts = tiny_padded
    spec = T.ExperimentSpec(
        data=T.DataSpec(model=_ae(tiny_ae_cfg), device_x=dx,
                        device_counts=counts, test_x=tiny_split.test_x,
                        test_y=tiny_split.test_y),
        base=_cfg(), cells=(T.CellSpec("tolfl", 5), T.CellSpec("ifca", 2)),
        traces=T.TraceSpec(traces=tuple(_traces())),
        seeds=T.SeedSpec(SEEDS),
        exec_plan=T.ExecPlan(shard=True, chunk_size=CHUNK, aot=True))
    p = T.plan(spec)
    for b in p.buckets:
        assert (b.devices, b.chunk, b.num_chunks, b.padded_scenarios,
                b.loop_scenarios) == (SHARDS, 8, 2, 16, 2)
        assert "B=10(pad 16) chunks=2x8 shard=4dev" in b.describe()
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        res = T.execute(p, device="cpu")
    assert all(st.aval_match for st in res.compile_report.buckets)
    capped = dataclasses.replace(
        spec, exec_plan=T.ExecPlan(shard=True, chunk_size=CHUNK, devices=2))
    assert [b.devices for b in T.plan(capped).buckets] == [2, 2]


def test_plan_geometry_follows_the_run_device(monkeypatch, tiny_padded,
                                             tiny_split, tiny_ae_cfg):
    """``plan`` knows no device and shards over the cards; ``execute`` on
    the CPU of a host with four cards warns once, runs unsharded, and
    fills the buckets' geometry for what ran, so ``aot=True``'s predicted
    shapes still match."""
    monkeypatch.setattr(TC, "_local_devices",
                        lambda: [torch.device("cuda", i)
                                 for i in range(SHARDS)])
    dx, counts = tiny_padded
    spec = T.ExperimentSpec(
        data=T.DataSpec(model=_ae(tiny_ae_cfg), device_x=dx,
                        device_counts=counts, test_x=tiny_split.test_x,
                        test_y=tiny_split.test_y),
        base=_cfg(), cells=(T.CellSpec("tolfl", 5),),
        traces=T.TraceSpec(traces=tuple(_traces())),
        seeds=T.SeedSpec(SEEDS),
        exec_plan=T.ExecPlan(shard=True, chunk_size=CHUNK, aot=True))
    p = T.plan(spec)
    assert [(b.devices, b.chunk) for b in p.buckets] == [(SHARDS, 8)]
    with pytest.warns(UserWarning, match="single local device") as rec:
        res = T.execute(p, device="cpu")
    assert len(rec) == 1
    assert [(b.devices, b.chunk, b.loop_scenarios)
            for b in p.buckets] == [(None, CHUNK, CHUNK)]
    assert all(st.aval_match for st in res.compile_report.buckets)


def test_scenario_shard_map_contract(monkeypatch):
    devices = [torch.device("cpu")] * 3
    placed = []
    place = TL._place

    def counting(x, device):
        placed.append(x)
        return place(x, device)

    monkeypatch.setattr(TL, "_place", counting)
    seen = []

    def f(i, scale, table, rows, host):
        seen.append((i, threading.current_thread().name))
        assert isinstance(rows, torch.Tensor)
        assert isinstance(host, np.ndarray)
        return table[rows] * scale + torch.from_numpy(host)

    g = TSH.scenario_shard_map(f, devices, 2, 2)
    table = torch.arange(10.0)
    rows = torch.arange(6)
    host = np.arange(6, dtype=np.float32)
    outs = g(2.0, table, rows, host)
    assert len(outs) == 3
    torch.testing.assert_close(torch.cat(outs),
                               table[rows] * 2 + torch.from_numpy(host),
                               rtol=0, atol=0)
    assert sorted(seen) == [(d, f"scenario-shard-{d}") for d in range(3)]
    assert sum(x is table for x in placed) == 3
    g(2.0, table, rows, host)               # the same table: no new copy
    assert sum(x is table for x in placed) == 3
    other = table.clone()
    g(2.0, other, rows, host)
    assert sum(x is other for x in placed) == 3
    with pytest.raises(ValueError, match="split evenly"):
        g(2.0, table, torch.arange(5), np.arange(5))
    with pytest.raises(TypeError, match="arguments"):
        g(2.0, table, rows)

    def fails(i, x):
        if i == 1:
            raise RuntimeError("shard 1 failed")
        return x

    with pytest.raises(RuntimeError, match="shard 1 failed"):
        TSH.scenario_shard_map(fails, devices, 0, 1)(torch.zeros(3))
    one = TSH.scenario_shard_map(
        lambda i, x: (i, threading.current_thread().name, x.shape[0]),
        ["cpu"], 0, 1)
    assert one(torch.zeros(4)) == [(0, threading.current_thread().name, 4)]


def test_nothing_left_to_port():
    assert T.NOT_PORTED == () and T.NOT_PORTED_MODULES == ()
    assert TSH.scenario_shard_map is TL.scenario_shard_map
    assert "scenario_shard_map" in TSH.__all__


# ---------------------------------------------------------------------------
# against repro's sharded execute over four XLA host devices
# ---------------------------------------------------------------------------
REPRO_SCRIPT = textwrap.dedent("""
    import os
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    import json, sys
    import numpy as np
    import jax
    import repro.api as J
    from repro.data import commsml, federated

    assert jax.device_count() == 4, jax.device_count()
    X, y = commsml.generate(seed=0, samples_per_class=200)
    split = federated.make_split(X, y, num_devices=10, num_clusters=5,
                                 anomaly_classes=[3], seed=0)
    dx, counts = federated.pad_devices(split)
    spec = J.ExperimentSpec(
        data=J.DataSpec(model=J.AutoencoderConfig(
            input_dim=commsml.N_FEATURES, hidden=(32, 16), code_dim=8,
            dropout=0.2), device_x=dx, device_counts=counts,
            test_x=split.test_x, test_y=split.test_y),
        base=J.SimConfig(num_devices=10, rounds=%(rounds)d, lr=1e-3,
                         dropout=False),
        cells=(J.CellSpec("tolfl", 5), J.CellSpec("fl", 1),
               J.CellSpec("ifca", 2)),
        traces=J.TraceSpec(traces=(
            J.NO_FAILURE, J.FailureSpec(1, "client"),
            J.FailureSpec(1, "server"), J.FailureSpec(2, "server"),
            J.FailureSpec(2, "client"))),
        seeds=J.SeedSpec(%(seeds)r),
        exec_plan=J.ExecPlan(shard=True, chunk_size=%(chunk)d))
    p = J.plan(spec)
    r = J.run_campaign(spec.data.model, dx, counts, split.test_x,
                       split.test_y, J.SimConfig(
                           scheme="tolfl", num_devices=10, num_clusters=5,
                           rounds=%(rounds)d, lr=1e-3, dropout=False),
                       spec.traces.traces, %(seeds)r,
                       exec_plan=spec.exec_plan)
    np.savez(sys.argv[1], **{f: np.asarray(getattr(r, f)) for f in (
        "trace_index", "seed", "loss_curves", "iso_loss_curves",
        "auroc_used", "final_auroc", "iso_active")})
    with open(sys.argv[2], "w") as fh:
        json.dump({"describe": p.describe()}, fh)
""")


@pytest.fixture(scope="module")
def repro_sharded(tmp_path_factory):
    """``repro``'s sharded run and plan text, from a subprocess started
    here and awaited by :func:`port_sharded`, so that the port's run goes
    on meanwhile."""
    tmp = tmp_path_factory.mktemp("repro-sharded")
    script = tmp / "run.py"
    script.write_text(REPRO_SCRIPT % dict(rounds=ROUNDS, seeds=SEEDS,
                                          chunk=CHUNK))
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.Popen([sys.executable, str(script), str(tmp / "r.npz"),
                             str(tmp / "r.json")], env=env, cwd=ROOT,
                            stdout=subprocess.DEVNULL, stderr=subprocess.PIPE,
                            text=True)

    def result():
        _, err = proc.communicate(timeout=600)
        assert proc.returncode == 0, err[-4000:]
        return (dict(np.load(tmp / "r.npz")),
                json.loads((tmp / "r.json").read_text())["describe"])

    yield result
    if proc.poll() is None:
        proc.kill()
        proc.wait()


@pytest.fixture(scope="module")
def port_sharded(repro_sharded, tiny_padded, tiny_split, tiny_ae_cfg):
    """The port's plan of the subprocess's spec and its sharded
    ``run_campaign`` from ``repro``'s inits, over the four patched
    devices; then ``repro``'s (its subprocess's) results beside them."""
    from repro.configs.autoencoder_paper import AutoencoderConfig as JCfg
    from repro.models.detector import AutoencoderDetector as JAD
    dx, counts = tiny_padded
    exec_plan = T.ExecPlan(shard=True, chunk_size=CHUNK)
    spec = T.ExperimentSpec(
        data=T.DataSpec(model=_ae(tiny_ae_cfg), device_x=dx,
                        device_counts=counts, test_x=tiny_split.test_x,
                        test_y=tiny_split.test_y),
        base=T.SimConfig(num_devices=10, rounds=ROUNDS, lr=1e-3,
                         dropout=False),
        cells=(T.CellSpec("tolfl", 5), T.CellSpec("fl", 1),
               T.CellSpec("ifca", 2)),
        traces=T.TraceSpec(traces=tuple(_traces())),
        seeds=T.SeedSpec(SEEDS), exec_plan=exec_plan)
    jdet = JAD(JCfg(**dataclasses.asdict(tiny_ae_cfg)))
    params0 = [_repro_draws(s, 1, jdet)[0] for s in SEEDS]
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(TC, "_local_devices",
                   lambda: [torch.device("cpu")] * SHARDS)
        res = T.run_campaign(spec.data.model, dx, counts, tiny_split.test_x,
                             tiny_split.test_y, _cfg(), _traces(), SEEDS,
                             exec_plan=exec_plan, params0=params0,
                             device="cpu")
        port = (res, T.plan(spec).describe())
    return port, repro_sharded()


def test_sharded_plan_describes_as_repro(port_sharded):
    port, repro = port_sharded
    assert port[1] == repro[1]
    assert port[1].count("shard=4dev") == 3


def test_sharded_run_campaign_matches_repro(port_sharded):
    (got, _), (want, _) = port_sharded
    for f in ("trace_index", "seed", "iso_active"):
        np.testing.assert_array_equal(getattr(got, f), want[f], f)
    for f in ("loss_curves", "iso_loss_curves"):
        np.testing.assert_allclose(getattr(got, f), want[f], rtol=RTOL,
                                   atol=ATOL, err_msg=f)
    for f in ("auroc_used", "final_auroc"):
        np.testing.assert_allclose(getattr(got, f), want[f], rtol=0,
                                   atol=AUROC_ATOL, err_msg=f)
