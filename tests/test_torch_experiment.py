"""The declarative experiment pipeline (``core/experiment.py``, ``api.py``)
against ``repro``'s.

Port of ``tests/test_experiment.py``'s contracts, plus parity:

* **ExecPlan validation** — ``chunk_size`` / ``devices`` <= 0 raise
  ``repro``'s ``ValueError``; ``shard=True`` on one device warns and
  degrades to the unsharded path as ``repro``'s does, with the same
  results (sharding over several cards is not ported).
* **plan() is host work** — it runs here, with no card and no ``device``
  argument, and every sampled trace lies on the CPU.  For every spec of
  this file it equals ``repro``'s plan: the same ``describe()`` text; the
  same bucket kinds, ``cell_indices``, ``k_pad``, ``m_pad``,
  ``track_iso``, chunk geometry and loop configs (class included); the
  same ``explicit_index``, ``draws`` and ``process_draws``; byte-identical
  trace lists (sampled and process grids).
* **bucket grouping** — non-fl single cells share one fused bucket at the
  group max k, fl cells get their own iso bucket, batch cells are static,
  multi cells group per scheme with padded M; ``fuse=False`` /
  ``pad_k=False`` lower to per-cell / static buckets.
* **shim parity** — ``sweep_grid`` / ``run_campaign`` /
  ``run_fused_campaigns`` equal a hand-built spec through plan ->
  execute bit for bit on the CPU.
* **execute vs repro** — with ``repro``'s inits (``params0``) and draws,
  dropout off: curves within rtol 1e-4 / atol 1e-5, AUROCs within 1e-3,
  traces, seeds, ``iso_active`` and assignments exact (the campaign tests'
  tolerances); ``summary``, ``per_process``, ``process_summary`` and
  ``to_rows`` have ``repro``'s keys and values within the same.
* **api** — ``repro.api.__all__`` is the port's ``__all__`` plus
  ``NOT_PORTED``.
* **SeqDetector** — the cells of ``test_seq_detector_campaign_end_to_end``
  execute with finite AUROCs in [0, 1].
"""
import dataclasses
import warnings

import jax
import numpy as np
import pytest

import repro.api as J
import repro_torch.api as T
from repro.core import experiment as JX
from repro.data import commsml, federated
from repro_torch.core import experiment as TX
from repro_torch.core import failure as TF
from repro_torch.core.baselines import MultiDraws
from repro_torch.models.params import from_numpy_tree
from test_torch_baselines import kmeans_draws
from torch_threads import one_torch_thread  # noqa: F401

ROUNDS = 4
AE = dict(input_dim=commsml.N_FEATURES, hidden=(16,), code_dim=4,
          dropout=0.2)
RTOL, ATOL, AUROC_ATOL = 1e-4, 1e-5, 1e-3


@pytest.fixture(scope="module")
def data():
    X, y = commsml.generate(seed=0, samples_per_class=60)
    split = federated.make_split(X, y, num_devices=10, num_clusters=5,
                                 anomaly_classes=[3], seed=0)
    dx, counts = federated.pad_devices(split)
    return dx, counts, split.test_x, split.test_y


def _data_spec(api, data, model=None):
    dx, counts, tx, ty = data
    return api.DataSpec(model=model or api.AutoencoderConfig(**AE),
                        device_x=dx, device_counts=counts, test_x=tx,
                        test_y=ty, name="commsml")


def _base(api, **kw):
    return api.SimConfig(num_devices=10, rounds=ROUNDS, lr=1e-3,
                         dropout=False, **kw)


def _traces(api, n=3):
    kw = {"device": "cpu"} if api is T else {}
    topo = api.Topology(10, 5)
    return api.sample_traces(np.random.default_rng(3), topo, 0.5,
                             max_events=8, rounds=ROUNDS, num_traces=n, **kw)


def _both(build):
    """(repro's spec, the port's spec) from one function of an api."""
    return build(J), build(T)


# ---------------------------------------------------------------------------
# plan parity helpers
# ---------------------------------------------------------------------------
def _trace_key(t):
    if isinstance(t, (J.FailureSpec, T.FailureSpec)):
        return ("spec", t.epoch, t.kind, t.device)
    return tuple((np.asarray(getattr(t, f)).dtype.str,
                  np.asarray(getattr(t, f)).tobytes())
                 for f in ("epochs", "devices", "alive_after", "kinds"))


def _cfg_key(cfg):
    return type(cfg).__name__, dataclasses.asdict(cfg)


def assert_same_plan(jp, tp):
    assert tp.describe() == jp.describe()
    assert (tp.num_scenarios, tp.num_dispatch_buckets) == \
        (jp.num_scenarios, jp.num_dispatch_buckets)
    for jb, tb in zip(jp.buckets, tp.buckets, strict=True):
        for f in ("index", "kind", "fused", "cell_indices", "track_iso",
                  "k_pad", "m_pad", "num_scenarios", "chunk", "num_chunks",
                  "padded_scenarios", "devices"):
            assert getattr(tb, f) == getattr(jb, f), f
        assert _cfg_key(tb.key_cfg) == _cfg_key(jb.key_cfg)
    for jc, tc in zip(jp.cells, tp.cells, strict=True):
        for f in ("index", "kind", "explicit_index", "draws",
                  "process_draws", "num_scenarios", "key"):
            assert getattr(tc, f) == getattr(jc, f), f
        assert _cfg_key(tc.cfg) == _cfg_key(jc.cfg)
        assert [_trace_key(t) for t in tc.traces] == \
            [_trace_key(t) for t in jc.traces]
        for t in tc.traces:
            if isinstance(t, TF.FailureTrace):
                assert t.epochs.device.type == "cpu"


# ---------------------------------------------------------------------------
# ExecPlan validation
# ---------------------------------------------------------------------------
def test_execplan_rejects_nonpositive_chunk_size():
    for kw in (dict(chunk_size=0), dict(chunk_size=-4)):
        with pytest.raises(ValueError) as want:
            J.ExecPlan(**kw)
        with pytest.raises(ValueError, match="chunk_size must be a "
                           "positive") as got:
            T.ExecPlan(**kw)
        assert str(got.value) == str(want.value)


def test_execplan_rejects_nonpositive_devices():
    with pytest.raises(ValueError, match="devices must be a positive"):
        T.ExecPlan(devices=0)
    with pytest.raises(ValueError, match="devices"):
        T.ExecPlan(shard=True, devices=-1)


def test_execplan_shard_and_plan_check_not_ported(data):
    spec = T.ExperimentSpec(data=_data_spec(T, data), base=_base(T),
                            cells=(T.CellSpec("tolfl", 5),),
                            traces=T.TraceSpec.explicit(T.NO_FAILURE))
    # shard=True on one device: one warning an execute, the unsharded
    # path's results bit for bit
    sharded = dataclasses.replace(spec, exec_plan=T.ExecPlan(shard=True))
    with warnings.catch_warnings(record=True) as rec:
        warnings.simplefilter("always")
        got = T.run_experiment(sharded, device="cpu")
    assert len(rec) == 1 and str(rec[0].message).startswith(
        "ExecPlan(shard=True) found a single local device")
    _assert_equal_results(T.run_experiment(spec, device="cpu").results[0],
                          got.results[0])
    assert T.plan(sharded).describe() == T.plan(spec).describe()
    with pytest.raises(NotImplementedError, match="item 11"):
        T.plan(spec, check=True)
    p = T.plan(spec)
    with pytest.raises(NotImplementedError, match="item 11"):
        p.static_report()


def test_execplan_shard_degrades_like_repro(data):
    """``repro``'s ``test_execplan_shard_degrades_on_single_device``
    through both pipelines: a ``shard=True`` spec warns once in each
    ``execute`` and runs unsharded, the port's results ``repro``'s within
    the campaign tolerances (``repro``'s inits passed in)."""
    assert jax.local_device_count() == 1
    jspec, tspec = _both(lambda api: api.ExperimentSpec(
        data=_data_spec(api, data), base=_base(api),
        cells=(api.CellSpec("tolfl", 5),),
        traces=api.TraceSpec(traces=tuple(_traces(api, 2))),
        seeds=api.SeedSpec(SEEDS), exec_plan=api.ExecPlan(shard=True)))
    assert_same_plan(JX.plan(jspec), T.plan(tspec))
    params0 = [_repro_draws(s, 1, jspec.data.model)[0] for s in SEEDS]
    with pytest.warns(UserWarning, match="single local device"):
        want = JX.execute(JX.plan(jspec)).results[0]
    with pytest.warns(UserWarning, match="single local device"):
        got = T.execute(T.plan(tspec), params0=params0,
                        device="cpu").results[0]
    np.testing.assert_array_equal(got.trace_index, want.trace_index)
    np.testing.assert_array_equal(got.seed, want.seed)
    np.testing.assert_array_equal(got.iso_active, want.iso_active)
    np.testing.assert_allclose(got.loss_curves, want.loss_curves, rtol=RTOL,
                               atol=ATOL)
    np.testing.assert_allclose(got.auroc_used, want.auroc_used, rtol=0,
                               atol=AUROC_ATOL)


def test_plan_rejects_empty_grids(data):
    d = _data_spec(T, data)
    with pytest.raises(ValueError, match="need >= 1 cell"):
        T.plan(T.ExperimentSpec(data=d, base=_base(T), cells=()))
    spec = T.ExperimentSpec(data=d, base=_base(T),
                            cells=(T.CellSpec("tolfl", 5),),
                            traces=T.TraceSpec.explicit(T.NO_FAILURE),
                            seeds=T.SeedSpec(()))
    with pytest.raises(ValueError, match=">=1 trace and >=1 seed"):
        T.plan(spec)
    with pytest.raises(ValueError, match=">=1 trace and >=1 seed"):
        T.plan(T.ExperimentSpec(data=d, base=_base(T),
                                cells=(T.CellSpec("tolfl", 5),)))
    with pytest.raises(ValueError, match="unknown scheme"):
        T.plan(T.ExperimentSpec(data=d, base=_base(T),
                                cells=(T.CellSpec("fedavg", 3),),
                                traces=T.TraceSpec.explicit(T.NO_FAILURE)))


# ---------------------------------------------------------------------------
# plan(): host-only lowering, equal to repro's
# ---------------------------------------------------------------------------
MIXED = (("tolfl", 5), ("tolfl", 2), ("sbt", 10), ("fl", 1), ("batch", 1),
         ("ifca", 2), ("ifca", 3), ("fesem", 2))


def test_plan_bucket_grouping_equals_repro(data):
    jspec, tspec = _both(lambda api: api.ExperimentSpec(
        data=_data_spec(api, data), base=_base(api),
        cells=tuple(api.CellSpec(s, k) for s, k in MIXED),
        traces=api.TraceSpec(traces=tuple(_traces(api))),
        seeds=api.SeedSpec((0, 1))))
    p = T.plan(tspec)
    assert_same_plan(JX.plan(jspec), p)
    by_cells = {tuple(b.cell_indices): b for b in p.buckets}
    nonfl = by_cells[(0, 1, 2)]
    assert (nonfl.kind, nonfl.fused, nonfl.track_iso, nonfl.k_pad) == \
        ("single", True, False, 10)
    fl = by_cells[(3,)]
    assert (fl.kind, fl.fused, fl.track_iso, fl.k_pad) == \
        ("single", True, True, 1)
    assert (by_cells[(5, 6)].kind, by_cells[(5, 6)].m_pad) == ("multi", 3)
    assert by_cells[(7,)].m_pad == 2
    assert (by_cells[(4,)].fused, by_cells[(4,)].k_pad) == (False, None)
    assert p.num_scenarios == 48 and nonfl.num_scenarios == 18
    desc = p.describe()
    assert "pad_k=10" in desc and "pad_m=3" in desc and "iso" in desc


def test_plan_percell_and_static_modes_equal_repro(data):
    def build(api, **kw):
        return api.ExperimentSpec(
            data=_data_spec(api, data), base=_base(api),
            cells=(api.CellSpec("tolfl", 2), api.CellSpec("sbt", 10),
                   api.CellSpec("fl", 1), api.CellSpec("batch", 1),
                   api.CellSpec("ifca", 2)),
            traces=api.TraceSpec(traces=tuple(_traces(api))),
            seeds=api.SeedSpec((0,)), **kw)
    for kw in (dict(fuse=False), dict(fuse=False, pad_k=False),
               dict(k_pad=12), dict(fuse=False, k_pad=12), dict(m_pad=4)):
        jspec, tspec = _both(lambda api: build(api, **kw))
        assert_same_plan(JX.plan(jspec), T.plan(tspec))
    p = T.plan(build(T, fuse=False))
    assert [b.k_pad for b in p.buckets] == [10, 10, 1, None, None]
    assert [b.k_pad for b in T.plan(build(T, fuse=False, pad_k=False))
            .buckets] == [None] * 5
    assert [b.k_pad for b in T.plan(build(T, k_pad=12)).buckets] == \
        [12, 12, None, None]


def test_plan_geometry_equals_repro(data):
    jspec, tspec = _both(lambda api: api.ExperimentSpec(
        data=_data_spec(api, data), base=_base(api),
        cells=(api.CellSpec("tolfl", 5),),
        traces=api.TraceSpec(traces=tuple(_traces(api, 4))),
        seeds=api.SeedSpec((0, 1, 2)),
        exec_plan=api.ExecPlan(chunk_size=5)))
    b = T.plan(tspec).buckets[0]
    assert (b.num_scenarios, b.chunk, b.num_chunks, b.padded_scenarios,
            b.devices) == (12, 5, 3, 15, None)
    assert_same_plan(JX.plan(jspec), T.plan(tspec))


def _sampled(api, data, **kw):
    canonical = (api.NO_FAILURE, api.FailureSpec(epoch=2, kind="client"),
                 api.FailureSpec(epoch=2, kind="server"))
    return api.ExperimentSpec(
        data=_data_spec(api, data), base=_base(api),
        cells=(api.CellSpec("tolfl", 5), api.CellSpec("fl", 1),
               api.CellSpec("batch", 1), api.CellSpec("ifca", 3)),
        traces=api.TraceSpec(traces=canonical, p_grid=(0.3, 0.6),
                             traces_per_p=3, sample_seed=7, **kw),
        seeds=api.SeedSpec((0,)))


def test_plan_sampled_traces_per_topology_equal_repro(data):
    """Sampled on the host, against each cell's own topology, byte for
    byte ``repro``'s; batch drops the client condition."""
    jspec, tspec = _both(lambda api: _sampled(api, data))
    p = T.plan(tspec)
    assert_same_plan(JX.plan(jspec), p)
    tolfl, fl, batch, ifca = p.cells
    for c in (tolfl, fl, ifca):
        assert c.explicit_index == {0: 0, 1: 1, 2: 2}
        assert set(c.draws) == {0.3, 0.6}
        assert all(t.max_events == 20 for t in c.traces)
    assert batch.explicit_index == {0: 0, 1: None, 2: 1}
    for c in p.cells:
        keys = {_trace_key(t) for t in c.traces}
        assert len(keys) == len(c.traces)


def _processes(api, faulty=False):
    grids = [api.ProcessGrid(api.IidRateProcess(0.3), 3),
             api.ProcessGrid(api.MarkovChurnProcess(0.15, 0.3), 2),
             api.ProcessGrid(api.ClusterCascadeProcess(), 2)]
    if faulty:
        grids.append(api.ProcessGrid(api.FaultyUpdateProcess(0.4), 2))
    return tuple(grids)


@pytest.mark.parametrize("faulty", [False, True])
def test_plan_process_grids_equal_repro(data, faulty):
    """Process grids lower to the same pools and draw maps; a faulty
    process moves every cell onto the faulty engine's config class."""
    jspec, tspec = _both(lambda api: api.ExperimentSpec(
        data=_data_spec(api, data), base=_base(api),
        cells=(api.CellSpec("tolfl", 5), api.CellSpec("fl", 1),
               api.CellSpec("fesem", 2)),
        traces=api.TraceSpec.generated(*_processes(api, faulty),
                                       base=(api.NO_FAILURE,),
                                       sample_seed=11),
        seeds=api.SeedSpec((0, 1))))
    p = T.plan(tspec)
    assert_same_plan(JX.plan(jspec), p)
    assert all(isinstance(c.cfg, (T.FaultySimConfig,
                                  T.FaultyMultiModelConfig)) == faulty
               for c in p.cells)
    assert all(len(c.process_draws) == len(_processes(T, faulty))
               for c in p.cells)


def test_cell_sugar_and_overrides(data):
    c = T.cell("tolfl", 5, label="wide", lr=5e-4)
    assert c.resolve(_base(T)).lr == 5e-4
    assert c.key() == "wide"
    spec = T.ExperimentSpec(data=_data_spec(T, data), base=_base(T),
                            cells=(c,),
                            traces=T.TraceSpec.explicit(*_traces(T, 2)),
                            seeds=T.SeedSpec((0,)))
    p = T.plan(spec)
    assert p.cells[0].cfg.lr == 5e-4
    assert p.cell("wide").num_scenarios == 2
    assert T.SeedSpec.range(3, 2).seeds == J.SeedSpec.range(3, 2).seeds


def test_data_spec_ae_cfg_alias_warns_once(data):
    dx, counts, tx, ty = data
    kw = dict(device_x=dx, device_counts=counts, test_x=tx, test_y=ty)
    cfg = T.AutoencoderConfig(**AE)
    saved = TX._AE_CFG_WARNED
    TX._AE_CFG_WARNED = False
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            d1 = T.DataSpec(ae_cfg=cfg, **kw)
            T.DataSpec(ae_cfg=cfg, **kw)
        assert len([w for w in caught
                    if issubclass(w.category, DeprecationWarning)]) == 1
    finally:
        TX._AE_CFG_WARNED = saved
    assert isinstance(d1.model, T.AutoencoderDetector) and d1.ae_cfg == cfg
    with pytest.raises(TypeError):
        T.DataSpec(**kw)


# ---------------------------------------------------------------------------
# shims == spec -> plan -> execute, bit for bit on the CPU
# ---------------------------------------------------------------------------
GRID = [("tolfl", 5), ("tolfl", 2), ("sbt", 10), ("fl", 1), ("batch", 1),
        ("ifca", 2), ("ifca", 3)]


def _assert_equal_results(a, b):
    fields = (("auroc_used", "final_auroc", "iso_active", "loss_curves",
               "iso_loss_curves", "rounds_to_loss")
              if hasattr(a, "auroc_used") else
              ("best_auroc", "multi_auroc", "assignments", "loss_curves"))
    for f in ("trace_index", "seed") + fields:
        np.testing.assert_array_equal(getattr(a, f), getattr(b, f), f)


def test_spec_execute_reproduces_sweep_grid(data):
    dx, counts, tx, ty = data
    traces = _traces(T)
    grid = T.sweep_grid(T.AutoencoderConfig(**AE), dx, counts, tx, ty,
                        _base(T), GRID, traces, seeds=[0, 1],
                        target_loss=2430.0, device="cpu")
    spec = T.ExperimentSpec(
        data=_data_spec(T, data), base=_base(T),
        cells=tuple(T.CellSpec(s, k) for s, k in GRID),
        traces=T.TraceSpec(traces=tuple(traces)), seeds=T.SeedSpec((0, 1)),
        target_loss=2430.0)
    res = T.execute(T.plan(spec), device="cpu")
    assert res.num_scenarios == len(GRID) * 6
    assert res.compile_report is None
    for key, r in res.per_cell().items():
        _assert_equal_results(grid[key], r)
        assert res[key] is r
    rows = res.to_rows()
    assert len(rows) == res.num_scenarios and rows[0]["dataset"] == "commsml"
    assert all(s["num_scenarios"] == 6.0 for s in res.summary().values())


def test_run_campaign_shim_parity(data):
    dx, counts, tx, ty = data
    cfg = dataclasses.replace(_base(T), scheme="tolfl", num_clusters=5)
    traces = _traces(T)
    solo = T.run_campaign(T.AutoencoderConfig(**AE), dx, counts, tx, ty, cfg,
                          traces, seeds=range(2), pad_k=7, device="cpu")
    spec = T.ExperimentSpec(
        data=_data_spec(T, data), base=cfg,
        cells=(T.CellSpec("tolfl", 5, traces=tuple(traces)),),
        seeds=T.SeedSpec((0, 1)), fuse=False, k_pad=7)
    _assert_equal_results(solo, T.run_experiment(spec,
                                                 device="cpu").results[0])


def test_fused_shim_ragged_parity(data):
    dx, counts, tx, ty = data
    cfg_a = dataclasses.replace(_base(T), scheme="tolfl", num_clusters=5)
    cfg_b = dataclasses.replace(_base(T), scheme="sbt", num_clusters=10)
    tr_a, tr_b = _traces(T, 3), _traces(T, 2)
    fused = T.run_fused_campaigns(T.AutoencoderConfig(**AE), dx, counts, tx,
                                  ty, [(cfg_a, tr_a), (cfg_b, tr_b)],
                                  seeds=[0], device="cpu")
    spec = T.ExperimentSpec(
        data=_data_spec(T, data), base=_base(T),
        cells=(T.CellSpec("tolfl", 5, traces=tuple(tr_a)),
               T.CellSpec("sbt", 10, traces=tuple(tr_b))),
        seeds=T.SeedSpec((0,)))
    res = T.run_experiment(spec, device="cpu")
    assert [r.num_scenarios for r in res.results] == [3, 2]
    for a, b in zip(fused, res.results):
        _assert_equal_results(a, b)


# ---------------------------------------------------------------------------
# execute vs repro's execute: sampled rates and process grids, every scheme
# kind, with repro's inits and draws
# ---------------------------------------------------------------------------
SEEDS = (0, 1)
E2E = (("tolfl", 5), ("fl", 1), ("batch", 1), ("ifca", 2), ("ifca", 3))


def _e2e_spec(api, data):
    return api.ExperimentSpec(
        data=_data_spec(api, data), base=_base(api),
        cells=tuple(api.CellSpec(s, k) for s, k in E2E),
        traces=api.TraceSpec(
            traces=(api.NO_FAILURE, api.FailureSpec(2, "server")),
            p_grid=(0.3,), traces_per_p=2, sample_seed=5,
            processes=_processes(api)[:2]),
        seeds=api.SeedSpec(SEEDS), target_loss=2430.0)


def _repro_draws(seed, m, det):
    """``repro``'s init and multi-model draws of ``seed`` (its campaign
    cores' keys) as the port's operands."""
    def tree(p):
        return from_numpy_tree(jax.tree.map(np.asarray, p), device="cpu")
    key = jax.random.PRNGKey(seed)
    k_init, k_group, _ = jax.random.split(key, 3)
    k_probe, _, k_km = jax.random.split(k_group, 3)
    return tree(det.init_params(key)), MultiDraws(
        [tree(det.init_params(jax.random.fold_in(k_init, j)))
         for j in range(m)], tree(det.init_params(k_probe)),
        *kmeans_draws(k_km, m, 10))


@pytest.fixture(scope="module")
def e2e(data):
    jspec, tspec = _both(lambda api: _e2e_spec(api, data))
    jdet = jspec.data.model
    pairs = [_repro_draws(s, 3, jdet) for s in SEEDS]
    got = T.execute(T.plan(tspec), params0=[p for p, _ in pairs],
                    draws=[d for _, d in pairs], device="cpu")
    return JX.execute(JX.plan(jspec)), got


def test_execute_matches_repro(e2e):
    want, got = e2e
    assert_same_plan(want.plan, got.plan)
    for w, g in zip(want.results, got.results, strict=True):
        assert _cfg_key(g.cfg) == _cfg_key(w.cfg)
        np.testing.assert_array_equal(g.trace_index, w.trace_index)
        np.testing.assert_array_equal(g.seed, w.seed)
        np.testing.assert_allclose(g.loss_curves, w.loss_curves, rtol=RTOL,
                                   atol=ATOL)
        if hasattr(w, "auroc_used"):
            np.testing.assert_array_equal(g.iso_active, w.iso_active)
            for f in ("auroc_used", "final_auroc"):
                np.testing.assert_allclose(getattr(g, f), getattr(w, f),
                                           rtol=0, atol=AUROC_ATOL)
            np.testing.assert_array_equal(g.rounds_to_loss, w.rounds_to_loss)
        else:
            np.testing.assert_array_equal(g.assignments, w.assignments)
            for f in ("best_auroc", "multi_auroc"):
                np.testing.assert_allclose(getattr(g, f), getattr(w, f),
                                           rtol=0, atol=AUROC_ATOL)


def test_result_frames_match_repro(e2e):
    want, got = e2e
    assert got.num_scenarios == want.num_scenarios
    ws, gs = want.summary(), got.summary()
    assert list(gs) == list(ws)
    for key in ws:
        assert list(gs[key]) == list(ws[key])
        assert any(k.startswith("E[auroc] iid[0]") for k in gs[key])
        for name in ws[key]:
            np.testing.assert_allclose(gs[key][name], ws[key][name], rtol=0,
                                       atol=AUROC_ATOL, err_msg=name)
    wp, gp = want.per_process(), got.per_process()
    assert list(gp) == list(wp)
    for key in wp:
        assert list(gp[key]) == list(wp[key])
        for gi in wp[key]:
            np.testing.assert_allclose(gp[key][gi], wp[key][gi], rtol=0,
                                       atol=AUROC_ATOL)
    assert {k: list(v) for k, v in got.process_summary().items()} == \
        {k: list(v) for k, v in want.process_summary().items()}
    wr, gr = want.to_rows(), got.to_rows()
    assert len(gr) == len(wr)
    for w, g in zip(wr, gr):
        assert list(g) == list(w)
        for name in w:
            if isinstance(w[name], float):
                np.testing.assert_allclose(g[name], w[name], rtol=RTOL,
                                           atol=AUROC_ATOL, err_msg=name)
            else:
                assert g[name] == w[name], name


# ---------------------------------------------------------------------------
# api surface and the second body
# ---------------------------------------------------------------------------
def test_api_surface_matches_repro():
    assert set(J.__all__) == set(T.__all__) | set(T.NOT_PORTED)
    assert not set(T.__all__) & set(T.NOT_PORTED)
    assert all(hasattr(T, name) for name in T.__all__)
    assert T.SINGLE_SCHEMES == J.SINGLE_SCHEMES
    assert T.MULTI_SCHEMES == J.MULTI_SCHEMES


def test_seq_detector_spec_executes(data):
    """The cells of ``repro``'s ``test_seq_detector_campaign_end_to_end``
    through plan -> execute on the CPU."""
    dx, counts, tx, ty = data
    seq = T.SeqDetector(input_dim=commsml.N_FEATURES, window=16, d_model=8)
    spec = T.ExperimentSpec(
        data=T.DataSpec(model=seq, device_x=dx, device_counts=counts,
                        test_x=tx, test_y=ty, name="seq-e2e"),
        base=T.SimConfig(num_devices=10, rounds=2, lr=1e-3, dropout=False),
        cells=(T.CellSpec("tolfl", 2), T.CellSpec("fl", 1),
               T.CellSpec("ifca", 2)),
        traces=T.TraceSpec(traces=(T.NO_FAILURE, T.FailureSpec(1, "server"))),
        seeds=T.SeedSpec((0,)))
    res = T.execute(T.plan(spec), device="cpu")
    assert res.num_scenarios == 6
    for key, r in res.per_cell().items():
        auroc = r.auroc_used if hasattr(r, "auroc_used") else r.best_auroc
        assert np.all(np.isfinite(auroc)), (key, auroc)
        assert np.all((auroc >= 0.0) & (auroc <= 1.0)), (key, auroc)
