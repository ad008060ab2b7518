"""Campaign parity: the port's batched (cell x trace x seed) campaigns
against its own looped simulator and against ``repro``'s campaigns.

Port of ``tests/test_campaign.py``'s single-model cases, dropout off.

* Against the port's ``run_simulation`` looped over the scenarios: the
  same round loop at S = 1 and at S = B, so curves are held to rtol 1e-6
  / atol 1e-7, and on the CPU they agree bit for bit, which is asserted
  too; ``iso_active`` and masks exact.  The fused, unfused, unpadded,
  per-cell and chunked paths are held to the same.
* Against ``repro``'s ``run_campaign`` / ``sweep_grid`` with ``repro``'s
  PRNGKey inits passed in as ``params0``: curves rtol 1e-4 / atol 1e-5,
  AUROCs atol 1e-3, the tolerances of ``test_torch_simulate.py`` (float32
  sums in another order than XLA, amplified over the rounds; near-equal
  scores swap ranks); ``iso_active``, ``trace_index`` and ``seed`` exact.
"""
import dataclasses
import warnings

import jax
import numpy as np
import pytest
import torch

from repro.configs.autoencoder_paper import AutoencoderConfig as JCfg
from repro.core import campaign as JC
from repro.core import failure as JF
from repro.core import simulate as JS
from repro.core.processes import trace_from_rows
from repro.data import commsml, federated
from repro.models.detector import AutoencoderDetector as JAD
from repro_torch.configs.autoencoder_paper import AutoencoderConfig as TCfg
from repro_torch.core import campaign as TC
from repro_torch.core import failure as TF
from repro_torch.core import simulate as TS
from repro_torch.kernels import tolfl_combine as tc
from repro_torch.models.params import from_numpy_tree
from torch_threads import one_torch_thread  # noqa: F401

ROUNDS = 5
SEEDS = [0, 1]
AE = dict(input_dim=commsml.N_FEATURES, hidden=(16,), code_dim=4,
          dropout=0.2)
SELF_RTOL, SELF_ATOL = 1e-6, 1e-7          # the port against itself
RTOL, ATOL, AUROC_ATOL = 1e-4, 1e-5, 1e-3  # the port against repro


@pytest.fixture(scope="module")
def data():
    X, y = commsml.generate(seed=0, samples_per_class=60)
    split = federated.make_split(X, y, num_devices=10, num_clusters=5,
                                 anomaly_classes=[3], seed=0)
    dx, counts = federated.pad_devices(split)
    return dx, counts, split.test_x, split.test_y


def _cfg(scheme="tolfl", k=5, **kw):
    return TS.SimConfig(scheme=scheme, num_devices=10, num_clusters=k,
                        rounds=ROUNDS, lr=1e-3, dropout=False, **kw)


def _jcfg(cfg):
    cls = JS.FaultySimConfig if hasattr(cfg, "faulty_updates") else \
        JS.SimConfig
    return cls(**dataclasses.asdict(cfg))


def _pairs(topo_n=10, topo_k=5):
    """(port, repro) trace lists: none, timed client / server failures, a
    multi-event trace and a recovery, as ``tests/test_campaign.py``."""
    jt, tt = JS.Topology(topo_n, topo_k), TS.Topology(topo_n, topo_k)
    jl = [JF.NO_FAILURE, JF.FailureSpec(1, "client"),
          JF.FailureSpec(1, "server"), JF.FailureSpec(3, "server"),
          JF.FailureTrace.from_events([JF.FailureEvent(1, "client"),
                                       JF.FailureEvent(2, "server")], jt),
          JF.FailureTrace.from_events(
              [JF.FailureEvent(1, "client"),
               JF.FailureEvent(3, "client", recover=True)], jt)]
    tl = [TF.NO_FAILURE, TF.FailureSpec(1, "client"),
          TF.FailureSpec(1, "server"), TF.FailureSpec(3, "server"),
          TF.FailureTrace.from_events([TF.FailureEvent(1, "client"),
                                       TF.FailureEvent(2, "server")], tt,
                                      device="cpu"),
          TF.FailureTrace.from_events(
              [TF.FailureEvent(1, "client"),
               TF.FailureEvent(3, "client", recover=True)], tt,
              device="cpu")]
    return tl, jl


def _jax_inits(seeds):
    """``repro``'s own inits (its core draws PRNGKey(seed)) through the
    weight bridge."""
    return [from_numpy_tree(jax.tree.map(
        np.asarray, JAD(JCfg(**AE)).init_params(jax.random.PRNGKey(s))),
        device="cpu") for s in seeds]


def _run(data, cfg, traces, seeds=SEEDS, **kw):
    dx, counts, tx, ty = data
    return TC.run_campaign(TCfg(**AE), dx, counts, tx, ty, cfg, traces,
                           seeds, device="cpu", **kw)


def _same(got, want, what="", bitwise=True):
    """The port against itself: within rtol 1e-6, and bit for bit (the
    isolated-mean AUROC only within the tolerance: the looped simulator
    averages the per-device AUROCs with ``np.mean``, the campaign as a
    masked sum, as ``repro``'s do)."""
    np.testing.assert_allclose(got, want, rtol=SELF_RTOL, atol=SELF_ATOL,
                               err_msg=what)
    if bitwise:
        np.testing.assert_array_equal(got, want, err_msg=what)


def _same_result(a, b):
    for f in ("trace_index", "seed", "iso_active"):
        np.testing.assert_array_equal(getattr(a, f), getattr(b, f))
    for f in ("loss_curves", "iso_loss_curves", "auroc_used", "final_auroc",
              "iso_auroc", "rounds_to_loss"):
        _same(getattr(a, f), getattr(b, f), f)


@pytest.fixture(scope="module")
def tolfl(data):
    tl, _ = _pairs()
    return _run(data, _cfg(), tl, target_loss=2430.0)


def test_campaign_covers_grid(tolfl):
    """Every (trace, seed) once, trace-major and seed-minor."""
    n = len(_pairs()[0])
    assert tolfl.num_scenarios == n * len(SEEDS)
    np.testing.assert_array_equal(tolfl.trace_index,
                                  np.repeat(np.arange(n), len(SEEDS)))
    np.testing.assert_array_equal(tolfl.seed, np.tile(SEEDS, n))
    assert tolfl.loss_curves.shape == (tolfl.num_scenarios, ROUNDS)
    assert np.isfinite(tolfl.auroc_used).all()
    assert [len(tolfl.select(i)) for i in range(n)] == [len(SEEDS)] * n


@pytest.mark.parametrize("scheme,k", [("tolfl", 5), ("fl", 1)])
def test_campaign_equals_looped_simulator(scheme, k, data, tolfl):
    """A campaign row == ``run_simulation`` with that seed and trace (the
    port's init from the seed), Tol-FL and FL's isolated fallback."""
    tl, _ = _pairs()
    dx, counts, tx, ty = data
    cfg = _cfg(scheme, k)
    res = tolfl if scheme == "tolfl" else _run(data, cfg, tl)
    before = tc.ROUND_LAUNCHES, tc.LAUNCHES
    for b in range(res.num_scenarios):
        one = TS.run_simulation(
            TCfg(**AE), dx, counts, tx, ty,
            dataclasses.replace(cfg, seed=int(res.seed[b])),
            tl[res.trace_index[b]], device="cpu")
        assert one.iso_active == bool(res.iso_active[b])
        _same(res.loss_curves[b], one.loss_curve, "loss_curve")
        _same(res.iso_loss_curves[b], one.iso_loss_curve, "iso_loss_curve")
        _same(res.auroc_used[b], one.auroc_used, "auroc_used",
              bitwise=not one.iso_active)
        _same(res.final_auroc[b], one.final_auroc, "final_auroc")
    # the CPU runs the fused aggregation's plain version: no launches
    assert (tc.ROUND_LAUNCHES, tc.LAUNCHES) == before
    if scheme == "fl":
        assert res.iso_active.any() and not res.iso_active.all()


def test_campaign_outputs_masks_exact(data, monkeypatch):
    """The raw stacked outputs' masks equal the per-scenario ones."""
    tl, _ = _pairs()
    dx, counts, tx, ty = data
    cfg = _cfg("fl", 1)
    outs, loop = [], TS._round_loop

    def spy(*args, **kwargs):
        res = loop(*args, **kwargs)
        outs.append(res[0])
        return res
    monkeypatch.setattr(TS, "_round_loop", spy)
    camp = _run(data, cfg, tl)
    monkeypatch.undo()
    assert len(outs) == 1                # one round loop for the campaign
    out = outs[0]
    for b in range(camp.num_scenarios):
        one = TS._scenario(TCfg(**AE), dx, counts, tx,
                           dataclasses.replace(cfg, seed=int(camp.seed[b])),
                           tl[camp.trace_index[b]], None, "cpu",
                           isolated=False, track_iso=True,
                           score_history=False)[0]
        for f in ("final_alive", "server_dead", "server_dead_rounds"):
            np.testing.assert_array_equal(getattr(out, f)[b].numpy(),
                                          getattr(one, f).numpy(), f)
        _same(out.final_scores[b].numpy(), one.final_scores.numpy())


@pytest.fixture(scope="module")
def repro_tolfl(data):
    _, jl = _pairs()
    dx, counts, tx, ty = data
    return JC.run_campaign(JCfg(**AE), dx, counts, tx, ty, _jcfg(_cfg()),
                           jl, seeds=SEEDS, target_loss=2430.0)


def _close_to_repro(got, want):
    for f in ("trace_index", "seed", "iso_active"):
        np.testing.assert_array_equal(getattr(got, f), getattr(want, f), f)
    for f in ("loss_curves", "iso_loss_curves"):
        np.testing.assert_allclose(getattr(got, f), getattr(want, f),
                                   rtol=RTOL, atol=ATOL, err_msg=f)
    for f in ("auroc_used", "final_auroc", "iso_auroc"):
        np.testing.assert_allclose(getattr(got, f), getattr(want, f), rtol=0,
                                   atol=AUROC_ATOL, err_msg=f)
    gs, ws = got.summary(), want.summary()
    assert gs.keys() == ws.keys()
    for key in gs:
        np.testing.assert_allclose(gs[key], ws[key], rtol=0,
                                   atol=AUROC_ATOL, err_msg=key)


def test_campaign_matches_repro(data, repro_tolfl):
    tl, _ = _pairs()
    got = _run(data, _cfg(), tl, target_loss=2430.0,
               params0=_jax_inits(SEEDS))
    _close_to_repro(got, repro_tolfl)
    np.testing.assert_array_equal(got.rounds_to_loss,
                                  repro_tolfl.rounds_to_loss)


def test_faulty_campaign_matches_repro(data):
    """The faulty-update engine variant: corrupted transmitted deltas."""
    rows = [[(1, 11, 0.5, 3)], [(0, 13, -1.0, 3), (2, 4, 0.0, 1)], []]
    jl = [trace_from_rows(r, 4) for r in rows]
    tl = [TF.FailureTrace(*(torch.from_numpy(np.array(getattr(t, f)))
                            for f in ("epochs", "devices", "alive_after",
                                      "kinds"))) for t in jl]
    dx, counts, tx, ty = data
    cfg = TS.FaultySimConfig(**dataclasses.asdict(_cfg()))
    want = JC.run_campaign(JCfg(**AE), dx, counts, tx, ty, _jcfg(cfg), jl,
                           seeds=[1])
    got = _run(data, cfg, tl, seeds=[1], params0=_jax_inits([1]))
    _close_to_repro(got, want)
    clean = _run(data, _cfg(), tl, seeds=[1], params0=_jax_inits([1]))
    assert not np.array_equal(got.loss_curves[0], clean.loss_curves[0])


GRID = [("tolfl", 5), ("tolfl", 2), ("sbt", 10), ("fl", 1), ("batch", 1)]


@pytest.fixture(scope="module")
def sweeps(data):
    tl, _ = _pairs()
    dx, counts, tx, ty = data
    base = _cfg()
    run = dict(model=TCfg(**AE), device_x=dx, device_counts=counts,
               test_x=tx, test_y=ty, base=base, scheme_ks=GRID, traces=tl,
               seeds=SEEDS, device="cpu")
    return {"fused": TC.sweep_grid(**run),
            "unfused": TC.sweep_grid(**run, fuse=False),
            "unpadded": TC.sweep_grid(**run, pad_k=False)}


@pytest.mark.parametrize("mode", ["unfused", "unpadded", "per_cell"])
def test_sweep_grid_paths_agree(mode, sweeps, data):
    """fuse=True == fuse=False == pad_k=False == per-cell run_campaign."""
    tl, _ = _pairs()
    for (scheme, k), res in sweeps["fused"].items():
        assert res.cfg.scheme == scheme and res.cfg.num_clusters == k
        other = (_run(data, _cfg(scheme, k), tl) if mode == "per_cell"
                 else sweeps[mode][(scheme, k)])
        _same_result(res, other)


def test_sweep_grid_close_to_repro(sweeps, data):
    """Per-cell results close to ``repro``'s fused sweep on the same grid
    (the port's sweep again, with ``repro``'s inits)."""
    tl, jl = _pairs()
    dx, counts, tx, ty = data
    want = JC.sweep_grid(JCfg(**AE), dx, counts, tx, ty, _jcfg(_cfg()),
                         GRID, jl, seeds=SEEDS)
    got = TC.sweep_grid(TCfg(**AE), dx, counts, tx, ty, _cfg(), GRID, tl,
                        SEEDS, params0=_jax_inits(SEEDS), device="cpu")
    assert list(got) == list(want) == GRID
    for key in GRID:
        _close_to_repro(got[key], want[key])
    assert got[("fl", 1)].iso_active.any()      # FL's isolated fallback


def test_run_fused_campaigns_per_cell_traces(data, sweeps):
    """Cells with their own trace lists, aligned results; a cell that
    shares the sweep's list equals the sweep's cell."""
    tl, _ = _pairs()
    dx, counts, tx, ty = data
    cells = [(_cfg("tolfl", 5), tl), (_cfg("sbt", 10), tl[:2]),
             (_cfg("fl", 1), tl[2:4])]
    res = TC.run_fused_campaigns(TCfg(**AE), dx, counts, tx, ty, cells,
                                 SEEDS, device="cpu")
    assert [r.num_scenarios for r in res] == [12, 4, 4]
    _same_result(res[0], sweeps["fused"][("tolfl", 5)])
    with pytest.raises(ValueError, match="batch"):
        TC.run_fused_campaigns(TCfg(**AE), dx, counts, tx, ty,
                               [(_cfg("batch", 1), tl)], SEEDS, device="cpu")


@pytest.mark.parametrize("chunk", [1, 5, 7])
def test_chunked_equals_one_shot(chunk, tolfl, data):
    """A chunk_size that does not divide B: padded, stripped, the same."""
    tl, _ = _pairs()
    res = _run(data, _cfg(), tl, target_loss=2430.0,
               exec_plan=TC.ExecPlan(chunk_size=chunk))
    _same_result(res, tolfl)


def test_mean_ci95_and_summary_identical_to_repro():
    rng = np.random.default_rng(4)
    for vals in (np.array([0.8, 0.9]), np.array([0.7]),
                 rng.random(17), np.array([0.5, 0.5, 0.5])):
        assert TC.mean_ci95(vals) == JC.mean_ci95(vals) or (
            len(vals) == 1 and np.isnan(TC.mean_ci95(vals)[2]))
        r = len(vals)
        kw = dict(trace_index=np.arange(r) % 2, seed=np.arange(r),
                  auroc_used=vals, final_auroc=vals,
                  iso_auroc=np.full(r, np.nan), iso_active=np.zeros(r, bool),
                  loss_curves=np.zeros((r, 1)),
                  iso_loss_curves=np.zeros((r, 1)),
                  rounds_to_loss=np.where(np.arange(r) % 3 == 0, np.nan,
                                          np.arange(r) + 1.0))
        got = TC.CampaignResult(cfg=TS.SimConfig(), **kw)
        want = JC.CampaignResult(cfg=JS.SimConfig(), **kw)
        gs, ws = got.summary(), want.summary()
        assert list(gs) == list(ws)
        for key in gs:
            np.testing.assert_array_equal(gs[key], ws[key], err_msg=key)
        np.testing.assert_array_equal(got.select(1), want.select(1))
    assert TC.mean_ci95(np.array([0.7]))[:2] == (0.7, 0.0)


def test_post_process_arrays_identical_to_repro():
    """Host numpy: identical arrays from identical stacked outputs."""
    rng = np.random.default_rng(5)
    B, R, N, T = 6, 4, 10, 40
    out = TS.SimOutputs(
        losses=rng.random((B, R)).astype(np.float32) * 3000,
        iso_losses=rng.random((B, R)).astype(np.float32) * 3000,
        final_scores=rng.random((B, T)).astype(np.float32),
        iso_final_scores=rng.random((B, N, T)).astype(np.float32),
        final_alive=(rng.random((B, N)) < 0.7).astype(np.float32),
        server_dead=(np.arange(B) % 2).astype(np.float32),
        server_dead_rounds=(rng.random((B, R)) < 0.5).astype(np.float32),
        score_hist=np.zeros((B, R, 0), np.float32),
        iso_score_hist=np.zeros((B, R, 0, 0), np.float32))
    ty = (np.arange(T) % 4 == 0).astype(np.int32)
    for track_iso in (False, True):
        for target in (None, 1500.0):
            got = TC._post_process_arrays(track_iso, out, ty, target)
            want = JC._post_process_arrays(track_iso, out, ty, target)
            assert list(got) == list(want)
            for key in got:
                assert got[key].dtype == want[key].dtype, key
                np.testing.assert_array_equal(got[key], want[key], key)


def test_padded_topology_arrays_match_repro():
    for n, k, k_pad in ((10, 5, 10), (10, 1, 5), (10, 10, 10), (12, 3, 4)):
        cids, heads, hv = TS.topology_arrays(TS.Topology(n, k), k_pad)
        want = JC._padded_topology_arrays(JS.Topology(n, k), k_pad)
        for got, arr in zip((cids, heads, hv), want):
            np.testing.assert_array_equal(got, np.asarray(arr))
    with pytest.raises(ValueError, match="bad topology"):
        TS.topology_arrays(TS.Topology(10, 5), 4)


def test_exec_plan_errors_as_repro():
    for kw in (dict(chunk_size=0), dict(chunk_size=-3), dict(devices=0)):
        with pytest.raises(ValueError) as want:
            JC.ExecPlan(**kw)
        with pytest.raises(ValueError) as got:
            TC.ExecPlan(**kw)
        assert str(got.value) == str(want.value)
    assert TC.ExecPlan(aot=True).aot and JC.ExecPlan(aot=True).aot
    assert TC.ExecPlan(chunk_size=4).chunk_size == 4
    # shard=True on a single device: repro's degrade contract
    # (tests/test_experiment.py), the port's warning repro's without its
    # XLA_FLAGS hint
    assert jax.local_device_count() == 1
    msgs = []
    for mod in (JC, TC):
        with pytest.warns(UserWarning, match="single local device") as rec:
            assert mod.ExecPlan(shard=True).resolved_devices() is None
        msgs.append(str(rec[0].message))
        with warnings.catch_warnings():
            warnings.simplefilter("error")
            assert mod.ExecPlan(shard=True).resolved_devices(
                warn=False) is None
            assert mod.ExecPlan(shard=False).resolved_devices() is None
    assert msgs[0].startswith(msgs[1])


def test_exec_plan_shard_over_cards(monkeypatch):
    """Over more than one card the shard width is the card count, capped
    at ``devices``; one card of several (``devices=1``) and a run on the
    CPU degrade."""
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    assert TC.ExecPlan(shard=True).num_devices() == 4
    assert TC.ExecPlan(shard=True, devices=2).num_devices() == 2
    assert TC.ExecPlan(shard=True).resolved_devices() == 4
    assert TC.ExecPlan(shard=True, devices=2).resolved_devices(
        warn=False) == 2
    for plan, dev in ((TC.ExecPlan(shard=True, devices=1), None),
                      (TC.ExecPlan(shard=True), "cpu")):
        with pytest.warns(UserWarning, match="single local device"):
            assert plan.resolved_devices(device=dev) is None
    assert TC.ExecPlan(shard=False).resolved_devices() is None


def test_unported_and_bad_cells_raise(data):
    tl, _ = _pairs()
    dx, counts, tx, ty = data
    # a multi-model cell runs beside a single-model one (ported since the
    # multi-model campaign; tests/test_torch_multicampaign.py holds it)
    res = TC.sweep_grid(TCfg(**AE), dx, counts, tx, ty, _cfg(),
                        [("tolfl", 5), ("ifca", 2)], tl, SEEDS, device="cpu")
    assert isinstance(res[("ifca", 2)], TC.MultiCampaignResult)
    assert res[("ifca", 2)].num_scenarios == len(tl) * len(SEEDS)
    assert np.isfinite(res[("ifca", 2)].loss_curves).all()
    with pytest.raises(ValueError, match="unknown scheme"):
        TC.sweep_grid(TCfg(**AE), dx, counts, tx, ty, _cfg(), [("x", 2)],
                      tl, SEEDS, device="cpu")
    with pytest.raises(ValueError, match="empty campaign"):
        _run(data, _cfg(), tl, seeds=[])
    with pytest.raises(ValueError, match="empty campaign"):
        _run(data, _cfg(), [], seeds=[0])


def test_dropout_seed_rule():
    """One scenario, chunk 0: its own seed, as run_simulation's."""
    assert TC.dropout_seed([7]) == 7
    assert TC.dropout_seed([0, 1, 2, 3]) == (1 * 1_000_003
                                             + 2 * 1_000_003 ** 2
                                             + 3 * 1_000_003 ** 3) % 2 ** 63
    assert TC.dropout_seed([7], 1) != TC.dropout_seed([7], 0)


def test_one_scenario_with_dropout_equals_run_simulation(data):
    """A one-scenario chunk draws the dropout run_simulation draws."""
    tl, _ = _pairs()
    dx, counts, tx, ty = data
    cfg = dataclasses.replace(_cfg(), dropout=True)
    res = _run(data, cfg, tl[2:3], seeds=[3])
    one = TS.run_simulation(TCfg(**AE), dx, counts, tx, ty,
                            dataclasses.replace(cfg, seed=3), tl[2],
                            device="cpu")
    _same(res.loss_curves[0], one.loss_curve)


def test_campaign_without_device_needs_cuda(data):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    tl, _ = _pairs()
    dx, counts, tx, ty = data
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TC.run_campaign(TCfg(**AE), dx, counts, tx, ty, _cfg(), tl[:1], [0])
