"""Multi-model campaign parity: the port's batched (cell x trace x seed)
campaigns of the clustered-FL baselines against its own looped
``run_multimodel`` and against ``repro``'s campaigns.

Port of ``tests/test_campaign.py``'s multi-model cases, dropout off.

* Against the port's ``run_multimodel`` looped over the scenarios: the
  same round loop at S = 1 and at S = B, asserted bit for bit on the CPU.
* Fused (padded M) against per-cell, and chunked against one-shot: rtol
  1e-6 / atol 1e-7, assignments exact.
* Against ``repro``'s ``run_multimodel_campaign``,
  ``run_fused_multimodel_campaigns`` and the multi cells of ``sweep_grid``
  with ``repro``'s draws passed in: curves rtol 1e-4 / atol 1e-5, AUROCs
  atol 1e-3 (``test_torch_campaign.py``'s tolerances), assignments,
  ``trace_index`` and ``seed`` exact.
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro.configs.autoencoder_paper import AutoencoderConfig as JCfg
from repro.core import baselines as JB
from repro.core import campaign as JC
from repro.core import failure as JF
from repro.core import simulate as JS
from repro.core.processes import trace_from_rows
from repro.data import commsml, federated
from repro_torch.configs.autoencoder_paper import AutoencoderConfig as TCfg
from repro_torch.core import baselines as TB
from repro_torch.core import campaign as TC
from repro_torch.core import failure as TF
from repro_torch.core import simulate as TS
from repro_torch.kernels import tolfl_combine as tc
from test_torch_baselines import jax_draws
from torch_threads import one_torch_thread  # noqa: F401

ROUNDS = 5
SEEDS = [0, 1]
AE = dict(input_dim=commsml.N_FEATURES, hidden=(16,), code_dim=4,
          dropout=0.2)
SCHEMES = ["fedgroup", "ifca", "fesem"]
SELF_RTOL, SELF_ATOL = 1e-6, 1e-7          # the port against itself
RTOL, ATOL, AUROC_ATOL = 1e-4, 1e-5, 1e-3  # the port against repro


@pytest.fixture(scope="module")
def data():
    X, y = commsml.generate(seed=0, samples_per_class=60)
    split = federated.make_split(X, y, num_devices=10, num_clusters=5,
                                 anomaly_classes=[3], seed=0)
    dx, counts = federated.pad_devices(split)
    return dx, counts, split.test_x, split.test_y


def _cfg(scheme="ifca", m=3, **kw):
    return TB.MultiModelConfig(scheme=scheme, num_devices=10, num_models=m,
                               rounds=ROUNDS, lr=1e-3, dropout=False, **kw)


def _jcfg(cfg):
    cls = (JB.FaultyMultiModelConfig if hasattr(cfg, "faulty_updates")
           else JB.MultiModelConfig)
    return cls(**dataclasses.asdict(cfg))


def _pairs():
    """(port, repro) trace lists: no failure, legacy client specs (the
    baseline default N-1, and a device with data), a server spec, a
    multi-event trace with a server event and a recovery."""
    jt, tt = JS.Topology(10, 5), TS.Topology(10, 5)
    jl = [JF.NO_FAILURE, JF.FailureSpec(1, "client"),
          JF.FailureSpec(1, "client", device=2), JF.FailureSpec(2, "server"),
          JF.FailureTrace.from_events(
              [JF.FailureEvent(1, "client", 1), JF.FailureEvent(2, "server"),
               JF.FailureEvent(3, "client", 1, recover=True)], jt)]
    tl = [TF.NO_FAILURE, TF.FailureSpec(1, "client"),
          TF.FailureSpec(1, "client", device=2), TF.FailureSpec(2, "server"),
          TF.FailureTrace.from_events(
              [TF.FailureEvent(1, "client", 1), TF.FailureEvent(2, "server"),
               TF.FailureEvent(3, "client", 1, recover=True)], tt,
              device="cpu")]
    return tl, jl


def _run(data, cfg, traces, seeds=SEEDS, **kw):
    dx, counts, tx, ty = data
    return TC.run_multimodel_campaign(TCfg(**AE), dx, counts, tx, ty, cfg,
                                      traces, seeds, device="cpu", **kw)


def _same_result(got, want, bitwise=False):
    for f in ("trace_index", "seed", "assignments"):
        np.testing.assert_array_equal(getattr(got, f), getattr(want, f), f)
    for f in ("loss_curves", "best_auroc", "multi_auroc"):
        np.testing.assert_allclose(getattr(got, f), getattr(want, f),
                                   rtol=SELF_RTOL, atol=SELF_ATOL, err_msg=f)
        if bitwise:
            np.testing.assert_array_equal(getattr(got, f), getattr(want, f),
                                          f)


def _close_to_repro(got, want):
    for f in ("trace_index", "seed", "assignments"):
        np.testing.assert_array_equal(getattr(got, f), getattr(want, f), f)
    np.testing.assert_allclose(got.loss_curves, want.loss_curves, rtol=RTOL,
                               atol=ATOL)
    for f in ("best_auroc", "multi_auroc"):
        np.testing.assert_allclose(getattr(got, f), getattr(want, f), rtol=0,
                                   atol=AUROC_ATOL, err_msg=f)
    gs, ws = got.summary(), want.summary()
    assert list(gs) == list(ws)
    for key in gs:
        np.testing.assert_allclose(gs[key], ws[key], rtol=0,
                                   atol=AUROC_ATOL, err_msg=key)


@pytest.fixture(scope="module")
def campaigns(data):
    tl, _ = _pairs()
    return {s: _run(data, _cfg(s), tl) for s in SCHEMES}


@pytest.mark.parametrize("scheme", SCHEMES)
def test_campaign_equals_looped_run_multimodel(scheme, data, campaigns):
    """A campaign row == ``run_multimodel`` with that seed and trace, bit
    for bit on the CPU; the grid is trace-major, seed-minor."""
    tl, _ = _pairs()
    dx, counts, tx, ty = data
    res = campaigns[scheme]
    np.testing.assert_array_equal(res.trace_index,
                                  np.repeat(np.arange(len(tl)), len(SEEDS)))
    np.testing.assert_array_equal(res.seed, np.tile(SEEDS, len(tl)))
    assert res.loss_curves.shape == (len(tl) * len(SEEDS), ROUNDS)
    assert res.assignments.shape == (len(tl) * len(SEEDS), 10)
    before = tc.ROUND_LAUNCHES, tc.LAUNCHES
    for b in range(res.num_scenarios):
        one = TB.run_multimodel(
            TCfg(**AE), dx, counts, tx, ty,
            dataclasses.replace(res.cfg, seed=int(res.seed[b])),
            tl[res.trace_index[b]], device="cpu")
        np.testing.assert_array_equal(res.loss_curves[b], one.loss_curve)
        np.testing.assert_array_equal(res.assignments[b], one.assignments)
        assert res.best_auroc[b] == one.best_auroc
        assert res.multi_auroc[b] == one.multi_auroc
    # the multi-model path launches none of the ported kernels
    assert (tc.ROUND_LAUNCHES, tc.LAUNCHES) == before
    assert [len(res.select(i)) for i in range(len(tl))] == [2] * len(tl)


@pytest.mark.parametrize("scheme", SCHEMES)
def test_fused_padded_equals_per_cell(scheme, data, campaigns):
    """Cells of M = 3 and M = 2 in one loop padded to M = 4 == each cell
    alone, unpadded."""
    tl, _ = _pairs()
    dx, counts, tx, ty = data
    res = TC.run_fused_multimodel_campaigns(
        TCfg(**AE), dx, counts, tx, ty,
        [(_cfg(scheme), tl), (_cfg(scheme, 2), tl[1:3])], SEEDS, pad_m=4,
        device="cpu")
    _same_result(res[0], campaigns[scheme])
    _same_result(res[1], _run(data, _cfg(scheme, 2), tl[1:3]))
    assert res[1].cfg.num_models == 2 and res[1].assignments.max() <= 1


@pytest.mark.parametrize("chunk", [3, 7])
def test_chunked_equals_one_shot(chunk, data, campaigns):
    """A chunk_size that does not divide B: padded, stripped, the same."""
    tl, _ = _pairs()
    for scheme in ("fedgroup", "fesem"):
        res = _run(data, _cfg(scheme), tl,
                   exec_plan=TC.ExecPlan(chunk_size=chunk))
        _same_result(res, campaigns[scheme])


@pytest.mark.parametrize("scheme", SCHEMES)
def test_campaign_matches_repro(scheme, data, campaigns):
    """Close to ``repro``'s campaign with ``repro``'s draws passed in."""
    tl, jl = _pairs()
    dx, counts, tx, ty = data
    want = JC.run_multimodel_campaign(JCfg(**AE), dx, counts, tx, ty,
                                      _jcfg(_cfg(scheme)), jl, SEEDS)
    got = _run(data, _cfg(scheme), tl,
               draws=[jax_draws(s, 3) for s in SEEDS])
    _close_to_repro(got, want)


def test_faulty_campaign_matches_repro(data):
    rows = [[(1, 11, 0.5, 3)], [(0, 13, -1.0, 3), (2, 4, 0.0, 1)], []]
    jl = [trace_from_rows(r, 4) for r in rows]
    tl = [TF.FailureTrace(*(torch.from_numpy(np.array(getattr(t, f)))
                            for f in ("epochs", "devices", "alive_after",
                                      "kinds"))) for t in jl]
    dx, counts, tx, ty = data
    cfg = TB.FaultyMultiModelConfig(**dataclasses.asdict(_cfg("ifca")))
    want = JC.run_multimodel_campaign(JCfg(**AE), dx, counts, tx, ty,
                                      _jcfg(cfg), jl, seeds=[1])
    got = _run(data, cfg, tl, seeds=[1], draws=[jax_draws(1, 3)])
    _close_to_repro(got, want)
    clean = _run(data, _cfg("ifca"), tl, seeds=[1], draws=[jax_draws(1, 3)])
    assert not np.array_equal(got.loss_curves[0], clean.loss_curves[0])


FUSED = [("ifca", 3), ("ifca", 2), ("fesem", 2)]
GRID = [("fedgroup", 2), ("ifca", 3), ("ifca", 2), ("fesem", 2)]


def _base(**kw):
    return TS.SimConfig(scheme="tolfl", num_devices=10, num_clusters=5,
                        rounds=ROUNDS, lr=1e-3, dropout=False, **kw)


def test_fused_campaigns_match_repro(data):
    """``repro``'s fused cells (ifca padded to M = 3 with its M = 2 cell,
    fesem alone), with a per-cell trace list."""
    tl, jl = _pairs()
    dx, counts, tx, ty = data
    tcells = [(_cfg(s, m), tl if s == "ifca" else tl[2:]) for s, m in FUSED]
    jcells = [(_jcfg(_cfg(s, m)), jl if s == "ifca" else jl[2:])
              for s, m in FUSED]
    want = JC.run_fused_multimodel_campaigns(JCfg(**AE), dx, counts, tx, ty,
                                             jcells, SEEDS)
    got = TC.run_fused_multimodel_campaigns(
        TCfg(**AE), dx, counts, tx, ty, tcells, SEEDS,
        draws=[jax_draws(s, 3) for s in SEEDS], device="cpu")
    assert [r.num_scenarios for r in got] == [10, 10, 6]
    for g, w, (cfg, _) in zip(got, want, tcells):
        assert g.cfg == cfg
        _close_to_repro(g, w)


def test_sweep_grid_multi_cells_match_repro(data):
    tl, jl = _pairs()
    dx, counts, tx, ty = data
    base = _base()
    want = JC.sweep_grid(JCfg(**AE), dx, counts, tx, ty,
                         JS.SimConfig(**dataclasses.asdict(base)), GRID, jl,
                         SEEDS)
    got = TC.sweep_grid(TCfg(**AE), dx, counts, tx, ty, base, GRID, tl,
                        SEEDS, draws=[jax_draws(s, 3) for s in SEEDS],
                        device="cpu")
    assert list(got) == list(want) == GRID
    for key in GRID:
        assert isinstance(got[key], TC.MultiCampaignResult)
        _close_to_repro(got[key], want[key])


@pytest.mark.parametrize("mode", ["unfused", "unpadded", "per_cell"])
def test_sweep_grid_paths_agree(mode, data):
    """fuse=True == fuse=False == pad_k=False == per-cell campaigns, beside
    a single-model cell; a multi cell derives its config from ``base``
    (rounds x local_epochs rounds, lr, dropout)."""
    tl, _ = _pairs()
    dx, counts, tx, ty = data
    base = dataclasses.replace(_base(), rounds=2, local_epochs=2)
    grid = [("tolfl", 5)] + GRID
    run = dict(model=TCfg(**AE), device_x=dx, device_counts=counts,
               test_x=tx, test_y=ty, base=base, scheme_ks=grid, traces=tl,
               seeds=SEEDS, device="cpu")
    fused = TC.sweep_grid(**run)
    assert isinstance(fused[("tolfl", 5)], TC.CampaignResult)
    for scheme, m in GRID:
        cfg = fused[(scheme, m)].cfg
        assert cfg == TB.MultiModelConfig(scheme=scheme, num_devices=10,
                                          num_models=m, rounds=4, lr=1e-3,
                                          dropout=False)
        if mode == "per_cell":
            other = _run(data, cfg, tl)
        else:
            other = TC.sweep_grid(**run, **({"fuse": False}
                                            if mode == "unfused"
                                            else {"pad_k": False}))[
                (scheme, m)]
        _same_result(fused[(scheme, m)], other)
        assert fused[(scheme, m)].loss_curves.shape == (10, 4)


def test_one_scenario_with_dropout_equals_run_multimodel(data):
    """A one-scenario chunk draws the dropout ``run_multimodel`` draws."""
    tl, _ = _pairs()
    dx, counts, tx, ty = data
    for scheme in SCHEMES:
        cfg = dataclasses.replace(_cfg(scheme), dropout=True)
        res = _run(data, cfg, tl[3:4], seeds=[3])
        one = TB.run_multimodel(TCfg(**AE), dx, counts, tx, ty,
                                dataclasses.replace(cfg, seed=3), tl[3],
                                device="cpu")
        np.testing.assert_array_equal(res.loss_curves[0], one.loss_curve)
        off = _run(data, _cfg(scheme), tl[3:4], seeds=[3])
        assert not np.array_equal(off.loss_curves[0], one.loss_curve)


def test_multi_metrics_and_summary_identical_to_repro():
    """Host numpy: identical columns from identical stacked scores, with
    and without padded model slots; identical summaries and selects."""
    rng = np.random.default_rng(6)
    B, M, T = 7, 4, 60
    finals = rng.random((B, M, T)).astype(np.float32)
    ty = (np.arange(T) % 5 == 0).astype(np.int32)
    mv = (np.arange(M)[None, :] < rng.integers(1, M + 1, (B, 1))).astype(
        np.float32)
    for valid in (None, mv):
        got = TC._multi_metrics(finals, ty, valid)
        want = JC._multi_metrics(finals, ty, valid)
        for a, b in zip(got, want):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)
    for n in (1, 2, 9):
        kw = dict(trace_index=np.arange(n) % 3, seed=np.arange(n),
                  best_auroc=rng.random(n), multi_auroc=rng.random(n),
                  loss_curves=np.zeros((n, 2)),
                  assignments=np.zeros((n, 10), np.int64))
        got = TC.MultiCampaignResult(cfg=_cfg(), **kw)
        want = JC.MultiCampaignResult(cfg=_jcfg(_cfg()), **kw)
        gs, ws = got.summary(), want.summary()
        assert list(gs) == list(ws)
        for key in gs:
            np.testing.assert_array_equal(gs[key], ws[key], err_msg=key)
        for col in ("best", "multi"):
            np.testing.assert_array_equal(got.select(0, col),
                                          want.select(0, col))
    assert [f.name for f in dataclasses.fields(TC.MultiCampaignResult)] == [
        f.name for f in dataclasses.fields(JC.MultiCampaignResult)]


def test_outputs_to_host_keeps_integer_fields():
    """One copy to the host; the int64 assignments come back exact."""
    out = TB.MultiOutputs(torch.rand((3, 4)), torch.rand((3, 2, 5)),
                          torch.tensor([[0, 1, 1], [2, 0, 1],
                                        [1, 1, 0]], dtype=torch.int64))
    host = TS.outputs_to_host(out)
    assert isinstance(host, TB.MultiOutputs)
    assert host.assignments.dtype == np.int64
    for a, b in zip(host, out):
        np.testing.assert_array_equal(a, b.numpy())


def test_unknown_and_bad_multi_cells_raise(data):
    tl, _ = _pairs()
    dx, counts, tx, ty = data
    with pytest.raises(ValueError, match="unknown scheme"):
        _run(data, _cfg("tolfl"), tl)
    with pytest.raises(ValueError, match="empty campaign"):
        _run(data, _cfg(), tl, seeds=[])
    with pytest.raises(ValueError, match="models"):
        TC.run_fused_multimodel_campaigns(TCfg(**AE), dx, counts, tx, ty,
                                          [(_cfg(), tl)], SEEDS, pad_m=2,
                                          device="cpu")
    with pytest.raises(ValueError, match="draws"):
        _run(data, _cfg(), tl, draws=[jax_draws(0, 3)])


@pytest.mark.parametrize("entry", ["run_multimodel", "campaign", "fused",
                                   "sweep_grid"])
def test_multi_entry_points_need_cuda(entry, data):
    """Without ``device`` the entry points run on the card, and raise when
    there is none."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    tl, _ = _pairs()
    dx, counts, tx, ty = data
    model = TCfg(**AE)
    calls = {
        "run_multimodel": lambda: TB.run_multimodel(model, dx, counts, tx,
                                                    ty, _cfg()),
        "campaign": lambda: TC.run_multimodel_campaign(
            model, dx, counts, tx, ty, _cfg(), tl, [0]),
        "fused": lambda: TC.run_fused_multimodel_campaigns(
            model, dx, counts, tx, ty, [(_cfg(), tl)], [0]),
        "sweep_grid": lambda: TC.sweep_grid(model, dx, counts, tx, ty,
                                            _base(), [("fesem", 2)], tl,
                                            [0]),
    }
    with pytest.raises(RuntimeError, match="no CUDA device"):
        calls[entry]()
