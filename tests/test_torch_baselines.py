"""Clustered-FL baselines (FedGroup / IFCA / FeSEM) in the port, against
``repro``'s and on their own, plus the reference datasets.

* Ports ``tests/test_baselines.py``'s cases on the port's own draws.
* Parity with ``repro``'s ``run_multimodel`` with ``repro``'s draws passed
  in (its PRNGKey inits, probe init and k-means draws) and dropout off:
  curves rtol 1e-4 / atol 1e-5, AUROCs atol 1e-3 (the tolerances of
  ``test_torch_simulate.py``: float32 sums in another order than XLA,
  amplified over the rounds; near-equal scores swap ranks), assignments
  equal.
* The shared-mask rule: in a round, IFCA's probe of every model and the
  training gradient apply the same dropout masks.
* ``reference.generate`` byte-identical to ``repro``'s, in one process
  (its seed depends on the interpreter's str hash).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.autoencoder_paper import AutoencoderConfig as JCfg
from repro.core import baselines as JB
from repro.core import failure as JF
from repro.core.processes import trace_from_rows
from repro.data import commsml
from repro.data import reference as JR
from repro.models.detector import AutoencoderDetector as JAD
from repro_torch.configs.autoencoder_paper import AutoencoderConfig as TCfg
from repro_torch.core import baselines as TB
from repro_torch.core import failure as TF
from repro_torch.core.topology import Topology
from repro_torch.data import reference as TR
from repro_torch.models import autoencoder as TAE
from repro_torch.models.detector import AutoencoderDetector as TAD
from repro_torch.models.params import FlatLayout, from_numpy_tree
from torch_threads import one_torch_thread  # noqa: F401

ROUNDS = 30                 # the learning cases, as tests/test_baselines.py
PARITY_ROUNDS = 5
AE = dict(input_dim=commsml.N_FEATURES, hidden=(16,), code_dim=4,
          dropout=0.2)
RTOL, ATOL, AUROC_ATOL = 1e-4, 1e-5, 1e-3
SCHEMES = ["fedgroup", "ifca", "fesem"]


def _tree(params):
    return from_numpy_tree(jax.tree.map(np.asarray, params), device="cpu")


def jax_draws(seed, m, n=10, ae=AE):
    """``repro``'s draws for ``seed`` (``_build_multimodel_core`` and
    ``_kmeans_groups``), as the port's operands."""
    det = JAD(JCfg(**ae))
    k_init, k_group, _ = jax.random.split(jax.random.PRNGKey(seed), 3)
    inits = [_tree(det.init_params(jax.random.fold_in(k_init, j)))
             for j in range(m)]
    k_probe, _, k_km = jax.random.split(k_group, 3)
    return TB.MultiDraws(inits, _tree(det.init_params(k_probe)),
                         *kmeans_draws(k_km, m, n))


def kmeans_draws(key, m, n):
    """(perm, reseed) that ``repro``'s ``_kmeans_groups`` draws from
    ``key``."""
    init_key, reseed_key = jax.random.split(key)
    reseed = jax.vmap(lambda i: jax.vmap(lambda j: jax.random.randint(
        jax.random.fold_in(jax.random.fold_in(reseed_key, i), j), (), 0,
        n))(jnp.arange(m)))(jnp.arange(TB.KMEANS_ITERS))
    return (np.array(jax.random.permutation(init_key, n)),
            np.array(reseed))


def _cfg(scheme, rounds=ROUNDS, dropout=True, faulty=False, seed=0):
    cls = TB.FaultyMultiModelConfig if faulty else TB.MultiModelConfig
    return cls(scheme=scheme, num_devices=10, num_models=3, rounds=rounds,
               lr=1e-3, dropout=dropout, seed=seed)


def _jcfg(cfg):
    cls = (JB.FaultyMultiModelConfig if hasattr(cfg, "faulty_updates")
           else JB.MultiModelConfig)
    return cls(**dataclasses.asdict(cfg))


def _run(padded, split, cfg, failure=TF.NO_FAILURE, draws=None):
    dx, counts = padded
    return TB.run_multimodel(TCfg(**AE), dx, counts, split.test_x,
                             split.test_y, cfg, failure, draws=draws,
                             device="cpu")


# ---------------------------------------------------------------------------
# tests/test_baselines.py's cases, on the port's own draws
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def learned(tiny_padded, tiny_split):
    return {s: _run(tiny_padded, tiny_split, _cfg(s)) for s in SCHEMES}


@pytest.mark.parametrize("scheme", SCHEMES)
def test_baseline_learns(scheme, learned):
    res = learned[scheme]
    assert res.best_auroc > 0.6, (scheme, res.best_auroc)
    assert res.multi_auroc > 0.6, (scheme, res.multi_auroc)
    assert res.loss_curve[-1] < res.loss_curve[0]
    assert res.assignments.shape == (10,)
    assert set(np.unique(res.assignments)).issubset({0, 1, 2})


@pytest.mark.parametrize("scheme", SCHEMES)
def test_baseline_multi_geq_best_usually(scheme, learned):
    """Paper Tables: the dagger (multi-model oracle) column is at least
    close to the starred (best single instance) column."""
    res = learned[scheme]
    assert res.multi_auroc > res.best_auroc - 0.1


@pytest.mark.parametrize("scheme", ["ifca", "fesem"])
def test_baseline_survives_failures(scheme, tiny_padded, tiny_split):
    for kind in ("client", "server"):
        res = _run(tiny_padded, tiny_split, _cfg(scheme),
                   TF.FailureSpec(epoch=ROUNDS // 2, kind=kind))
        assert np.isfinite(res.best_auroc)
        assert res.best_auroc > 0.5, (scheme, kind, res.best_auroc)


def test_kmeans_rejects_more_models_than_devices():
    vecs = torch.as_tensor(np.random.default_rng(0).normal(size=(3, 5)),
                           dtype=torch.float32)
    perm = torch.arange(3)
    with pytest.raises(ValueError, match="num_models"):
        TB._kmeans_groups(vecs, 4, perm, torch.zeros((20, 4), dtype=int))


def test_multimodel_fedgroup_more_models_than_devices_raises(tiny_padded,
                                                             tiny_split):
    cfg = TB.MultiModelConfig(scheme="fedgroup", num_devices=10,
                              num_models=11, rounds=1)
    with pytest.raises(ValueError, match="num_models"):
        _run(tiny_padded, tiny_split, cfg)


def test_kmeans_reseeds_empty_centers():
    """Three duplicate points + one outlier, M=2, with ``repro``'s draws
    from a key whose permutation seeds BOTH centers on duplicates: the
    second center wins no points and must be RE-SEEDED onto a data point
    (a stale center would merge the outlier into group 0)."""
    v = np.zeros((4, 3), np.float32)
    v[:3, 0] = 1.0                  # three copies of e1
    v[3, 1] = 1.0                   # one outlier at e2
    key = None
    for k in range(50):             # find an all-duplicate init
        perm = np.asarray(jax.random.permutation(
            jax.random.split(jax.random.PRNGKey(k))[0], 4))
        if 3 not in perm[:2]:
            key = jax.random.PRNGKey(k)
            break
    assert key is not None
    perm, reseed = kmeans_draws(key, 2, 4)
    assign = TB._kmeans_groups(torch.as_tensor(v), 2, torch.as_tensor(perm),
                               torch.as_tensor(reseed)).numpy()
    assert len(set(assign[:3].tolist())) == 1     # duplicates together
    assert assign[3] not in assign[:3]            # outlier got its own
    np.testing.assert_array_equal(
        assign, np.asarray(JB._kmeans_groups(jnp.asarray(v), 2, key)))


# ---------------------------------------------------------------------------
# parity with repro, repro's draws passed in, dropout off
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("m,pad", [(3, 3), (3, 5), (1, 4)])
def test_kmeans_matches_repro(m, pad):
    """Groups equal ``repro``'s from the same key; padded center slots
    (``center_valid`` 0) change nothing; a stack of 4 rows equals the rows
    one by one."""
    rng = np.random.default_rng(m + pad)
    vecs = rng.normal(size=(4, 10, 64)).astype(np.float32)
    keys = [jax.random.PRNGKey(7 + s) for s in range(4)]
    draws = [kmeans_draws(k, pad, 10) for k in keys]
    valid = (np.arange(pad) < m).astype(np.float32)
    want = np.asarray(jax.jit(jax.vmap(lambda v, k: JB._kmeans_groups(
        v, pad, k, center_valid=jnp.asarray(valid))))(jnp.asarray(vecs),
                                                      jnp.stack(keys)))
    got = TB._kmeans_groups(
        torch.as_tensor(vecs), pad,
        torch.as_tensor(np.stack([p for p, _ in draws])),
        torch.as_tensor(np.stack([r for _, r in draws])),
        torch.as_tensor(np.broadcast_to(valid, (4, pad)).copy())).numpy()
    np.testing.assert_array_equal(got, want)
    assert got.max() < m
    one = TB._kmeans_groups(torch.as_tensor(vecs[1]), m,
                            torch.as_tensor(draws[1][0]),
                            torch.as_tensor(draws[1][1][:, :m])).numpy()
    np.testing.assert_array_equal(one, got[1])


def _failures(kind):
    """(port, repro) failure of each parity case: a legacy client spec on
    a device with data, a legacy server spec (group 0), and, for the
    faulty engine, corrupted updates beside a client event."""
    if kind == "none":
        return TF.NO_FAILURE, JF.NO_FAILURE
    if kind == "client":
        return (TF.FailureSpec(2, "client", device=1),
                JF.FailureSpec(2, "client", device=1))
    if kind == "server":
        return TF.FailureSpec(2, "server"), JF.FailureSpec(2, "server")
    jt = trace_from_rows([(1, 11, 0.5, 3), (2, 13, -1.0, 3),
                          (3, 4, 0.0, 1)], 8)
    return (TF.FailureTrace(*(torch.from_numpy(np.array(getattr(jt, f)))
                              for f in ("epochs", "devices", "alive_after",
                                        "kinds"))), jt)


@pytest.mark.parametrize("kind", ["none", "client", "server", "faulty"])
@pytest.mark.parametrize("scheme", SCHEMES)
def test_run_multimodel_matches_repro(scheme, kind, tiny_padded,
                                      tiny_split):
    dx, counts = tiny_padded
    cfg = _cfg(scheme, PARITY_ROUNDS, dropout=False,
               faulty=kind == "faulty", seed=3)
    tf, jf = _failures(kind)
    want = JB.run_multimodel(JCfg(**AE), dx, counts, tiny_split.test_x,
                             tiny_split.test_y, _jcfg(cfg), jf)
    got = _run(tiny_padded, tiny_split, cfg, tf, draws=jax_draws(3, 3))
    np.testing.assert_allclose(got.loss_curve, want.loss_curve, rtol=RTOL,
                               atol=ATOL)
    np.testing.assert_array_equal(got.assignments, want.assignments)
    for f in ("best_auroc", "multi_auroc"):
        np.testing.assert_allclose(getattr(got, f), getattr(want, f), rtol=0,
                                   atol=AUROC_ATOL, err_msg=f)
    if kind == "faulty":
        clean = _run(tiny_padded, tiny_split,
                     _cfg(scheme, PARITY_ROUNDS, dropout=False, seed=3), tf,
                     draws=jax_draws(3, 3))
        assert not np.array_equal(got.loss_curve, clean.loss_curve)


def test_fedgroup_diverges_like_repro(tiny_padded, tiny_split):
    """At the paper's lr 1e-3 FedGroup's groups of one class train alone
    and can diverge (the unnormalised Comms-ML features, as FL's isolated
    fallback in ``test_torch_simulate.py``), in ``repro`` as in the port:
    with ``repro``'s draws both loss curves turn non-finite in the same
    round, stay so, and agree within the module's tolerances before it.
    ``chip_smoke.py`` lets FedGroup's curves diverge on the strength of
    this test."""
    ae = dict(AE, hidden=(32, 16), code_dim=8)
    dx, counts = tiny_padded
    cfg = _cfg("fedgroup", 12, dropout=False, seed=1)
    want = JB.run_multimodel(JCfg(**ae), dx, counts, tiny_split.test_x,
                             tiny_split.test_y, _jcfg(cfg))
    got = TB.run_multimodel(TCfg(**ae), dx, counts, tiny_split.test_x,
                            tiny_split.test_y, cfg,
                            draws=jax_draws(1, 3, ae=ae), device="cpu")
    np.testing.assert_array_equal(got.assignments, want.assignments)
    firsts = []
    for r in (want, got):
        bad = np.flatnonzero(~np.isfinite(r.loss_curve))
        assert bad.size, "FedGroup did not diverge"
        assert not np.isfinite(r.loss_curve[bad[0]:]).any()
        firsts.append(int(bad[0]))
    assert firsts[0] == firsts[1] > 1
    np.testing.assert_allclose(got.loss_curve[:firsts[0]],
                               want.loss_curve[:firsts[0]], rtol=RTOL,
                               atol=ATOL)


def test_configs_match_repro():
    """Field for field and in order, defaults included; class identity
    selects the faulty engine."""
    for tcls, jcls in ((TB.MultiModelConfig, JB.MultiModelConfig),
                       (TB.FaultyMultiModelConfig,
                        JB.FaultyMultiModelConfig)):
        got = [(f.name, f.default) for f in dataclasses.fields(tcls)]
        assert got == [(f.name, f.default) for f in dataclasses.fields(jcls)]
    assert [f.name for f in dataclasses.fields(TB.MultiModelResult)] == [
        f.name for f in dataclasses.fields(JB.MultiModelResult)]
    assert TB.MultiOutputs._fields == JB.MultiOutputs._fields


def _trace_arrays(t):
    return [np.asarray(getattr(t, f)) for f in ("epochs", "devices",
                                                "alive_after", "kinds")]


def test_multimodel_trace_and_split_match_repro():
    """Baseline default targets (client -> device N-1, server -> device
    0), explicit targets and traces; the split on a stacked trace equals
    ``repro``'s split of each trace."""
    jt = JF.FailureTrace.from_events(
        [JF.FailureEvent(1, "client", 2), JF.FailureEvent(2, "server", 4),
         JF.FailureEvent(3, "client", 2, recover=True)], JF.Topology(10, 5))
    tt = TF.FailureTrace.from_events(
        [TF.FailureEvent(1, "client", 2), TF.FailureEvent(2, "server", 4),
         TF.FailureEvent(3, "client", 2, recover=True)], Topology(10, 5),
        device="cpu")
    pairs = [(TF.NO_FAILURE, JF.NO_FAILURE),
             (TF.FailureSpec(3, "client"), JF.FailureSpec(3, "client")),
             (TF.FailureSpec(3, "server"), JF.FailureSpec(3, "server")),
             (TF.FailureSpec(4, "client", 5), JF.FailureSpec(4, "client", 5)),
             (tt, jt)]
    tts, jts = [], []
    for tf, jf in pairs:
        got = TB.as_multimodel_trace(tf, 10, device="cpu")
        want = JB.as_multimodel_trace(jf, 10)
        for a, b in zip(_trace_arrays(got), _trace_arrays(want)):
            np.testing.assert_array_equal(a, b)
            assert a.dtype == b.dtype
        tts.append(got)
        jts.append(want)
    stacked = TB._split_trace(TF.stack_traces(tts))
    for s, jt_ in enumerate(jts):
        for half, want in zip(stacked, JB._split_trace(jt_)):
            for a, b in zip(_trace_arrays(half), _trace_arrays(want)):
                np.testing.assert_array_equal(a[s], b)


# ---------------------------------------------------------------------------
# RNG: the shared-mask rule and the default draws
# ---------------------------------------------------------------------------
def test_dropout_masks_equal_inline_draws():
    """A forward pass with masks drawn up front equals one that draws
    inline from a generator in the same state."""
    det = TAD(TCfg(**AE))
    params = det.init_params(torch.Generator().manual_seed(0), device="cpu")
    x = torch.randn((3, 7, AE["input_dim"]),
                    generator=torch.Generator().manual_seed(1))
    inline = TAE.forward(params, det.cfg, x,
                         torch.Generator().manual_seed(5))
    masks = det.dropout_masks((3, 7), torch.Generator().manual_seed(5))
    assert [tuple(m.shape) for m in masks] == [(3, 7, 16), (3, 7, 4),
                                               (3, 7, 16)]
    assert torch.equal(TAE.forward(params, det.cfg, x, dropout_masks=masks),
                       inline)
    assert not torch.equal(inline, TAE.forward(params, det.cfg, x))


def test_ifca_round_shares_masks(tiny_padded):
    """One IFCA round with dropout on, redone by hand from the masks drawn
    with the same generator: each device's probe of every model and its
    gradient apply the same masks; the assignment and the updated models
    agree."""
    dx_np, counts_np = tiny_padded
    det = TAD(TCfg(**AE))
    S, M, N = 2, 3, 10
    draws = [TB.default_draws(det, s, N, M) for s in range(S)]
    tables = TB._draw_tables(det, "ifca", range(S), draws, N, M, "cpu")
    layout = tables.layout
    dx, counts, valid = TB.prepare_multimodel_arrays(dx_np[:, :40],
                                                     np.minimum(counts_np,
                                                                40), "cpu")
    tx = dx[0, :5]
    cfg = TB.MultiModelConfig(scheme="ifca", num_devices=N, num_models=M,
                              rounds=1, lr=1e-3, dropout=True)
    trace = TF.stack_traces([TF.FailureTrace.none(device="cpu")] * S)
    out, models = TB._multimodel_loop(det, cfg, layout, tables.inits,
                                      torch.ones((S, M)), dx, counts, valid,
                                      tx, trace, dropout_seed=11)
    masks = det.dropout_masks((S, N, dx.shape[1]),
                              torch.Generator().manual_seed(11))

    def loss(flat, s, i, with_masks=True):
        return det.loss(layout.unflatten(flat), dx[i], valid[i], None,
                        [m[s, i] for m in masks] if with_masks else None)

    want = tables.inits.clone()
    for s in range(S):
        assign = [int(torch.argmin(torch.stack(
            [loss(tables.inits[s, j], s, i) for j in range(M)])))
            for i in range(N)]
        assert assign == out.assignments[s].tolist()
        num, den = torch.zeros((M, layout.size), dtype=torch.float64), \
            torch.zeros(M, dtype=torch.float64)
        for i, a in enumerate(assign):
            p = tables.inits[s, a].clone().requires_grad_(True)
            g, = torch.autograd.grad(loss(p, s, i), p)
            if counts[i] > 0:
                p2 = tables.inits[s, a].clone().requires_grad_(True)
                g_plain, = torch.autograd.grad(loss(p2, s, i, False), p2)
                assert not torch.equal(g, g_plain)     # dropout did act
            num[a] += counts[i].double() * g.double()
            den[a] += counts[i].double()
        for j in range(M):
            if den[j] > 0:
                want[s, j] = (tables.inits[s, j].double()
                              - cfg.lr * num[j] / den[j]).float()
    torch.testing.assert_close(models, want, rtol=1e-5, atol=1e-7)


def test_default_draws_independent_of_padding():
    """Model j's init, the permutation's first entries and center j's
    reseed indices do not depend on the padded model count."""
    det = TAD(TCfg(**AE))
    a, b = (TB.default_draws(det, 4, 10, m) for m in (2, 5))
    for ta, tb in zip(a.inits, b.inits):
        layout = FlatLayout.of(ta)
        assert torch.equal(layout.flatten(ta), layout.flatten(tb))
    np.testing.assert_array_equal(a.perm, b.perm)
    np.testing.assert_array_equal(a.reseed, b.reseed[:, :2])
    assert sorted(a.perm.tolist()) == list(range(10))
    assert a.reseed.shape == (TB.KMEANS_ITERS, 2)
    c = TB.default_draws(det, 5, 10, 2)
    assert not np.array_equal(a.reseed, c.reseed)


# ---------------------------------------------------------------------------
# data/reference.py
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("name", sorted(JR.SPECS))
def test_reference_generate_byte_identical(name):
    assert TR.SPECS == {k: TR.RefSpec(*dataclasses.astuple(v))
                        for k, v in JR.SPECS.items()}
    assert TR.COMPONENTS_PER_CLASS == JR.COMPONENTS_PER_CLASS
    for seed, per in ((0, 4), (3, 2)):
        got, want = TR.generate(name, seed, per), JR.generate(name, seed, per)
        for a, b in zip(got, want):
            assert a.dtype == b.dtype and a.shape == b.shape
            assert a.tobytes() == b.tobytes()
