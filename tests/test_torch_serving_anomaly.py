"""The anomaly-scoring service (``serving/anomaly``) in the port: its own
contracts on the CPU, bit for bit, and parity with ``repro``'s service.

Ports every contract of ``tests/test_serving_anomaly.py`` but the
plancheck budget of the score core (the analysis slice, ROADMAP queue 1,
item 11; the warm-service contract is the card's and lives in
``tests/test_torch_cuda.py``):

* the bank stacks the global model then the isolated ones, the isolated
  models differ, and the exported global model scores exactly as the
  round loop's final scores;
* failover and head scores equal direct scoring of the isolated or
  global model bit for bit; failover then failback on recovery;
  process-driven liveness is deterministic;
* FIFO order, a padded bucket equals the window scored alone, an
  oversized load splits into the largest buckets, the config validates
  and is frozen.

Against ``repro`` (its init carried across with ``from_numpy_tree``,
dropout off, the same submissions): routing, ``seq``, ``epoch``, the
timeline, failovers/failbacks, bucket use and drops exactly; scores
within rtol 1e-4 / atol 1e-5 (``test_torch_trained.py``'s tolerances:
float32 sums in another order than XLA over the training rounds); the
regime AUROCs within 1e-3; the alive table exactly.

The same bank, routing and service contracts hold for a ``SeqDetector``
bank (``repro``'s ``SeqDetector(input_dim=112, window=16, d_model=8)`` of
``tests/test_serving_anomaly.py``, at lr 1e-4, where its loss stays
finite), against ``repro``'s Seq bank and service with ``repro``'s init
passed as ``params0``.
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.core import processes as JP
from repro.core.simulate import SimConfig as JSimConfig
from repro.models.detector import SeqDetector as JSeq
from repro.serving import anomaly as JA
from repro.serving.anomaly import engine as JE
from repro_torch.configs.autoencoder_paper import AutoencoderConfig as TCfg
from repro_torch.core import failure as TF
from repro_torch.core import processes as TP
from repro_torch.core import simulate as TS
from repro_torch.models.detector import SeqDetector as TSeq
from repro_torch.models.detector import as_detector
from repro_torch.models.params import (from_numpy_tree, to_numpy_tree,
                                       tree_items)
from repro_torch.serving import anomaly as TA
from repro_torch.serving.anomaly import engine as TE
from test_torch_simulate import AE, _params0
from torch_threads import one_torch_thread  # noqa: F401

N, K = 10, 5
WINDOW = 4
RTOL, ATOL, AUROC_ATOL = 1e-4, 1e-5, 1e-3
CFG = dict(scheme="tolfl", num_devices=N, num_clusters=K, rounds=2,
           lr=1e-3, dropout=False)


@pytest.fixture(scope="module")
def bank(tiny_padded):
    dx, counts = tiny_padded
    return TA.train_model_bank(TCfg(**AE), dx, counts, TS.SimConfig(**CFG),
                               params0=_params0(0), device="cpu")


@pytest.fixture(scope="module")
def jbank(tiny_ae_cfg, tiny_padded):
    dx, counts = tiny_padded
    return JA.train_model_bank(tiny_ae_cfg, dx, counts, JSimConfig(**CFG))


@pytest.fixture(scope="module")
def windows(tiny_split):
    """A pool of (WINDOW, D) float32 traffic windows from the test set,
    with their per-row labels."""
    tx = np.asarray(tiny_split.test_x, np.float32)
    ty = np.asarray(tiny_split.test_y)
    n = tx.shape[0] // WINDOW
    return (tx[:n * WINDOW].reshape(n, WINDOW, tx.shape[-1]),
            ty[:n * WINDOW].reshape(n, WINDOW))


def head_dead_rows(cluster, epoch=0, recover=None):
    """Kill the head of ``cluster`` at ``epoch`` (optional recovery)."""
    head = cluster * (N // K)
    rows = [(epoch, head, 0.0, 2)]
    if recover is not None:
        rows.append((recover, head, 1.0, 2))
    return rows


def head_dead_trace(cluster, epoch=0, recover=None):
    return TP.trace_from_rows(head_dead_rows(cluster, epoch, recover), 4,
                              device="cpu")


def service(bank, buckets, failure=None, **kw):
    return TA.AnomalyService(
        bank, TA.ServiceConfig(bucket_sizes=buckets, window=WINDOW),
        failure=failure, **kw)


def score(params, x):
    """Direct scoring of one model, outside the service."""
    return as_detector(TCfg(**AE)).anomaly_scores(
        params, torch.from_numpy(x)).numpy()


# ---------------------------------------------------------------------------
# bank / params export
# ---------------------------------------------------------------------------
def test_bank_rows_stack_global_then_isolated(bank):
    rows = dict(tree_items(bank.row_params))
    iso = dict(tree_items(bank.iso_params))
    for path, g in tree_items(bank.global_params):
        assert rows[path].shape[0] == N + 1 and iso[path].shape[0] == N
        assert rows[path].device.type == "cpu"
        assert torch.equal(rows[path][0], g)
        assert torch.equal(rows[path][1:], iso[path])


def test_isolated_models_differ_from_global_and_each_other(bank):
    (_, g), = tree_items(bank.global_params)[:1]
    (_, i), = tree_items(bank.iso_params)[:1]
    assert not torch.equal(i[0], g)
    assert not torch.equal(i[0], i[1])


def test_trained_params_match_training_engine(tiny_padded):
    """The params export rides the SAME round loop as the simulator:
    scoring the exported global model reproduces the loop's final scores
    bit for bit."""
    dx, counts = tiny_padded
    cfg = TS.SimConfig(**CFG)
    tx = np.random.default_rng(0).normal(size=(3, dx.shape[-1])).astype(
        np.float32)
    params, _, _ = TS.trained_params(TCfg(**AE), dx, counts, cfg,
                                     params0=_params0(0), device="cpu")
    got = as_detector(TCfg(**AE)).anomaly_scores(params,
                                                 torch.from_numpy(tx))
    out, *_ = TS._scenario(TCfg(**AE), dx, counts, tx, cfg, TF.NO_FAILURE,
                           _params0(0), "cpu", isolated=False,
                           track_iso=True, score_history=False)
    assert torch.equal(got, out.final_scores)


def test_bank_matches_repro(bank, jbank):
    want = jax.tree.map(np.asarray, {"g": jbank.global_params,
                                     "i": jbank.iso_params,
                                     "r": jbank.row_params})
    got = {"g": to_numpy_tree(bank.global_params),
           "i": to_numpy_tree(bank.iso_params),
           "r": to_numpy_tree(bank.row_params)}
    for part in ("g", "i", "r"):
        for layer, leaves in want[part].items():
            for leaf, arr in leaves.items():
                g = got[part][layer][leaf]
                assert g.shape == arr.shape and g.dtype == arr.dtype
                np.testing.assert_allclose(g, arr, rtol=RTOL, atol=ATOL,
                                           err_msg=f"{part}/{layer}/{leaf}")
    assert bank.input_dim == jbank.input_dim
    assert bank.num_clients == jbank.num_clients == N
    for c in (0, 3, 9):
        for failover in (False, True):
            assert (bank.row_index(c, failover)
                    == jbank.row_index(c, failover))


def test_bank_without_device_needs_cuda(tiny_padded):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    dx, counts = tiny_padded
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TA.train_model_bank(TCfg(**AE), dx, counts, TS.SimConfig(**CFG))


# ---------------------------------------------------------------------------
# failover parity (bit-identical routing)
# ---------------------------------------------------------------------------
def test_failover_scores_bit_identical_to_isolated_model(bank, windows):
    wins, _ = windows
    svc = service(bank, (1, 8), head_dead_trace(cluster=0))
    client = 1                       # member of cluster 0, head dead
    svc.submit(client, wins[0])
    (res,) = svc.tick()
    assert res.served_by == "isolated"
    direct = score(bank.client_iso_params(client), wins[0])
    np.testing.assert_array_equal(res.scores, direct)


def test_head_scores_bit_identical_to_global_model(bank, windows):
    wins, _ = windows
    svc = service(bank, (1, 8), head_dead_trace(cluster=0))
    client = 7                       # cluster 3, head alive
    svc.submit(client, wins[1])
    (res,) = svc.tick()
    assert res.served_by == "head"
    np.testing.assert_array_equal(res.scores,
                                  score(bank.global_params, wins[1]))


def test_failover_then_failback_on_recovery(bank, windows):
    wins, _ = windows
    svc = service(bank, (1,), head_dead_trace(cluster=0, epoch=1,
                                              recover=3))
    client, modes = 0, []
    for _ in range(5):
        svc.submit(client, wins[2])
        (res,) = svc.tick()
        modes.append(res.served_by)
    assert modes == ["head", "isolated", "isolated", "head", "head"]
    rep = svc.report()
    assert (rep.failovers, rep.failbacks) == (1, 1)
    assert svc.timeline == [(1, client, "failover"),
                            (3, client, "failback")]
    assert rep.dropped == 0 and rep.windows == 5


def test_process_driven_service_samples_deterministically(bank):
    proc = TP.ClusterCascadeProcess(p_head=1.0)
    a = service(bank, (8,), proc, sample_seed=7)
    b = service(bank, (8,), proc, sample_seed=7)
    assert torch.equal(a._trace.epochs, b._trace.epochs)
    np.testing.assert_array_equal(a._alive_table, b._alive_table)


# ---------------------------------------------------------------------------
# queue coalescing
# ---------------------------------------------------------------------------
def test_queue_never_reorders_a_clients_windows(bank, windows):
    wins, _ = windows
    svc = service(bank, (1, 8))
    # 21 windows across 3 clients, interleaved: drains as 8+8+8(pad)
    order = [(c, i) for i in range(7) for c in (2, 5, 9)]
    for c, i in order:
        svc.submit(c, wins[i % len(wins)])
    res = svc.tick()
    assert len(res) == 21 and svc.report().dropped == 0
    for c in (2, 5, 9):
        seqs = [r.seq for r in res if r.client == c]
        assert seqs == sorted(seqs) == list(range(7))
    assert [(r.client, r.seq) for r in res] == order


def test_padded_batches_score_identically_to_exact_ones(bank, windows):
    """A window scored in a padded remainder batch equals the same window
    scored alone — padding rows are inert."""
    wins, _ = windows
    svc = service(bank, (1, 8))
    svc.submit(3, wins[0])
    svc.submit(4, wins[1])           # n=2 -> bucket 8, 6 padded rows
    padded = {r.client: r.scores for r in svc.tick()}
    alone = service(bank, (1,))
    alone.submit(3, wins[0])
    (solo,) = alone.tick()
    np.testing.assert_array_equal(padded[3], solo.scores)


def test_oversized_load_splits_into_max_buckets(bank, windows):
    wins, _ = windows
    svc = service(bank, (1, 8))
    for i in range(19):
        svc.submit(i % N, wins[i % len(wins)])
    res = svc.tick()
    assert len(res) == 19
    rep = svc.report()
    assert rep.bucket_batches == {1: 0, 8: 3}   # 8 + 8 + 3(padded)


def test_service_config_validates():
    with pytest.raises(AssertionError):
        TA.ServiceConfig(bucket_sizes=())
    with pytest.raises(AssertionError):
        TA.ServiceConfig(window=0)
    with pytest.raises(dataclasses.FrozenInstanceError):
        TA.ServiceConfig().window = 3
    assert TA.ServiceConfig() == TA.ServiceConfig(bucket_sizes=(1, 8, 64),
                                                  window=16)
    assert ([f.name for f in dataclasses.fields(TA.ServiceConfig)]
            == [f.name for f in dataclasses.fields(JA.ServiceConfig)])


def test_cpu_buckets_run_eager_and_score_their_own_bank(bank, tiny_padded,
                                                        windows):
    """On the CPU every bucket is an eager entry; a second bank's service
    scores with the second bank's weights."""
    wins, _ = windows
    dx, counts = tiny_padded
    other = TA.train_model_bank(TCfg(**AE), dx, counts,
                                TS.SimConfig(**CFG), params0=_params0(1),
                                device="cpu")
    for b in (bank, other):
        svc = service(b, (1, 8))
        assert svc.compile_sources == {1: "eager", 8: "eager"}
        svc.submit(6, wins[3])
        (res,) = svc.tick()
        np.testing.assert_array_equal(res.scores,
                                      score(b.global_params, wins[3]))
    entry, source = TE.score_entry(bank.detector, bank.row_params,
                                   (8, WINDOW, bank.input_dim))
    assert source == "eager" and not TE._SCORE_CACHE


# ---------------------------------------------------------------------------
# parity with repro's service
# ---------------------------------------------------------------------------
def _alive_cases():
    cascade = JP.ClusterCascadeProcess(p_head=1.0, recover_prob=1.0,
                                       recovery_lag=2)
    return {
        "none": None,
        "head_dead": head_dead_rows(0, epoch=1, recover=3),
        "cascade": cascade,
        "markov": JP.MarkovChurnProcess(p_fail=0.2, p_recover=0.4),
    }


def _port_failure(failure):
    if failure is None or isinstance(failure, list):
        return (None if failure is None
                else TP.trace_from_rows(failure, 4, device="cpu"))
    return getattr(TP, type(failure).__name__)(
        **dataclasses.asdict(failure))


def _repro_failure(failure):
    return (JP.trace_from_rows(failure, 4) if isinstance(failure, list)
            else failure)


@pytest.mark.parametrize("name", list(_alive_cases()))
def test_alive_table_equals_repro(name):
    failure = _alive_cases()[name]
    topo = TS.Topology(N, K)
    if failure is None or isinstance(failure, list):
        jt = (JA.service.as_trace(JA.service.NO_FAILURE, topo)
              if failure is None else _repro_failure(failure))
        tt = (TF.as_trace(TF.NO_FAILURE, topo, device="cpu")
              if failure is None else _port_failure(failure))
    else:
        seed = JP.process_seed(3, failure, 0)
        assert TP.process_seed(3, _port_failure(failure), 0) == seed
        jt = failure.sample(np.random.default_rng(seed), topo, 12)
        tt = _port_failure(failure).sample(np.random.default_rng(seed), topo,
                                           12, device="cpu")
    want = JE.alive_table(jt, N, 14)
    got = TE.alive_table(tt, N, 14)
    assert got.dtype == want.dtype == np.float32
    np.testing.assert_array_equal(got, want)


def _drive(svc, wins, labels, ticks=6):
    """The same submissions a tick: 1, 6, 11, ... windows over rotating
    clients (groups of every size, chunks past the largest bucket)."""
    out = []
    for t in range(ticks):
        for j in range(1 + 5 * t % 19):
            i = (7 * t + j) % len(wins)
            svc.submit((t + 3 * j) % N, wins[i], labels[i])
        out.extend(svc.tick())
    return out


@pytest.mark.parametrize("name", ["head_dead", "cascade"])
def test_service_matches_repro(name, bank, jbank, windows):
    _assert_service_matches(name, bank, jbank, windows)


def _assert_service_matches(name, bank, jbank, windows):
    wins, labels = windows
    failure = _alive_cases()[name]
    kw = dict(sample_seed=3, horizon=8)
    jsvc = JA.AnomalyService(jbank, JA.ServiceConfig(bucket_sizes=(1, 8),
                                                     window=WINDOW),
                             failure=_repro_failure(failure), **kw)
    tsvc = service(bank, (1, 8), _port_failure(failure), **kw)
    want = _drive(jsvc, wins, labels)
    got = _drive(tsvc, wins, labels)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert (g.client, g.seq, g.epoch, g.served_by) == (
            w.client, w.seq, w.epoch, w.served_by)
        assert g.scores.dtype == np.float32
        np.testing.assert_allclose(g.scores, np.asarray(w.scores),
                                   rtol=RTOL, atol=ATOL)
    assert tsvc.timeline == jsvc.timeline
    assert any(w.served_by == "isolated" for w in want)
    tr, jr = tsvc.report(), jsvc.report()
    for f in ("windows", "dropped", "batches", "failovers", "failbacks",
              "bucket_batches"):
        assert getattr(tr, f) == getattr(jr, f), f
    assert jr.failovers > 0 and tr.dropped == 0
    for f in ("auroc_head", "auroc_isolated"):
        np.testing.assert_allclose(getattr(tr, f), getattr(jr, f), rtol=0,
                                   atol=AUROC_ATOL, err_msg=f)


# ---------------------------------------------------------------------------
# a SeqDetector bank: the same contracts, against repro's Seq bank
# ---------------------------------------------------------------------------
SEQ = dict(input_dim=112, window=16, d_model=8)
SEQ_CFG = dict(CFG, lr=1e-4)


@pytest.fixture(scope="module")
def seq_bank(tiny_padded):
    dx, counts = tiny_padded
    p0 = JSeq(**SEQ).init_params(jax.random.PRNGKey(0))
    return TA.train_model_bank(
        TSeq(**SEQ), dx, counts, TS.SimConfig(**SEQ_CFG),
        params0=from_numpy_tree(jax.tree.map(np.asarray, p0), device="cpu"),
        device="cpu")


@pytest.fixture(scope="module")
def jseq_bank(tiny_padded):
    dx, counts = tiny_padded
    return JA.train_model_bank(JSeq(**SEQ), dx, counts,
                               JSimConfig(**SEQ_CFG))


def seq_score(params, x):
    return TSeq(**SEQ).anomaly_scores(params, torch.from_numpy(x)).numpy()


def test_seq_bank_matches_repro(seq_bank, jseq_bank):
    assert seq_bank.detector == TSeq(**SEQ)
    want = dict(tree_items(jax.tree.map(np.asarray, jseq_bank.row_params)))
    got = dict(tree_items(to_numpy_tree(seq_bank.row_params)))
    assert sorted(got) == sorted(want)
    for path, arr in want.items():
        assert got[path].shape == arr.shape == (N + 1,) + arr.shape[1:]
        assert got[path].dtype == arr.dtype
        np.testing.assert_allclose(got[path], arr, rtol=RTOL, atol=ATOL,
                                   err_msg=str(path))
    rows = dict(tree_items(seq_bank.row_params))
    for path, g in tree_items(seq_bank.global_params):
        assert torch.equal(rows[path][0], g)
    (_, g), = tree_items(seq_bank.global_params)[:1]
    (_, i), = tree_items(seq_bank.iso_params)[:1]
    assert not torch.equal(i[0], g) and not torch.equal(i[0], i[1])
    assert seq_bank.input_dim == jseq_bank.input_dim


def test_seq_routing_scores_bit_identical_to_direct(seq_bank, windows):
    """Failover, head and padded-bucket scores of the Seq bank equal its
    models scored directly, bit for bit."""
    wins, _ = windows
    svc = service(seq_bank, (1, 8), head_dead_trace(cluster=0))
    svc.submit(1, wins[0])           # cluster 0, head dead
    svc.submit(7, wins[1])           # cluster 3, head alive
    iso, head = sorted(svc.tick(), key=lambda r: r.client)
    assert (iso.served_by, head.served_by) == ("isolated", "head")
    np.testing.assert_array_equal(
        iso.scores, seq_score(seq_bank.client_iso_params(1), wins[0]))
    np.testing.assert_array_equal(
        head.scores, seq_score(seq_bank.global_params, wins[1]))
    alone = service(seq_bank, (1,))
    alone.submit(3, wins[0])
    (solo,) = alone.tick()
    padded = service(seq_bank, (1, 8))
    for c in (3, 4, 5):
        padded.submit(c, wins[0])    # n=3 -> bucket 8, 5 padded rows
    assert all(np.array_equal(r.scores, solo.scores)
               for r in padded.tick())
    got = TE.score_windows(seq_bank.detector, seq_bank.global_params,
                           torch.from_numpy(wins[:3]))
    np.testing.assert_array_equal(got.numpy(), np.stack(
        [seq_score(seq_bank.global_params, w) for w in wins[:3]]))


@pytest.mark.parametrize("name", ["head_dead", "cascade"])
def test_seq_service_matches_repro(name, seq_bank, jseq_bank, windows):
    _assert_service_matches(name, seq_bank, jseq_bank, windows)
