"""Generative failure processes (``core/processes.py``) in the port.

The samplers are host numpy, so the port's traces must be BYTE-identical
to ``repro``'s: both packages' generators start from the same seed and
are drawn in the same order, and ``process_seed`` hashes ``repr`` of
classes with ``repro``'s names, fields, order and defaults.  Checked for
every family x intensities {0.1, 0.5, 1.0} x seeds 0-3 x topologies
(10, 5), (12, 4), (10, 10), at the default slot budget and at a tight one
of 2 and 3; also ``sample_process_grids`` (index map, pool, dedup against
base traces) and ``family_process``.

Ported from ``tests/test_processes.py``: its host-only sampler and
packing contracts and its trace round trips.  A small dropout-free
``run_campaign`` under cascade traces (``SimConfig``) and under straggler
and faulty traces (``FaultySimConfig``) is held to ``repro``'s with the
campaign tests' tolerances.
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro.configs.autoencoder_paper import AutoencoderConfig as JCfg
from repro.core import campaign as JC
from repro.core import failure as JF
from repro.core import processes as JP
from repro.core.topology import Topology as JTopo
from repro_torch.core import failure as TF
from repro_torch.core import processes as TP
from repro_torch.core import simulate as TS
from repro_torch.core.topology import Topology as TTopo
from test_torch_campaign import (AE, _close_to_repro, _jax_inits, _jcfg,
                                 _run, data)  # noqa: F401
from test_torch_failure import _same_trace
from torch_threads import one_torch_thread  # noqa: F401

TOPOS = [(10, 5), (12, 4), (10, 10)]
INTENSITIES = (0.1, 0.5, 1.0)
SEEDS = range(4)
BUDGETS = (None, 2, 3)            # the default, and tight ones
ROUNDS = 24


def port_process(proc):
    """The port's process of the same class and fields as ``proc``."""
    return getattr(TP, type(proc).__name__)(**dataclasses.asdict(proc))


def _rows(t):
    """Real (epoch, device, alive_after, kind) rows of a port trace."""
    ep, dev = t.epochs.numpy(), t.devices.numpy()
    alv, knd = t.alive_after.numpy(), t.kinds.numpy()
    real = ep < TF.PAD_EPOCH
    return list(zip(ep[real].tolist(), dev[real].tolist(),
                    alv[real].tolist(), knd[real].tolist()))


# ---------------------------------------------------------------------------
# byte parity with repro
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("topo", TOPOS, ids=lambda t: f"{t[0]}x{t[1]}")
@pytest.mark.parametrize("family", JP.FAMILIES)
def test_family_traces_byte_identical(family, topo):
    """Every intensity, seed and budget: the same trace, byte for byte,
    the same default budget, and both generators left in one state."""
    jt, tt = JTopo(*topo), TTopo(*topo)
    for intensity in INTENSITIES:
        jproc = JP.family_process(family, intensity)
        tproc = TP.family_process(family, intensity)
        assert type(tproc).__name__ == type(jproc).__name__
        assert repr(tproc) == repr(jproc)
        assert tproc.family == jproc.family == family
        assert tproc.needs_faulty_engine == jproc.needs_faulty_engine
        assert tproc.default_max_events(tt) == jproc.default_max_events(jt)
        for seed in SEEDS:
            assert (TP.process_seed(seed, tproc, 2)
                    == JP.process_seed(seed, jproc, 2))
            for budget in BUDGETS:
                jr = np.random.default_rng(seed)
                tr = np.random.default_rng(seed)
                want = jproc.sample(jr, jt, ROUNDS, max_events=budget)
                got = tproc.sample(tr, tt, ROUNDS, max_events=budget,
                                   device="cpu")
                _same_trace(got, want)
                assert jr.random() == tr.random()


@pytest.mark.parametrize("proc", [
    JP.IidRateProcess(), JP.MarkovChurnProcess(p_fail=0.15, p_recover=0.4),
    JP.ClusterCascadeProcess(p_head=0.7, q=0.5, recovery_lag=3, stagger=2),
    JP.StragglerProcess(p=0.6, window=4),
    JP.FaultyUpdateProcess(p=0.5, scale=-1.0, window=5),
    JP.FaultyUpdateProcess(p=1.0, scale=0.25)], ids=repr)
def test_process_seed_and_repr_equal_for_every_family(proc):
    """Non-default fields too: ``repr`` (hence every seed) agrees."""
    tproc = port_process(proc)
    assert repr(tproc) == repr(proc)
    assert [f.name for f in dataclasses.fields(tproc)] == [
        f.name for f in dataclasses.fields(proc)]
    for seed, draw in ((0, 0), (3, 1), (2 ** 40, 7)):
        assert (TP.process_seed(seed, tproc, draw)
                == JP.process_seed(seed, proc, draw))
    assert hash(tproc) == hash(port_process(proc))


@pytest.mark.parametrize("topo", TOPOS, ids=lambda t: f"{t[0]}x{t[1]}")
def test_sample_process_grids_identical_to_repro(topo):
    """The same index map and the same trace pool, deduplicated against
    the base traces (p = 0 draws alias the no-failure base trace)."""
    jt, tt = JTopo(*topo), TTopo(*topo)
    m = 2 * topo[0]
    grids = [(JP.MarkovChurnProcess(0.2, 0.5), 3),
             (JP.StragglerProcess(p=0.0), 3),
             (JP.ClusterCascadeProcess(p_head=0.6), 4),
             (JP.FaultyUpdateProcess(p=0.5, window=3), 2),
             (JP.IidRateProcess(p=0.3), 2)]
    jgrids = [JP.ProcessGrid(p, n) for p, n in grids]
    tgrids = [TP.ProcessGrid(port_process(p), n) for p, n in grids]
    jpool = [JF.FailureTrace.none(m)]
    tpool = [TF.FailureTrace.none(m, device="cpu")]
    want = JP.sample_process_grids(jgrids, jt, ROUNDS, 5, m, jpool)
    got = TP.sample_process_grids(tgrids, tt, ROUNDS, 5, m, tpool,
                                  device="cpu")
    assert got == want
    assert got[1] == [0, 0, 0]
    assert len(tpool) == len(jpool)
    for t, j in zip(tpool, jpool):
        _same_trace(t, j)


def test_family_process_maps_as_repro():
    for fam in JP.FAMILIES:
        for intensity in (0.0, 0.3, 1.0):
            assert (repr(TP.family_process(fam, intensity))
                    == repr(JP.family_process(fam, intensity)))
    assert TP.FAMILIES == JP.FAMILIES
    with pytest.raises(ValueError, match="unknown process family"):
        TP.family_process("nope", 0.3)


def test_trace_from_rows_identical_to_repro():
    rows = [(3, 2, 0.0, 1), (1, 14, -1.0, 3), (3, 2, 1.0, 1), (0, 0, 0.0, 2)]
    _same_trace(TP.trace_from_rows(rows, 6, device="cpu"),
                JP.trace_from_rows(rows, 6))
    with pytest.raises(AssertionError):
        TP.trace_from_rows(rows, 3, device="cpu")


# ---------------------------------------------------------------------------
# ported host-only contracts of tests/test_processes.py
# ---------------------------------------------------------------------------
TOPO = TTopo(6, 2)
SMALL_ROUNDS = 20
ALL_PROCESSES = (TP.IidRateProcess(p=0.5),
                 TP.MarkovChurnProcess(p_fail=0.15, p_recover=0.4),
                 TP.ClusterCascadeProcess(p_head=0.7),
                 TP.StragglerProcess(p=0.6, window=4),
                 TP.FaultyUpdateProcess(p=0.5, scale=-1.0, window=5))


def sample(proc, seed=0, topo=TOPO, rounds=SMALL_ROUNDS, max_events=None):
    return proc.sample(np.random.default_rng(seed), topo, rounds,
                       max_events=max_events, device="cpu")


def assert_well_formed(t, topo, rounds):
    """Sorted real rows, PAD tail, in-range epochs, device ids in [0, N)
    or the shadow range [N, 2N) for kind-3 rows, never a recovery before
    its device's first failure."""
    ep = t.epochs.numpy()
    real = ep < TF.PAD_EPOCH
    n_real = int(real.sum())
    assert real[:n_real].all() and not real[n_real:].any()
    assert (np.diff(ep[:n_real]) >= 0).all()
    n = topo.num_devices
    first_seen = {}
    for e, d, a, k in _rows(t):
        assert 0 <= e < rounds
        if k == TF.KIND_CODES["faulty"]:
            assert n <= d < 2 * n
        else:
            assert 0 <= d < n
            assert k in (TF.KIND_CODES["client"], TF.KIND_CODES["server"])
        if d not in first_seen:
            assert a == 0.0 or k == TF.KIND_CODES["faulty"], (d, a, k)
            first_seen[d] = a


@pytest.mark.parametrize("proc", ALL_PROCESSES,
                         ids=[p.family for p in ALL_PROCESSES])
def test_sampler_well_formed_and_deterministic(proc):
    for seed in range(8):
        t = sample(proc, seed)
        assert t.max_events == proc.default_max_events(TOPO)
        assert t.epochs.device.type == "cpu"
        assert_well_formed(t, TOPO, SMALL_ROUNDS)
    a, b = sample(proc, 3), sample(proc, 3)
    _same_trace(a, b)


def test_markov_tiny_budget_never_dangles_a_recovery():
    proc = TP.MarkovChurnProcess(p_fail=0.5, p_recover=0.9)
    for seed in range(12):
        t = sample(proc, seed, max_events=3)
        assert_well_formed(t, TOPO, SMALL_ROUNDS)
        for d in range(TOPO.num_devices):
            states = [a for e, dd, a, k in _rows(t) if dd == d]
            assert states == [i % 2.0 for i in range(len(states))]


def test_straggler_pairs_are_all_or_nothing():
    t = sample(TP.StragglerProcess(p=1.0, window=3), 0, max_events=3)
    rows = _rows(t)
    assert len(rows) == 2                     # one whole pair, not 3 rows
    per_dev = {}
    for e, d, a, k in rows:
        per_dev.setdefault(d, []).append((e, a))
    for d, evs in per_dev.items():
        assert len(evs) == 2
        (e0, a0), (e1, a1) = evs
        assert (a0, a1) == (0.0, 1.0) and e1 == e0 + 3


def test_straggler_single_round_is_a_noop():
    t = sample(TP.StragglerProcess(p=1.0, window=5), 0, rounds=1)
    assert _rows(t) == []
    assert t.max_events == TP.StragglerProcess().default_max_events(TOPO)


def test_cascade_takes_members_and_staggers_recovery():
    proc = TP.ClusterCascadeProcess(p_head=1.0, q=1.0, recover_prob=1.0,
                                    recovery_lag=3, stagger=1)
    rows = _rows(sample(proc, 1, rounds=100))
    for c in range(TOPO.num_clusters):
        members = TOPO.clusters[c]
        head = members[0]
        he = [e for e, d, a, k in rows if d == head and a == 0.0]
        assert len(he) == 1 and head in TOPO.heads
        e = he[0]
        for i, d in enumerate(members[1:]):
            assert (min(e + 1, 99), d, 0.0, TF.KIND_CODES["client"]) in rows
            assert (e + 3 + (i + 1), d, 1.0, TF.KIND_CODES["client"]) in rows
        assert (e + 3, head, 1.0, TF.KIND_CODES["server"]) in rows


def test_iid_process_matches_sample_traces_bitwise():
    t = sample(TP.IidRateProcess(p=0.4, recover_prob=0.5), 7)
    ref = TF.sample_traces(np.random.default_rng(7), TOPO, 0.4,
                           max_events=2 * TOPO.num_devices,
                           rounds=SMALL_ROUNDS, num_traces=1,
                           recover_prob=0.5, device="cpu")[0]
    _same_trace(t, ref)


def test_pack_groups_prefix_and_pairs_modes():
    g1 = [(0, 1, 0.0, 1), (5, 1, 1.0, 1)]
    g2 = [(2, 2, 0.0, 1), (6, 2, 1.0, 1)]
    assert TP._pack_groups([g1, g2], 3) == g1 + g2[:1]
    assert TP._pack_groups([g1, g2], 3, pairs_only=True) == g1
    assert TP._pack_groups([g1, g2], 4) == g1 + g2


def test_process_seed_is_stable_and_distinct():
    p = TP.MarkovChurnProcess(p_fail=0.1, p_recover=0.2)
    s = TP.process_seed(0, p, 0)
    assert s == TP.process_seed(0, p, 0)          # sha256, not salted hash
    assert s != TP.process_seed(0, p, 1)
    assert s != TP.process_seed(1, p, 0)
    assert s != TP.process_seed(0, dataclasses.replace(p, p_fail=0.2), 0)


def test_family_process_covers_every_family():
    for fam in TP.FAMILIES:
        assert TP.family_process(fam, 0.3).family == fam
    with pytest.raises(ValueError):
        TP.family_process("nope", 0.3)
    with pytest.raises(AssertionError):
        TP.ProcessGrid(TP.IidRateProcess(), 0)


def test_concat_and_stack_reject_empty_lists():
    with pytest.raises(ValueError, match="empty"):
        TF.concat_traces([])
    with pytest.raises(ValueError, match="empty"):
        TF.stack_traces([])


def test_zero_event_trace_round_trips():
    t = TF.FailureTrace.none(4, device="cpu")
    assert _rows(t) == []
    alive = TF.trace_alive_mask(t, 6, 0)
    assert torch.equal(alive, torch.ones(6))
    batch = TF.stack_traces([t, t])
    back = TF.concat_traces([batch, batch])
    assert back.epochs.shape == (4, 4)
    assert torch.equal(TF.trace_faulty_scale(t, 6, 5), torch.ones(6))


def test_recovery_at_round_zero_round_trips():
    t = TP.trace_from_rows([(0, 2, 1.0, TF.KIND_CODES["client"])], 4,
                           device="cpu")
    for epoch in (0, 1, 7):
        alive = TF.trace_alive_mask(t, 6, epoch)
        assert alive.shape == (6,)
        assert torch.equal(alive, torch.ones(6))
    t2 = TP.trace_from_rows([(0, 2, 1.0, TF.KIND_CODES["client"]),
                             (3, 2, 0.0, TF.KIND_CODES["client"])], 4,
                            device="cpu")
    assert TF.trace_alive_mask(t2, 6, 3)[2] == 0.0


def test_sample_without_device_needs_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TP.ClusterCascadeProcess(p_head=1.0).sample(
            np.random.default_rng(0), TOPO, SMALL_ROUNDS)


# ---------------------------------------------------------------------------
# campaigns over process traces, against repro's
# ---------------------------------------------------------------------------
CAMPAIGN_ROUNDS = 5


def _process_traces(procs, seeds):
    """(port, repro) traces: one draw of each process for each seed, at
    the paper topology's default budget."""
    topo_j, topo_t = JTopo(10, 5), TTopo(10, 5)
    jl, tl = [], []
    for proc in procs:
        for s in seeds:
            seed = JP.process_seed(s, proc, 0)
            jl.append(proc.sample(np.random.default_rng(seed), topo_j,
                                  CAMPAIGN_ROUNDS, max_events=20))
            tl.append(port_process(proc).sample(
                np.random.default_rng(seed), topo_t, CAMPAIGN_ROUNDS,
                max_events=20, device="cpu"))
    return tl, jl


@pytest.mark.parametrize("kind", ["cascade", "straggler_faulty"])
def test_campaign_under_process_traces_matches_repro(kind, data):
    if kind == "cascade":
        procs = [JP.ClusterCascadeProcess(p_head=0.8, recover_prob=1.0,
                                          recovery_lag=2)]
        cls = TS.SimConfig
    else:
        procs = [JP.StragglerProcess(p=0.6, window=2),
                 JP.FaultyUpdateProcess(p=0.6, scale=-0.5, window=3)]
        cls = TS.FaultySimConfig
    tl, jl = _process_traces(procs, (0, 1))
    assert any(bool((t.devices >= 0).any()) for t in tl)
    cfg = cls(scheme="tolfl", num_devices=10, num_clusters=5,
              rounds=CAMPAIGN_ROUNDS, lr=1e-3, dropout=False)
    dx, counts, tx, ty = data
    want = JC.run_campaign(JCfg(**AE), dx, counts, tx, ty, _jcfg(cfg), jl,
                           seeds=[0])
    got = _run(data, cfg, tl, seeds=[0], params0=_jax_inits([0]))
    _close_to_repro(got, want)

