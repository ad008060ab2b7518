"""Port parity for the rest of the failure model: the Monte-Carlo trace
samplers, trace stacking, and the masks on a stacked (S, M) trace.

The samplers and the stacking are host code, so their traces must be
BYTE-identical to ``repro``'s: both packages' ``np.random.Generator``s
start from the same seed and must be drawn in the same order.  The masks
on a stack must equal ``repro``'s per-trace masks exactly, at every
epoch.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis_compat import given, settings, st

from repro.core import failure as jfail
from repro.core.processes import trace_from_rows
from repro.core.topology import Topology as JTopo
from repro_torch.core import failure as tfail
from repro_torch.core.topology import Topology as TTopo

FIELDS = ("epochs", "devices", "alive_after", "kinds")
TOPOS = [(10, 5), (10, 1), (10, 10), (8, 2), (12, 3)]


def _same_trace(t, j):
    """Port trace == repro trace, field for field, byte for byte."""
    for f in FIELDS:
        a, b = getattr(t, f).numpy(), np.asarray(getattr(j, f))
        assert a.dtype == b.dtype and a.shape == b.shape, (f, a.dtype,
                                                           b.dtype)
        assert a.tobytes() == b.tobytes(), f


def _port_trace(jt):
    return tfail.FailureTrace(*(torch.from_numpy(np.array(getattr(jt, f)))
                                for f in FIELDS))


@settings(max_examples=25, deadline=None)
@given(seed=st.integers(0, 2 ** 31 - 1), topo_idx=st.integers(0, 4),
       rate=st.sampled_from([0.0, 0.05, 0.3, 0.7, 1.0]),
       max_events=st.integers(1, 24), rounds=st.sampled_from([1, 2, 15, 100]),
       recover_prob=st.sampled_from([0.0, 0.5, 0.9, 1.0]),
       num_traces=st.integers(1, 4))
def test_sample_traces_byte_identical(seed, topo_idx, rate, max_events,
                                      rounds, recover_prob, num_traces):
    """Same seed, same draws in the same order: the same traces, byte for
    byte, including the truncation near the slot budget; and both
    generators end in the same state."""
    n, k = TOPOS[topo_idx]
    jr, tr = np.random.default_rng(seed), np.random.default_rng(seed)
    want = jfail.sample_traces(jr, JTopo(n, k), rate, max_events, rounds,
                               num_traces, recover_prob)
    got = tfail.sample_traces(tr, TTopo(n, k), rate, max_events, rounds,
                              num_traces, recover_prob, device="cpu")
    assert len(got) == len(want) == num_traces
    for t, j in zip(got, want):
        _same_trace(t, j)
    assert jr.random() == tr.random()


def test_sample_traces_truncation_keeps_failures():
    """Near the budget a failure whose recovery does not fit keeps the
    failure: every slot is used at rate 1 with recoveries on."""
    topo = TTopo(10, 5)
    for t in tfail.sample_traces(np.random.default_rng(3), topo, 1.0,
                                 max_events=7, rounds=50, num_traces=6,
                                 recover_prob=1.0, device="cpu"):
        assert int((t.devices >= 0).sum()) == 7
        assert t.alive_after[(t.devices >= 0)].min() == 0.0


@settings(max_examples=15, deadline=None)
@given(seed=st.integers(0, 2 ** 31 - 1), topo_idx=st.integers(0, 4),
       traces_per_p=st.integers(1, 6), with_base=st.booleans(),
       max_events=st.sampled_from([None, 4, 30]))
def test_sample_rate_grid_byte_identical(seed, topo_idx, traces_per_p,
                                         with_base, max_events):
    """Dedup, ``draws`` and ``base_traces`` as ``repro``'s: the same
    trace pool in the same order, the same index per draw."""
    n, k = TOPOS[topo_idx]
    p_grid = [0.0, 0.1, 0.5, 1.0]
    m = 2 * n if max_events is None else max_events
    jbase, tbase = [], []
    if with_base:
        jbase = [jfail.FailureTrace.none(m),
                 jfail.FailureTrace.from_events(
                     [jfail.FailureEvent(2, "server")], JTopo(n, k), m)]
        tbase = [_port_trace(t) for t in jbase]
    jr, tr = np.random.default_rng(seed), np.random.default_rng(seed)
    jt, jd = jfail.sample_rate_grid(jr, JTopo(n, k), p_grid, 20,
                                    traces_per_p, max_events,
                                    base_traces=jbase)
    tt, td = tfail.sample_rate_grid(tr, TTopo(n, k), p_grid, 20,
                                    traces_per_p, max_events,
                                    base_traces=tbase, device="cpu")
    assert td == jd
    assert len(tt) == len(jt)
    for t, j in zip(tt, jt):
        _same_trace(t, j)
    # the all-none draws at p = 0 collapse onto one trace
    assert len(set(td[0.0])) == 1
    if with_base:
        assert td[0.0][0] == 0       # aliasing the no-failure base trace


def _grid(seed, n, k, m=10, count=5):
    rng = np.random.default_rng(seed)
    return jfail.sample_traces(rng, JTopo(n, k), 0.6, m, 12, count, 0.7)


def test_stack_and_concat_byte_identical():
    js = _grid(1, 10, 5)
    ts = [_port_trace(t) for t in js]
    _same_trace(tfail.stack_traces(ts), jfail.stack_traces(js))
    a = [tfail.stack_traces(ts[:2]), tfail.stack_traces(ts[2:])]
    b = [jfail.stack_traces(js[:2]), jfail.stack_traces(js[2:])]
    _same_trace(tfail.concat_traces(a), jfail.concat_traces(b))
    one = tfail.stack_traces(ts[:3])
    assert tfail.concat_traces([one]) is one


def test_empty_and_mixed_lists_raise_as_repro():
    for fn, jfn in ((tfail.stack_traces, jfail.stack_traces),
                    (tfail.concat_traces, jfail.concat_traces)):
        with pytest.raises(ValueError) as want:
            jfn([])
        with pytest.raises(ValueError) as got:
            fn([])
        assert str(got.value) == str(want.value)
    mixed = [tfail.FailureTrace.none(8, "cpu"), tfail.FailureTrace.none(4,
                                                                      "cpu")]
    with pytest.raises(AssertionError, match="mixed max_events"):
        tfail.stack_traces(mixed)
    with pytest.raises(AssertionError, match="mixed max_events"):
        tfail.concat_traces([tfail.stack_traces(mixed[:1]),
                             tfail.stack_traces(mixed[1:])])


@pytest.mark.parametrize("n,k,m", [(10, 5, 10), (10, 1, 4), (10, 10, 20),
                                   (8, 2, 1)])
def test_stacked_masks_equal_per_trace_repro(n, k, m):
    """On an (S, M) stack the alive mask, the faulty scale and the
    effective weights (per-scenario padded cluster arrays, gathered)
    equal ``repro``'s per-trace results at every epoch, exactly; the
    (M,) case gives the same rows."""
    js = _grid(n * 7 + k, n, k, m, count=4)
    # a faulty-channel trace and the empty trace join the stack
    js.append(trace_from_rows([(2, n + 1, 0.5, 3), (5, 3, 0.0, 1),
                               (7, n + 4, -1.0, 3)], m if m >= 3 else 3))
    js = [j for j in js if j.max_events == m] + [jfail.FailureTrace.none(m)]
    stack = tfail.stack_traces([_port_trace(j) for j in js])
    topo = JTopo(n, k)
    k_pad = k + 3                                  # padded head slots
    cids = torch.from_numpy(topo.device_cluster_array()).long()
    heads = torch.zeros(k_pad, dtype=torch.long)
    heads[:k] = torch.tensor(topo.heads)
    S = len(js)
    for epoch in range(14):
        alive = tfail.trace_alive_mask(stack, n, epoch)
        scale = tfail.trace_faulty_scale(stack, n, epoch)
        w = tfail.effective_weights_arrays(alive, cids.expand(S, n),
                                           heads.expand(S, k_pad))
        assert alive.shape == scale.shape == w.shape == (S, n)
        for s, j in enumerate(js):
            e = jnp.int32(epoch)
            want_alive = np.asarray(jfail.trace_alive_mask(j, n, e))
            np.testing.assert_array_equal(alive[s].numpy(), want_alive)
            np.testing.assert_array_equal(
                scale[s].numpy(), np.asarray(jfail.trace_faulty_scale(j, n,
                                                                      e)))
            np.testing.assert_array_equal(
                w[s].numpy(), np.asarray(jfail.effective_weights(
                    jnp.asarray(want_alive), topo)))
            single = _port_trace(j)
            np.testing.assert_array_equal(
                tfail.trace_alive_mask(single, n, epoch).numpy(), want_alive)


def test_samplers_default_to_cuda():
    """``device=None`` means CUDA: without a card the samplers raise."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tfail.sample_traces(np.random.default_rng(0), TTopo(10, 5), 0.5)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tfail.sample_rate_grid(np.random.default_rng(0), TTopo(10, 5),
                               [0.5], 10, 2)
