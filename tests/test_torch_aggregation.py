"""Port parity for the failure masks, the aggregation algebra and the
``tolfl_combine`` kernel module.

Masks are compared for EXACT equality.  The aggregation functions are
held to ``repro``'s within rtol 1e-6 (float32 sums in another order).
The combine cases of ``tests/test_kernels.py`` are ported against
``repro``'s Pallas kernel run in interpret mode; on the CPU the port's
wrapper runs the kernel's plain PyTorch version; the kernel itself is
tested on the card by ``test_torch_cuda.py``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis_compat import given, settings, st

from repro.core import aggregation as jagg
from repro.core import failure as jfail
from repro.core.processes import trace_from_rows
from repro.core.topology import Topology as JTopo
from repro.kernels import ref as jref
from repro.kernels.tolfl_combine import tolfl_combine as pallas_combine
from repro.kernels.tolfl_combine import tolfl_combine_tree as pallas_tree
from repro_torch.core import aggregation as tagg
from repro_torch.core import failure as tfail
from repro_torch.core.topology import Topology as TTopo
from repro_torch.kernels import ops
from repro_torch.kernels import ref as tref
from repro_torch.kernels import tolfl_combine as tc

# aggregation algebra: float32, sums in another order -> rtol 1e-6
AGG_RTOL, AGG_ATOL = 1e-6, 1e-6
# the combine recurrence: same operations in the same order as the
# Pallas kernel; XLA may fuse a multiply-add, so allow 1e-6 (a few ulps
# at the |g| ~ 1 of these inputs)
KERNEL_RTOL, KERNEL_ATOL = 1e-6, 1e-6


def _port_trace(jt):
    return tfail.FailureTrace(*(torch.from_numpy(np.array(getattr(jt, f)))
                                for f in ("epochs", "devices", "alive_after",
                                          "kinds")))


def _combine(gs, ns):
    return ops.tolfl_combine(torch.from_numpy(np.asarray(gs, np.float32)),
                             torch.from_numpy(np.asarray(ns, np.float32)),
                             device="cpu").numpy()


# ---------------------------------------------------------------------------
# failure masks: exact
# ---------------------------------------------------------------------------
@settings(max_examples=20, deadline=None)
@given(topo_idx=st.integers(0, 3), rate_pct=st.integers(10, 100),
       max_events=st.integers(1, 24), seed=st.integers(0, 2 ** 31 - 1))
def test_trace_alive_mask_and_weights_exact(topo_idx, rate_pct, max_events,
                                            seed):
    n, k = [(10, 5), (10, 1), (10, 10), (8, 2)][topo_idx]
    topo = JTopo(n, k)
    rng = np.random.default_rng(seed)
    cids, heads = topo.device_cluster_array(), np.array(topo.heads)
    for jt in jfail.sample_traces(rng, topo, rate_pct / 100.0,
                                  max_events=max_events, rounds=15,
                                  num_traces=2, recover_prob=0.7):
        tt = _port_trace(jt)
        for epoch in (0, 3, 7, 14, 20):
            want = np.asarray(jfail.trace_alive_mask(jt, n, jnp.int32(epoch)))
            got = tfail.trace_alive_mask(tt, n, epoch).numpy()
            np.testing.assert_array_equal(got, want)
            w_want = np.asarray(jfail.effective_weights_arrays(
                jnp.asarray(want), jnp.asarray(cids), jnp.asarray(heads)))
            w_got = tfail.effective_weights_arrays(
                torch.from_numpy(got), torch.from_numpy(cids).long(),
                torch.from_numpy(heads).long()).numpy()
            np.testing.assert_array_equal(w_got, w_want)


@pytest.mark.parametrize("order", ["fail_last", "recover_last"])
def test_same_epoch_tie_break_last_listed_wins(order):
    """The list-order contract of ``tests/test_failure_trace.py``: the
    reversed argmax over fired slots keeps the LAST same-epoch event."""
    fail = ("client", False)
    rec = ("client", True)
    evs = [rec, fail] if order == "fail_last" else [fail, rec]
    jt = jfail.FailureTrace.from_events(
        [jfail.FailureEvent(5, kd, device=3, recover=r) for kd, r in evs],
        JTopo(4, 2))
    tt = tfail.FailureTrace.from_events(
        [tfail.FailureEvent(5, kd, device=3, recover=r) for kd, r in evs],
        TTopo(4, 2), device="cpu")
    for f in ("epochs", "devices", "alive_after", "kinds"):
        np.testing.assert_array_equal(getattr(tt, f).numpy(),
                                      np.asarray(getattr(jt, f)))
    got = tfail.trace_alive_mask(tt, 4, 5).numpy()
    np.testing.assert_array_equal(
        got, np.asarray(jfail.trace_alive_mask(jt, 4, jnp.int32(5))))
    assert got[3] == (0.0 if order == "fail_last" else 1.0)


@pytest.mark.parametrize("spec", [("server", 3), ("client", 2), ("none", 0)])
@pytest.mark.parametrize("nk", [(10, 5), (10, 1), (10, 10), (1, 1)])
def test_from_spec_and_alive_mask_exact(spec, nk):
    kind, epoch = spec
    jtopo, ttopo = JTopo(*nk), TTopo(*nk)
    js = (jfail.NO_FAILURE if kind == "none"
          else jfail.FailureSpec(epoch, kind))
    ts = (tfail.NO_FAILURE if kind == "none"
          else tfail.FailureSpec(epoch, kind))
    jt, tt = jfail.as_trace(js, jtopo), tfail.as_trace(ts, ttopo,
                                                       device="cpu")
    for f in ("epochs", "devices", "alive_after", "kinds"):
        np.testing.assert_array_equal(getattr(tt, f).numpy(),
                                      np.asarray(getattr(jt, f)))
    for e in (0, epoch, epoch + 4):
        np.testing.assert_array_equal(
            tfail.alive_mask(ts, ttopo, e, device="cpu").numpy(),
            np.asarray(jfail.alive_mask(js, jtopo, jnp.int32(e))))


def test_trace_faulty_scale_exact_with_kind3_rows():
    """Hand-built faulty (kind-3) rows on the shadow device range: the
    scale channel matches exactly and the alive mask stays inert."""
    n = 4
    faulty = jfail.KIND_CODES["faulty"]
    assert tfail.KIND_CODES == jfail.KIND_CODES
    rows = [(2, n + 1, -1.0, faulty), (5, n + 1, 1.0, faulty),
            (3, n + 3, 0.0, faulty), (3, n + 3, 0.5, faulty),
            (4, 2, 0.0, jfail.KIND_CODES["client"])]
    jt = trace_from_rows(rows, 8)
    tt = _port_trace(jt)
    for epoch in range(8):
        np.testing.assert_array_equal(
            tfail.trace_faulty_scale(tt, n, epoch).numpy(),
            np.asarray(jfail.trace_faulty_scale(jt, n, jnp.int32(epoch))))
        np.testing.assert_array_equal(
            tfail.trace_alive_mask(tt, n, epoch).numpy(),
            np.asarray(jfail.trace_alive_mask(jt, n, jnp.int32(epoch))))
    assert tfail.trace_faulty_scale(tt, n, 3).numpy()[3] == 0.5


def test_trace_constants_equal():
    assert tfail.PAD_EPOCH == jfail.PAD_EPOCH
    assert tfail.MAX_EVENTS == jfail.MAX_EVENTS


# ---------------------------------------------------------------------------
# aggregation algebra vs repro
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("n_a,n_b", [(0.0, 0.0), (0.0, 3.0), (2.0, 0.0),
                                     (2.5, 7.0)])
def test_combine_pair_matches(n_a, n_b):
    rng = np.random.default_rng(1)
    ga, gb = (rng.standard_normal(40).astype(np.float32) for _ in range(2))
    jn, jg = jagg.combine_pair(jnp.float32(n_a), jnp.asarray(ga),
                               jnp.float32(n_b), jnp.asarray(gb))
    tn, tg = tagg.combine_pair(torch.tensor(n_a), torch.from_numpy(ga),
                               torch.tensor(n_b), torch.from_numpy(gb))
    assert float(tn) == float(jn)
    np.testing.assert_allclose(tg.numpy(), np.asarray(jg), rtol=AGG_RTOL,
                               atol=AGG_ATOL)


@pytest.mark.parametrize("k,zeros", [(1, []), (5, []), (5, [3, 4]),
                                     (10, [0, 9]), (20, [])])
def test_stacked_and_weighted_mean_match(k, zeros):
    rng = np.random.default_rng(k)
    gs = rng.standard_normal((k, 6, 7)).astype(np.float32)
    ns = rng.uniform(0.5, 30.0, k).astype(np.float32)
    ns[zeros] = 0.0
    jn, jg = jagg.stacked_streaming_mean(jnp.asarray(gs), jnp.asarray(ns))
    tn, tg = tagg.stacked_streaming_mean(torch.from_numpy(gs),
                                         torch.from_numpy(ns))
    np.testing.assert_allclose(float(tn), float(jn), rtol=AGG_RTOL)
    np.testing.assert_allclose(tg.numpy(), np.asarray(jg), rtol=AGG_RTOL,
                               atol=AGG_ATOL)
    np.testing.assert_allclose(
        tagg.weighted_mean(torch.from_numpy(gs), torch.from_numpy(ns)).numpy(),
        np.asarray(jagg.weighted_mean(jnp.asarray(gs), jnp.asarray(ns))),
        rtol=AGG_RTOL, atol=AGG_ATOL)
    # the k-invariance: streaming == direct weighted mean
    np.testing.assert_allclose(
        tg.numpy(), tagg.weighted_mean(torch.from_numpy(gs),
                                       torch.from_numpy(ns)).numpy(),
        rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("n,k,dead", [(10, 5, []), (10, 5, [0, 4]),
                                      (10, 1, [0]), (10, 10, [2])])
def test_cluster_reduce_matches(n, k, dead):
    rng = np.random.default_rng(n + k)
    gs = rng.standard_normal((n, 3, 5)).astype(np.float32)
    counts = np.array([75] * 6 + [0] * 4, np.float32)[:n]   # paper split
    counts[dead] = 0.0
    cids = JTopo(n, k).device_cluster_array()
    jg, jn = jagg.cluster_reduce(jnp.asarray(gs), jnp.asarray(counts),
                                 jnp.asarray(cids), k)
    tg, tn = tagg.cluster_reduce(torch.from_numpy(gs),
                                 torch.from_numpy(counts),
                                 torch.from_numpy(cids), k)
    np.testing.assert_array_equal(tn.numpy(), np.asarray(jn))
    np.testing.assert_allclose(tg.numpy(), np.asarray(jg), rtol=AGG_RTOL,
                               atol=AGG_ATOL)


# ---------------------------------------------------------------------------
# the tolfl_combine kernel module vs repro's Pallas kernel (interpret mode)
# ---------------------------------------------------------------------------
@settings(max_examples=25, deadline=None)
@given(k=st.integers(1, 8), p=st.integers(1, 300),
       seed=st.integers(0, 2 ** 31 - 1))
def test_tolfl_combine_matches_pallas(k, p, seed):
    rng = np.random.default_rng(seed)
    gs = rng.standard_normal((k, p)).astype(np.float32)
    ns = rng.uniform(0.1, 50.0, k).astype(np.float32)
    want = np.asarray(pallas_combine(jnp.asarray(gs), jnp.asarray(ns),
                                     block=64, interpret=True))
    got = _combine(gs, ns)
    np.testing.assert_allclose(got, want, rtol=KERNEL_RTOL,
                               atol=KERNEL_ATOL)
    np.testing.assert_array_equal(
        got, tref.tolfl_combine_reference(torch.from_numpy(gs),
                                          torch.from_numpy(ns)).numpy())


def test_tolfl_combine_equals_direct_weighted_mean():
    rng = np.random.default_rng(0)
    gs = rng.standard_normal((5, 1000)).astype(np.float32)
    ns = rng.uniform(1, 10, 5).astype(np.float32)
    got = _combine(gs, ns)
    np.testing.assert_allclose(
        got, np.asarray(pallas_combine(jnp.asarray(gs), jnp.asarray(ns),
                                       interpret=True)),
        rtol=KERNEL_RTOL, atol=KERNEL_ATOL)
    np.testing.assert_allclose(got, (ns / ns.sum()) @ gs, rtol=2e-5,
                               atol=2e-5)


@pytest.mark.parametrize("k,p,block", [
    (3, 97, 64),       # ragged P: Pallas pads to the block, the port masks
    (1, 5, 4096),      # k == 1: the mean is the single gradient
    (1, 257, 64),
    (4, 130, 32),
    (3, 64, 16),
    (8, 97, 128),      # block > P
    (5, 4099, 4096),   # P just past one default block
])
def test_tolfl_combine_edge_shapes_and_padding(k, p, block):
    rng = np.random.default_rng(k * 1000 + p)
    gs = rng.standard_normal((k, p)).astype(np.float32)
    ns = rng.uniform(0.1, 50.0, k).astype(np.float32)
    got = _combine(gs, ns)
    assert got.shape == (p,)
    want = np.asarray(pallas_combine(jnp.asarray(gs), jnp.asarray(ns),
                                     block=block, interpret=True))
    np.testing.assert_allclose(got, want, rtol=KERNEL_RTOL,
                               atol=KERNEL_ATOL)
    np.testing.assert_allclose(
        got, np.asarray(jref.tolfl_combine_reference(jnp.asarray(gs),
                                                     jnp.asarray(ns))),
        rtol=KERNEL_RTOL, atol=KERNEL_ATOL)
    if k == 1:
        np.testing.assert_array_equal(got, gs[0])


def test_tolfl_combine_all_zero_counts():
    """Every cluster dead: an exact zero update, not NaN."""
    rng = np.random.default_rng(3)
    gs = rng.standard_normal((4, 50)).astype(np.float32)
    ns = np.zeros(4, np.float32)
    got = _combine(gs, ns)
    np.testing.assert_array_equal(got, np.zeros(50, np.float32))
    np.testing.assert_array_equal(
        got, np.asarray(pallas_combine(jnp.asarray(gs), jnp.asarray(ns),
                                       block=16, interpret=True)))


def test_tolfl_combine_partial_zero_counts():
    """Dead clusters are absorbed as no-ops; survivors renormalise (the
    paper split's clusters 3 and 4 reach the combine with n_c = 0)."""
    rng = np.random.default_rng(4)
    gs = rng.standard_normal((5, 33)).astype(np.float32)
    ns = np.array([0.0, 2.0, 0.0, 3.0, 0.0], np.float32)
    got = _combine(gs, ns)
    np.testing.assert_allclose(
        got, np.asarray(pallas_combine(jnp.asarray(gs), jnp.asarray(ns),
                                       block=8, interpret=True)),
        rtol=KERNEL_RTOL, atol=KERNEL_ATOL)
    want = (ns[1] * gs[1] + ns[3] * gs[3]) / (ns[1] + ns[3])
    np.testing.assert_allclose(got, want, rtol=2e-5, atol=2e-5)


def test_tolfl_combine_tree():
    rng = np.random.default_rng(2)
    tree = {"w": rng.standard_normal((4, 8, 8)).astype(np.float32),
            "b": rng.standard_normal((4, 8)).astype(np.float32)}
    ns = np.array([1.0, 2.0, 3.0, 4.0], np.float32)
    want = pallas_tree(jax.tree.map(jnp.asarray, tree), jnp.asarray(ns),
                       interpret=True)
    got = tc.tolfl_combine_tree({key: torch.from_numpy(v)
                                 for key, v in tree.items()},
                                torch.from_numpy(ns), device="cpu")
    for key in ("w", "b"):
        assert tuple(got[key].shape) == tree[key].shape[1:]
        np.testing.assert_allclose(got[key].numpy(), np.asarray(want[key]),
                                   rtol=KERNEL_RTOL, atol=KERNEL_ATOL)


def test_tolfl_combine_rejects_bad_inputs():
    gs = torch.zeros((3, 10))
    for bad_gs, bad_ns, err in [
            (torch.zeros(10), torch.ones(3), ValueError),
            (gs, torch.ones(4), ValueError),
            (gs.double(), torch.ones(3, dtype=torch.float64), TypeError),
            (torch.zeros((0, 10)), torch.ones(0), ValueError)]:
        with pytest.raises(err):
            tc.tolfl_combine(bad_gs, bad_ns, device="cpu")
    with pytest.raises(ValueError, match="CUDA"):
        tc.tolfl_combine_cuda(gs, torch.ones(3))


def test_ops_tolfl_combine_needs_a_device():
    """``device=None`` means CUDA: on a machine without a card the call
    raises rather than run quietly on the CPU; a tensor on another
    device than the one asked for raises too."""
    gs, ns = torch.zeros((2, 4)), torch.ones(2)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            ops.tolfl_combine(gs, ns)
    with pytest.raises(ValueError, match="expected cpu"):
        ops.tolfl_combine(gs.to("meta"), ns, device="cpu")
    before = tc.LAUNCHES
    ops.tolfl_combine(gs, ns, device="cpu")
    assert tc.LAUNCHES == before        # the plain version launches nothing
