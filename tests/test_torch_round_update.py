"""The fused round aggregation (``tolfl_round_update``) against ``repro``.

On the CPU the wrapper runs the kernel's plain PyTorch version; the CUDA
kernel itself is held to that plain version bit for bit on the card by
``test_torch_cuda.py``.  Here the plain version is held to ``repro``'s
round: ``cluster_reduce`` -> ``stacked_streaming_mean`` (and the Pallas
``tolfl_combine`` in interpret mode) -> ``p - lr * has_update * g``,
within rtol 1e-4 / atol 1e-6: the port sums each cluster in device order
with fused multiply-adds where ``repro`` forms a one-hot product, so the
last bits differ.
"""
from fractions import Fraction

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import aggregation as jagg
from repro.core.topology import Topology as JTopo
from repro.kernels.tolfl_combine import tolfl_combine as pallas_combine
from repro_torch.configs.autoencoder_paper import AutoencoderConfig as TCfg
from repro_torch.core import aggregation as tagg
from repro_torch.core import simulate as TS
from repro_torch.kernels import ops
from repro_torch.kernels import tolfl_combine as tc

RTOL, ATOL = 1e-4, 1e-6
PAPER_COUNTS = [1125.0] * 6 + [0.0] * 4

# (N, k, P, counts, dead devices, cluster ids or None for the paper's
# contiguous clusters, faulty scale)
CASES = {
    "paper": (10, 5, 1000, PAPER_COUNTS, [], None, False),
    "dead_head": (10, 5, 1000, PAPER_COUNTS, [2, 3], None, False),
    "all_zero": (10, 5, 1000, [0.0] * 10, [], None, False),
    "k1": (10, 1, 1000, PAPER_COUNTS, [], None, False),
    "kN": (10, 10, 1000, PAPER_COUNTS, [4], None, False),
    "padded_k": (10, 8, 1000, PAPER_COUNTS, [], "padded", False),
    "sparse_ids": (10, 10, 1000, PAPER_COUNTS, [], "sparse", False),
    "faulty": (10, 5, 1000, PAPER_COUNTS, [], None, True),
    "ragged_p": (10, 5, 1001, PAPER_COUNTS, [], None, False),
    "ragged_p_small": (7, 3, 6, [3.0, 5.0, 0.0, 2.0, 7.0, 1.0, 4.0], [],
                       "shuffled", True),
    "many_devices": (20, 4, 257, list(np.arange(1.0, 21.0)), [5], "shuffled",
                     True),
}


def _inputs(name, S=1, seed=0):
    N, k, P, counts, dead, ids, faulty = CASES[name]
    rng = np.random.default_rng(seed)
    gs = rng.standard_normal((S, N, P)).astype(np.float32)
    w = np.ones((S, N), np.float32)
    w[:, dead] = 0.0
    if ids is None:
        cids = np.tile(JTopo(N, k).device_cluster_array(), (S, 1))
    elif ids == "padded":          # a campaign's pad-k: ids < 5 of k = 8
        cids = np.tile(JTopo(N, 5).device_cluster_array(), (S, 1))
    elif ids == "sparse":          # an empty cluster between each two
        cids = np.tile(np.arange(N) // 2 * 2, (S, 1))
    else:
        cids = rng.integers(0, k, (S, N))
    scale = None
    if faulty:
        scale = rng.uniform(-1.5, 1.5, (S, N)).astype(np.float32)
        scale[:, ::3] = 0.0        # zeros and negatives
    params = rng.standard_normal((S, P)).astype(np.float32)
    return (gs, np.asarray(counts, np.float32), w, scale,
            cids.astype(np.int32), params, k)


def _port(gs, counts, w, scale, cids, params, lr, k):
    t = torch.from_numpy
    new, n_tot = ops.tolfl_round_update(
        t(gs), t(counts), t(w), None if scale is None else t(scale), t(cids),
        t(params), lr, k, device="cpu")
    return new.numpy(), n_tot.numpy()


def _repro(gs, counts, w, scale, cids, params, lr, k, pallas=False):
    """``repro``'s round, scenario by scenario (simulate.py:225-233)."""
    news, tots = [], []
    for s in range(gs.shape[0]):
        g_tx = jnp.asarray(gs[s])
        if scale is not None:
            g_tx = g_tx * jnp.asarray(scale[s])[:, None]
        ns = jnp.asarray(counts) * jnp.asarray(w[s])
        cg, n_c = jagg.cluster_reduce(g_tx, ns, jnp.asarray(cids[s]), k)
        if pallas:
            g = pallas_combine(cg, n_c, block=128, interpret=True)
            n_tot = jnp.sum(n_c)
        else:
            n_tot, g = jagg.stacked_streaming_mean(cg, n_c)
        has_update = (n_tot > 0).astype(jnp.float32)
        news.append(np.asarray(params[s] - lr * has_update * g))
        tots.append(float(n_tot))
    return np.stack(news), np.asarray(tots, np.float32)


@pytest.mark.parametrize("pallas", [False, True], ids=["jnp", "pallas"])
@pytest.mark.parametrize("name", list(CASES))
def test_plain_matches_repro_round(name, pallas):
    args = _inputs(name)
    gs, counts, w, scale, cids, params, k = args
    before = tc.ROUND_LAUNCHES, tc.LAUNCHES
    new, n_tot = _port(gs, counts, w, scale, cids, params, 0.1, k)
    assert (tc.ROUND_LAUNCHES, tc.LAUNCHES) == before   # nothing launched
    want, want_tot = _repro(gs, counts, w, scale, cids, params, 0.1, k,
                            pallas)
    np.testing.assert_allclose(new, want, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(n_tot, want_tot, rtol=RTOL)
    # the combined gradient itself: zero params and lr -1 return it exactly
    g, _ = _port(gs, counts, w, scale, cids, np.zeros_like(params), -1.0, k)
    g_want, _ = _repro(gs, counts, w, scale, cids, np.zeros_like(params),
                       -1.0, k, pallas)
    np.testing.assert_allclose(g, g_want, rtol=RTOL, atol=ATOL)


def test_all_zero_counts_leave_params_bitwise():
    gs, counts, w, scale, cids, params, k = _inputs("all_zero")
    new, n_tot = _port(gs, counts, w, scale, cids, params, 1e-3, k)
    np.testing.assert_array_equal(new, params)
    np.testing.assert_array_equal(n_tot, np.zeros(1, np.float32))


def test_empty_clusters_are_exact_no_ops():
    """Padded cluster slots (ids < 5 of k = 8) change nothing, bit for bit."""
    gs, counts, w, scale, cids, params, _ = _inputs("padded_k")
    eight = _port(gs, counts, w, scale, cids, params, 0.1, 8)
    five = _port(gs, counts, w, scale, cids, params, 0.1, 5)
    for a, b in zip(eight, five):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("name", ["paper", "faulty", "many_devices"])
def test_scenarios_equal_separate_calls(name):
    """The scenario axis: S = 6 in one call equals six S = 1 calls."""
    gs, counts, w, scale, cids, params, k = _inputs(name, S=6, seed=3)
    w[2] = 0.0                                  # one scenario all dead
    new, n_tot = _port(gs, counts, w, scale, cids, params, 0.05, k)
    for s in range(6):
        one = _port(gs[s:s + 1], counts, w[s:s + 1],
                    None if scale is None else scale[s:s + 1],
                    cids[s:s + 1], params[s:s + 1], 0.05, k)
        np.testing.assert_array_equal(new[s:s + 1], one[0])
        np.testing.assert_array_equal(n_tot[s:s + 1], one[1])
    np.testing.assert_array_equal(new[2], params[2])


def test_round_update_via_aggregation_module():
    gs, counts, w, scale, cids, params, k = _inputs("faulty")
    t = torch.from_numpy
    got = tagg.round_update(t(gs), t(counts), t(w), t(scale), t(cids),
                            t(params), 0.1, k)
    want = _port(gs, counts, w, scale, cids, params, 0.1, k)
    np.testing.assert_array_equal(got[0].numpy(), want[0])


def _round_to_f32(x: Fraction) -> np.float32:
    """The float32 nearest the rational x, ties to even."""
    f = np.float32(float(x))
    cands = [f, np.nextafter(f, np.float32(np.inf)),
             np.nextafter(f, np.float32(-np.inf))]
    return min(cands, key=lambda v: (abs(Fraction(float(v)) - x),
                                     int(np.array(v).view(np.int32)) & 1))


def test_fma_rounds_once():
    """The plain version's fused multiply-add rounds a * b + c once, as
    the card's fmaf does: random values and exact float32 ties."""
    rng = np.random.default_rng(0)
    n = 600
    a = rng.standard_normal(n).astype(np.float32)
    b = (rng.standard_normal(n) * 1000).astype(np.float32)
    c = (rng.standard_normal(n) * 1000).astype(np.float32)
    steps = np.float32(2.0 ** -23) * rng.integers(0, 8, (2, 200))
    a[:200], b[:200], c[:200] = 1 + steps[0], 1 + steps[1], -1.0
    c[200:300] = -(a[200:300].astype(np.float64) * b[200:300])
    got = tc.fma(*(torch.from_numpy(x) for x in (a, b, c))).numpy()
    want = np.array([_round_to_f32(Fraction(float(x)) * Fraction(float(y))
                                   + Fraction(float(z)))
                     for x, y, z in zip(a, b, c)], np.float32)
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))


def test_round_update_rejects_bad_inputs():
    gs, counts, w, scale, cids, params, k = (
        torch.from_numpy(x) if isinstance(x, np.ndarray) else x
        for x in _inputs("faulty"))
    good = dict(gs=gs, counts=counts, w=w, scale=scale, cluster_ids=cids,
                params=params)
    bad = [("gs", gs[0], ValueError), ("counts", counts[:3], ValueError),
           ("w", w.double(), TypeError), ("scale", scale[:, :4], ValueError),
           ("cluster_ids", cids.long(), TypeError),
           ("params", params[:, :7], ValueError),
           ("gs", gs.double(), TypeError)]
    for name, value, err in bad:
        kw = dict(good, **{name: value})
        with pytest.raises(err):
            tc.tolfl_round_update(*kw.values(), 0.1, k, device="cpu")
    with pytest.raises(ValueError):
        tc.tolfl_round_update(*good.values(), 0.1, 0, device="cpu")
    with pytest.raises(ValueError, match="expected cpu"):
        tc.tolfl_round_update(*dict(good, w=w.to("meta")).values(), 0.1, k,
                              device="cpu")
    with pytest.raises(ValueError, match="CUDA"):
        tc.tolfl_round_update_cuda(*good.values(), 0.1, k)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            ops.tolfl_round_update(*good.values(), 0.1, k)


def test_scenario_checks_topology_arrays(monkeypatch, tiny_padded,
                                         tiny_split):
    """The kernel takes cluster ids unchecked, so the simulator checks the
    topology's arrays on the host before the round loop."""
    dx, counts = tiny_padded
    monkeypatch.setattr(TS.Topology, "device_cluster_array",
                        lambda self: np.arange(self.num_devices))
    cfg = TS.SimConfig(num_devices=10, num_clusters=5, rounds=1,
                       dropout=False)
    with pytest.raises(ValueError, match="topology"):
        TS.run_simulation(TCfg(input_dim=112, hidden=(8,), code_dim=4),
                          dx, counts, tiny_split.test_x, tiny_split.test_y,
                          cfg, device="cpu")
