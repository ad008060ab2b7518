"""``SeqDetector`` (the RG-LRU sequence body) against ``repro``'s.

The port's ``SeqDetector`` runs its recurrence through the scan kernel's
entry point (the plain loop on the CPU, with the plain backward); ``repro``
runs it through ``jax.lax.associative_scan``.  With ``repro``'s params
carried over through the weight bridge and dropout off:

* ``loss``, ``anomaly_scores`` and the parameter gradients agree within
  rtol 1e-5 (atol 1e-6 of the largest value: float32 sums in other
  orders, the scan's tree against a loop);
* with leading axes on the params — (S, N) a device in the round loop,
  (S, M, 1) in IFCA's probe of every model on every device, (S,) for the
  test scores — each index equals the unbatched call within the same
  tolerance;
* ``run_simulation`` (tolfl k = 2 and fl under a server failure, 3
  rounds) gives loss curves within rtol 1e-4 of ``repro``'s and AUROCs
  within 1e-3, the simulator tests' tolerances;
* at the paper's lr 1e-3 both turn non-finite in the same round.

Also: the spec's fields, defaults and order, ``param_count``, the flat
layout's leaf order, the registry round trip, ``DataSpec.ae_cfg`` for a
sequence body, and dropout (inline draws equal to ``dropout_masks``).
"""
import dataclasses
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import failure as JF
from repro.core import simulate as JS
from repro.core.experiment import DataSpec as JDataSpec
from repro.models import detector as JD
from repro_torch.core import experiment as TX
from repro_torch.core import failure as TF
from repro_torch.core import simulate as TS
from repro_torch.models import detector as TD
from repro_torch.models.params import FlatLayout, from_numpy_tree
from torch_threads import one_torch_thread  # noqa: F401

RTOL = 1e-5
SIM_RTOL, SIM_ATOL, AUROC_ATOL = 1e-4, 1e-5, 1e-3
SMALL = dict(input_dim=112, window=16, d_model=8)


def _pair(**kw):
    return JD.SeqDetector(**kw), TD.SeqDetector(**kw)


def _jparams(det, seed):
    return det.init_params(jax.random.PRNGKey(seed))


def _bridge(jp):
    return from_numpy_tree(jax.tree.map(np.asarray, jp), device="cpu")


def _close(got, want, what=""):
    got, want = np.asarray(got), np.asarray(want)
    np.testing.assert_allclose(got, want, rtol=RTOL,
                               atol=1e-6 * float(np.max(np.abs(want))),
                               err_msg=what)


def _rows(n, seed):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, 112)).astype(np.float32) * 3.0
    valid = (rng.random(n) < 0.8).astype(np.float32)
    return x, valid


def test_fields_defaults_and_order_match_repro():
    def spec(cls):
        return [(f.name, f.default) for f in dataclasses.fields(cls)]
    assert spec(TD.SeqDetector) == spec(JD.SeqDetector)
    j, t = _pair()
    assert dataclasses.asdict(t) == dataclasses.asdict(j)
    assert (t.seq_len, t.budget_family) == (j.seq_len, j.budget_family) \
        == (7, "seq")
    assert TD.AutoencoderDetector.budget_family == "ae"


@pytest.mark.parametrize("kw", [{}, SMALL, dict(input_dim=20, window=8,
                                                 d_model=4, lru_width=6,
                                                 conv1d_width=3)])
def test_param_count_and_flat_order_match_repro(kw):
    j, t = _pair(**kw)
    assert t.param_count() == j.param_count()
    assert t.param_bytes() == j.param_bytes()
    jp = _jparams(j, 0)
    layout = FlatLayout.of(_bridge(jp))
    paths = [tuple(k.key for k in path)
             for path, _ in jax.tree_util.tree_leaves_with_path(jp)]
    assert [p for p, _, _ in layout.entries] == paths
    # the flat vector means the same in both packages
    flat = np.concatenate([np.asarray(x).ravel() for x in jax.tree.leaves(jp)])
    np.testing.assert_array_equal(layout.flatten(_bridge(jp)).numpy(), flat)
    # the port's own init has repro's tree
    tp = t.init_params(torch.Generator().manual_seed(0), device="cpu")
    assert [(p, s) for p, s, _ in FlatLayout.of(tp).entries] == \
        [(p, s) for p, s, _ in layout.entries]


@pytest.mark.parametrize("kw", [{}, SMALL])
def test_loss_scores_and_grads_match_repro(kw):
    j, t = _pair(**kw)
    jp = _jparams(j, 1)
    x, valid = _rows(9, 2)
    jl = j.loss(jp, jnp.asarray(x), jnp.asarray(valid))
    tp = _bridge(jp)
    _close(t.loss(tp, torch.from_numpy(x), torch.from_numpy(valid)).numpy(),
           jl, "loss")
    _close(t.anomaly_scores(tp, torch.from_numpy(x)).numpy(),
           j.anomaly_scores(jp, jnp.asarray(x)), "scores")
    jg = jax.grad(lambda p: j.loss(p, jnp.asarray(x), jnp.asarray(valid)))(jp)
    layout = FlatLayout.of(tp)
    flat = layout.flatten(tp).requires_grad_(True)
    g, = torch.autograd.grad(
        t.loss(layout.unflatten(flat), torch.from_numpy(x),
               torch.from_numpy(valid)), flat)
    for (path, shape, off), want in zip(layout.entries, jax.tree.leaves(jg)):
        n = int(np.prod(shape))
        _close(g[off:off + n].reshape(shape).numpy(), want, str(path))


def test_leading_axes_equal_a_loop():
    """(S, N) params against (S, N, n, D) data, (S, M, 1) params against
    (S, 1, N, n, D) data and (S,) params against shared rows: each index
    equals the unbatched call."""
    j, t = _pair(**SMALL)
    S, N, M, n = 2, 3, 2, 5
    trees = [[_bridge(_jparams(j, 10 * s + i)) for i in range(N)]
             for s in range(S)]
    layout = FlatLayout.of(trees[0][0])
    flat = torch.stack([torch.stack([layout.flatten(p) for p in row])
                        for row in trees])                      # (S, N, P)
    x = torch.from_numpy(np.stack([np.stack([_rows(n, 100 * s + i)[0]
                                             for i in range(N)])
                                   for s in range(S)]))         # (S, N, n, D)
    valid = torch.from_numpy(np.stack([_rows(n, i)[1] for i in range(N)]))
    got = t.loss(layout.unflatten(flat), x, valid)
    want = torch.stack([torch.stack([t.loss(trees[s][i], x[s, i], valid[i])
                                     for i in range(N)]) for s in range(S)])
    _close(got.numpy(), want.numpy(), "(S, N) loss")
    models = flat[:, :M]                                        # (S, M, P)
    probe = t.loss(layout.unflatten(models[:, :, None, :]), x[:, None],
                   valid)                                       # (S, M, N)
    want = torch.stack([torch.stack([torch.stack([
        t.loss(trees[s][m], x[s, i], valid[i]) for i in range(N)])
        for m in range(M)]) for s in range(S)])
    _close(probe.numpy(), want.numpy(), "(S, M, 1) probe")
    tx = torch.from_numpy(_rows(7, 9)[0])
    got = t.anomaly_scores(layout.unflatten(flat[:, 0]), tx)    # (S, T)
    want = torch.stack([t.anomaly_scores(trees[s][0], tx) for s in range(S)])
    _close(got.numpy(), want.numpy(), "(S,) scores")


def test_dropout_engages_and_masks_equal_inline_draws():
    t = TD.SeqDetector(dropout=0.3, **SMALL)
    p = t.init_params(torch.Generator().manual_seed(0), device="cpu")
    x, valid = (torch.from_numpy(a) for a in _rows(6, 3))
    clean = t.loss(p, x, valid)
    inline = t.loss(p, x, valid, torch.Generator().manual_seed(5))
    masks = t.dropout_masks((6,), torch.Generator().manual_seed(5))
    assert len(masks) == 1 and masks[0].shape == (6, t.seq_len, t.d_model)
    assert not torch.equal(inline, clean)
    assert torch.equal(t.loss(p, x, valid, dropout_masks=masks), inline)
    assert TD.SeqDetector(**SMALL).dropout_masks(
        (6,), torch.Generator()) is None


def test_registry_roundtrip_and_data_spec_contract(tiny_padded, tiny_split):
    assert "seq-rglru" in TD.detector_names()
    det = TD.make_detector("seq-rglru", d_model=8)
    assert isinstance(det, TD.SeqDetector) and det.d_model == 8
    TD.register_detector("seq-rglru", TD.SeqDetector)     # idempotent
    with pytest.raises(ValueError, match="already registered"):
        TD.register_detector("seq-rglru", TD.AutoencoderDetector)
    assert TD.detector_names() == JD.detector_names()
    dx, counts = tiny_padded
    kw = dict(device_x=dx, device_counts=counts, test_x=tiny_split.test_x,
              test_y=tiny_split.test_y)
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        ts = TX.DataSpec(model=TD.SeqDetector(), **kw)
        js = JDataSpec(model=JD.SeqDetector(), **kw)
    assert ts.ae_cfg is None and js.ae_cfg is None
    assert isinstance(ts.model, TD.SeqDetector)


@pytest.mark.parametrize("scheme,k", [("tolfl", 2), ("fl", 1)])
def test_run_simulation_matches_repro(scheme, k, tiny_padded, tiny_split):
    dx, counts = tiny_padded
    j, t = _pair(**SMALL)
    kw = dict(scheme=scheme, num_devices=10, num_clusters=k, rounds=3,
              lr=1e-3, dropout=False, seed=0)
    jr = JS.run_simulation(j, dx, counts, tiny_split.test_x,
                           tiny_split.test_y, JS.SimConfig(**kw),
                           JF.FailureSpec(1, "server"))
    tr = TS.run_simulation(t, dx, counts, tiny_split.test_x,
                           tiny_split.test_y, TS.SimConfig(**kw),
                           TF.FailureSpec(1, "server"),
                           params0=_bridge(_jparams(j, 0)), device="cpu")
    assert tr.iso_active == jr.iso_active
    for f in ("loss_curve", "iso_loss_curve"):
        np.testing.assert_allclose(getattr(tr, f), getattr(jr, f),
                                   rtol=SIM_RTOL, atol=SIM_ATOL, err_msg=f)
    np.testing.assert_allclose(tr.auroc_curve, jr.auroc_curve, rtol=0,
                               atol=AUROC_ATOL)
    assert abs(tr.auroc_used - jr.auroc_used) <= AUROC_ATOL


def test_diverges_at_the_paper_lr_like_repro(tiny_padded, tiny_split):
    """At lr 1e-3 on the unnormalised features SeqDetector's loss blows up
    and turns non-finite, in ``repro`` as in the port, in the same round;
    before it, within the simulator's tolerance (rounds where the loss is
    still below 1e4)."""
    dx, counts = tiny_padded
    j, t = _pair(**SMALL)
    kw = dict(scheme="tolfl", num_devices=10, num_clusters=5, rounds=8,
              lr=1e-3, dropout=False, seed=0)
    jr = JS.run_simulation(j, dx, counts, tiny_split.test_x,
                           tiny_split.test_y, JS.SimConfig(**kw))
    tr = TS.run_simulation(t, dx, counts, tiny_split.test_x,
                           tiny_split.test_y, TS.SimConfig(**kw),
                           params0=_bridge(_jparams(j, 0)), device="cpu")
    firsts = [int(np.flatnonzero(~np.isfinite(r.loss_curve))[0])
              for r in (jr, tr)]
    assert firsts[0] == firsts[1] < kw["rounds"]
    calm = jr.loss_curve < 1e4
    np.testing.assert_allclose(tr.loss_curve[calm], jr.loss_curve[calm],
                               rtol=SIM_RTOL, atol=SIM_ATOL)
