"""Slice parity: the port's Tol-FL round loop against ``repro``'s.

Both simulators start from the same params (``repro``'s init, handed to
the port through the weight bridge) with dropout off, on the conftest
split (10 devices, 5 clusters, clusters 3 and 4 without samples).

Tolerances: the port sums float32 gradients in another order than XLA,
and ReLU networks amplify a last-bit difference in one round into a
slightly larger one in the next, so curves and scores are held to
rtol 1e-4 / atol 1e-5 over <= 8 rounds.  AUROCs agree within 1e-3,
since near-equal scores may swap ranks.  Masks and flags are exact.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.autoencoder_paper import AutoencoderConfig as JCfg
from repro.core import simulate as JS
from repro.core.failure import NO_FAILURE as J_NONE
from repro.core.failure import FailureSpec as JSpec
from repro.core.processes import trace_from_rows
from repro.models.detector import AutoencoderDetector as JAD
from repro_torch.configs.autoencoder_paper import AutoencoderConfig as TCfg
from repro_torch.core import failure as TF
from repro_torch.core import simulate as TS
from repro_torch.kernels import tolfl_combine as tc
from repro_torch.models.params import from_numpy_tree
from torch_threads import one_torch_thread  # noqa: F401

RTOL, ATOL = 1e-4, 1e-5
AUROC_ATOL = 1e-3
AE = dict(input_dim=112, hidden=(32, 16), code_dim=8, dropout=0.2)
N = 10

# (scheme, k, failure, config overrides).  ``lr`` 5e-4 keeps the tiny
# model's 8-round trajectory smooth; E = 2 local steps take lr 1e-3 and
# 4 rounds, because the pseudo-gradient (theta - theta_E) / lr carries
# float32 cancellation error that grows as lr shrinks.
CASES = {
    "tolfl": ("tolfl", 5, None, {}),
    "tolfl_server": ("tolfl", 5, ("server", 3), {}),
    "fl_server": ("fl", 1, ("server", 3), {}),
    "sbt": ("sbt", 10, None, {}),
    "batch": ("batch", 1, None, {}),
    "faulty": ("tolfl", 5, "faulty", {}),
    "local_epochs2": ("tolfl", 5, None,
                      dict(local_epochs=2, lr=1e-3, rounds=4)),
}
FAULTY_ROWS = [(2, N + 1, 0.5, 3)]     # device 1 sends half its delta


def _configs(name):
    scheme, k, failure, over = CASES[name]
    kw = dict(scheme=scheme, num_devices=N, num_clusters=k, rounds=8,
              lr=5e-4, dropout=False, seed=0)
    kw.update(over)
    faulty = failure == "faulty"
    jcfg = (JS.FaultySimConfig if faulty else JS.SimConfig)(**kw)
    tcfg = (TS.FaultySimConfig if faulty else TS.SimConfig)(**kw)
    if failure is None:
        return jcfg, tcfg, J_NONE, TF.NO_FAILURE
    if faulty:
        jt = trace_from_rows(FAULTY_ROWS, 8)
        tt = TF.FailureTrace(*(torch.from_numpy(np.array(getattr(jt, f)))
                               for f in ("epochs", "devices", "alive_after",
                                         "kinds")))
        return jcfg, tcfg, jt, tt
    kind, epoch = failure
    return jcfg, tcfg, JSpec(epoch, kind), TF.FailureSpec(epoch, kind)


def _params0(seed=0):
    """``repro``'s own init (its core draws from PRNGKey(seed)) as numpy,
    and the same through the bridge for the port."""
    p = JAD(JCfg(**AE)).init_params(jax.random.PRNGKey(seed))
    return from_numpy_tree(jax.tree.map(np.asarray, p), device="cpu")


def _close(got, want, what):
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL,
                               err_msg=what)


@pytest.mark.parametrize("name", list(CASES))
def test_run_simulation_matches_repro(name, tiny_split, tiny_padded):
    jcfg, tcfg, jfail, tfail = _configs(name)
    dx, counts = tiny_padded
    tx, ty = tiny_split.test_x, tiny_split.test_y
    a = JS.run_simulation(JCfg(**AE), dx, counts, tx, ty, jcfg, jfail)
    before = tc.LAUNCHES, tc.ROUND_LAUNCHES
    b = TS.run_simulation(TCfg(**AE), dx, counts, tx, ty, tcfg, tfail,
                          params0=_params0(), device="cpu")
    # the CPU path runs the fused aggregation's plain version
    assert (tc.LAUNCHES, tc.ROUND_LAUNCHES) == before
    assert b.iso_active == a.iso_active
    _close(b.loss_curve, a.loss_curve, "loss_curve")
    _close(b.iso_loss_curve, a.iso_loss_curve, "iso_loss_curve")
    np.testing.assert_allclose(b.auroc_curve, a.auroc_curve, rtol=0,
                               atol=AUROC_ATOL)
    for f in ("final_auroc", "iso_auroc", "auroc_used"):
        np.testing.assert_allclose(getattr(b, f), getattr(a, f), rtol=0,
                                   atol=AUROC_ATOL, err_msg=f)

    # the raw outputs, final scores included (repro's core is cached)
    jdx, jcounts, jvalid = JS._prepare_arrays(jcfg, dx, counts)
    jtrace = JS.as_trace(jfail, jcfg.topology())
    jo = JS._jitted_core(JCfg(**AE), jcfg, True)(
        jdx, jcounts, jvalid, jnp.asarray(tx), jtrace, jnp.int32(0))
    to = TS._scenario(TCfg(**AE), dx, counts, tx, tcfg, tfail, _params0(),
                      "cpu", isolated=False, track_iso=(name == "fl_server"),
                      score_history=True)[0]
    _close(to.final_scores.numpy(), np.asarray(jo.final_scores),
           "final_scores")
    _close(to.iso_final_scores.numpy(), np.asarray(jo.iso_final_scores),
           "iso_final_scores")
    _close(to.score_hist.numpy(), np.asarray(jo.score_hist), "score_hist")
    for f in ("final_alive", "server_dead", "server_dead_rounds"):
        np.testing.assert_array_equal(getattr(to, f).numpy(),
                                      np.asarray(getattr(jo, f)), err_msg=f)


def test_fl_server_failure_switches_to_isolated_curve(tiny_split,
                                                     tiny_padded):
    """Fig 4: FL's dead-server rounds report the isolated-mean curve."""
    _, tcfg, _, tfail = _configs("fl_server")
    dx, counts = tiny_padded
    b = TS.run_simulation(TCfg(**AE), dx, counts, tiny_split.test_x,
                          tiny_split.test_y, tcfg, tfail,
                          params0=_params0(), device="cpu")
    assert b.iso_active and b.auroc_used == b.iso_auroc
    np.testing.assert_array_equal(b.loss_curve[3:], b.iso_loss_curve[3:])
    # before the failure the isolated rows track the global model a
    # round behind (their loss is taken after the gated-off iso step)
    _close(b.iso_loss_curve[1:3], b.loss_curve[:2], "pre-failure rounds")


def test_fl_isolated_fallback_diverges_like_repro(tiny_split, tiny_padded):
    """At the paper's lr 1e-3 FL's isolated fallback diverges a few rounds
    after the server dies (Comms-ML features are not normalised), in
    ``repro`` as in the port: both reported loss curves turn non-finite
    in the same round, stay so, and agree within the module's tolerances
    before it.  ``chip_smoke.py`` holds FL's curves finite only up to the
    failure on the strength of this test."""
    fail = 3
    kw = dict(scheme="fl", num_devices=N, num_clusters=1, rounds=10,
              lr=1e-3, dropout=False, seed=0)
    dx, counts = tiny_padded
    tx, ty = tiny_split.test_x, tiny_split.test_y
    a = JS.run_simulation(JCfg(**AE), dx, counts, tx, ty,
                          JS.SimConfig(**kw), JSpec(fail, "server"))
    b = TS.run_simulation(TCfg(**AE), dx, counts, tx, ty,
                          TS.SimConfig(**kw), TF.FailureSpec(fail, "server"),
                          params0=_params0(), device="cpu")
    assert a.iso_active and b.iso_active
    firsts = []
    for r in (a, b):
        bad = np.flatnonzero(~np.isfinite(r.loss_curve))
        assert bad.size, "the isolated fallback did not diverge"
        assert not np.isfinite(r.loss_curve[bad[0]:]).any()
        firsts.append(int(bad[0]))
    assert firsts[0] == firsts[1]
    first = firsts[0]
    assert first > fail            # the global rounds before it stay finite
    _close(b.loss_curve[:first], a.loss_curve[:first], "loss_curve")
    _close(b.iso_loss_curve[:first], a.iso_loss_curve[:first],
           "iso_loss_curve")
    np.testing.assert_allclose(b.auroc_curve[:first], a.auroc_curve[:first],
                               rtol=0, atol=AUROC_ATOL)
