"""The paper's k-invariance, end to end, in the port: Tol-FL model updates
do not depend on the cluster count k (Section III).

Port of ``tests/test_tolfl_invariance.py`` with its fixtures, lr 5e-4,
dropout off and its tolerances: the port's simulator with k in {1 (FL),
2, 5, 10 (SBT)} on the same data and init gives near-identical loss
curves and AUROCs, and the streaming combine (the fused round kernel's
plain version on the CPU) equals the direct one.  Also: the port's
config classes have ``repro``'s fields in ``repro``'s order, and its
``combine="direct"`` run follows ``repro``'s.
"""
import dataclasses

import jax
import numpy as np
import pytest

from repro.configs.autoencoder_paper import AutoencoderConfig as JCfg
from repro.core import simulate as JS
from repro.core.failure import NO_FAILURE as J_NONE
from repro.models.detector import AutoencoderDetector as JAD
from repro_torch.configs.autoencoder_paper import AutoencoderConfig as TCfg
from repro_torch.core import simulate as TS
from repro_torch.core.failure import NO_FAILURE
from repro_torch.kernels import tolfl_combine as tc
from repro_torch.models.params import from_numpy_tree
from torch_threads import one_torch_thread  # noqa: F401

ROUNDS = 12


def run(ae_cfg, padded, split, scheme, k, combine="streaming", seed=0):
    dx, counts = padded
    cfg = TS.SimConfig(scheme=scheme, num_devices=10, num_clusters=k,
                       rounds=ROUNDS, lr=5e-4, dropout=False, seed=seed,
                       combine=combine)
    return TS.run_simulation(TCfg(**dataclasses.asdict(ae_cfg)), dx, counts,
                             split.test_x, split.test_y, cfg, NO_FAILURE,
                             device="cpu")


@pytest.fixture(scope="module")
def curves(tiny_ae_cfg, tiny_padded, tiny_split):
    out = {}
    for scheme, k in (("fl", 1), ("tolfl", 2), ("tolfl", 5), ("sbt", 10)):
        out[(scheme, k)] = run(tiny_ae_cfg, tiny_padded, tiny_split,
                               scheme, k)
    return out


def test_k_invariance_loss_curves(curves):
    base = curves[("fl", 1)].loss_curve
    for key, res in curves.items():
        np.testing.assert_allclose(
            res.loss_curve, base, rtol=1e-4, atol=1e-5,
            err_msg=f"k-invariance violated for {key}")


def test_k_invariance_auroc(curves):
    base = curves[("fl", 1)].final_auroc
    for key, res in curves.items():
        np.testing.assert_allclose(res.final_auroc, base, atol=1e-3,
                                   err_msg=str(key))


def test_streaming_equals_direct_combine(tiny_ae_cfg, tiny_padded,
                                         tiny_split):
    before = tc.ROUND_LAUNCHES, tc.LAUNCHES
    a = run(tiny_ae_cfg, tiny_padded, tiny_split, "tolfl", 5, "streaming")
    b = run(tiny_ae_cfg, tiny_padded, tiny_split, "tolfl", 5, "direct")
    assert (tc.ROUND_LAUNCHES, tc.LAUNCHES) == before   # plain versions
    np.testing.assert_allclose(a.loss_curve, b.loss_curve, rtol=1e-4,
                               atol=1e-5)


def test_loss_decreases(curves):
    for key, res in curves.items():
        assert res.loss_curve[-1] < res.loss_curve[0], key


@pytest.mark.parametrize("name", ["SimConfig", "FaultySimConfig"])
def test_config_fields_match_repro(name):
    """The campaign and ``plan()`` key scenarios by config: the port's
    classes carry ``repro``'s fields, defaults and order."""
    def fields(cls):
        return [(f.name, f.default) for f in dataclasses.fields(cls)]
    assert fields(getattr(TS, name)) == fields(getattr(JS, name))
    assert TS.SimConfig().combine == "streaming"


def test_direct_combine_matches_repro(tiny_ae_cfg, tiny_padded, tiny_split):
    """``combine="direct"`` (``cluster_reduce`` then ``weighted_mean``)
    follows ``repro``'s direct run from the same init, within the
    simulator parity's rtol 1e-4."""
    dx, counts = tiny_padded
    kw = dict(scheme="tolfl", num_devices=10, num_clusters=5, rounds=8,
              lr=5e-4, dropout=False, seed=0, combine="direct")
    want = JS.run_simulation(tiny_ae_cfg, dx, counts, tiny_split.test_x,
                             tiny_split.test_y, JS.SimConfig(**kw), J_NONE)
    p0 = JAD(tiny_ae_cfg).init_params(jax.random.PRNGKey(0))
    got = TS.run_simulation(
        TCfg(**dataclasses.asdict(tiny_ae_cfg)), dx, counts,
        tiny_split.test_x, tiny_split.test_y, TS.SimConfig(**kw), NO_FAILURE,
        params0=from_numpy_tree(jax.tree.map(np.asarray, p0), device="cpu"),
        device="cpu")
    np.testing.assert_allclose(got.loss_curve, want.loss_curve, rtol=1e-4,
                               atol=1e-5)
    np.testing.assert_allclose(got.final_auroc, want.final_auroc, atol=1e-3)
