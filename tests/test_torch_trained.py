"""Slice parity, continued: ``trained_params`` (the params export a
scoring service banks) against ``repro``'s, the comm and round-time
models, the port's device rule, and training from the port's own init.

Tolerances as in ``test_torch_simulate.py``: rtol 1e-4 / atol 1e-5 for
float32 params after <= 8 rounds summed in another order than XLA.
"""
import jax
import numpy as np
import pytest
import torch

from repro.configs.autoencoder_paper import AutoencoderConfig as JCfg
from repro.core import simulate as JS
from repro_torch.configs.autoencoder_paper import AutoencoderConfig as TCfg
from repro_torch.core import simulate as TS
from repro_torch.models.params import to_numpy_tree
from test_torch_simulate import AE, N, _close, _configs, _params0
from torch_threads import one_torch_thread  # noqa: F401


@pytest.mark.parametrize("isolated", [True, False])
def test_trained_params_match_repro(isolated, tiny_padded):
    jcfg, tcfg, jfail, tfail = _configs("tolfl_server")
    dx, counts = tiny_padded
    jg, jiso, jalive = JS.trained_params(JCfg(**AE), dx, counts, jcfg, jfail,
                                         isolated=isolated)
    tg, tiso, talive = TS.trained_params(TCfg(**AE), dx, counts, tcfg, tfail,
                                         isolated=isolated,
                                         params0=_params0(), device="cpu")
    np.testing.assert_array_equal(talive.numpy(), np.asarray(jalive))
    for got, want in ((tg, jg), (tiso, jiso)):
        got = to_numpy_tree(got)
        for layer, leaves in jax.tree.map(np.asarray, want).items():
            for leaf, arr in leaves.items():
                assert got[layer][leaf].shape == arr.shape
                _close(got[layer][leaf], arr, f"{layer}/{leaf}")


@pytest.mark.parametrize("scheme,k", [("batch", 1), ("fl", 1), ("sbt", 10),
                                      ("tolfl", 5), ("tolfl", 2)])
def test_comm_and_round_time_models_equal(scheme, k):
    assert (TS.comm_transfers_per_round(scheme, 10, k)
            == JS.comm_transfers_per_round(scheme, 10, k))
    for mb in (198_720, JCfg()):
        tmb = mb if isinstance(mb, int) else TCfg()
        assert (TS.comm_mb_per_round(scheme, 10, k, tmb)
                == JS.comm_mb_per_round(scheme, 10, k, mb))
        assert (TS.round_time_model(scheme, 10, k, 9000, tmb, 1e5)
                == JS.round_time_model(scheme, 10, k, 9000, mb, 1e5))


def test_run_simulation_without_device_needs_cuda(tiny_split, tiny_padded):
    """``device=None`` means CUDA: without a card the call raises rather
    than train quietly on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    dx, counts = tiny_padded
    cfg = TS.SimConfig(num_devices=N, rounds=1, dropout=False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TS.run_simulation(TCfg(**AE), dx, counts, tiny_split.test_x,
                          tiny_split.test_y, cfg)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TS.trained_params(TCfg(**AE), dx, counts, cfg)


def test_port_learns_with_its_own_init_and_dropout(tiny_split, tiny_padded):
    """Without ``params0`` the port draws its own init; with dropout on
    it trains (repro's bound from tests/test_simulator.py: AUROC > 0.7)
    and a seed repeats exactly."""
    dx, counts = tiny_padded
    cfg = TS.SimConfig(scheme="tolfl", num_devices=N, num_clusters=5,
                       rounds=40, lr=1e-3, dropout=True, seed=0)
    runs = [TS.run_simulation(TCfg(**AE), dx, counts, tiny_split.test_x,
                              tiny_split.test_y, cfg, device="cpu")
            for _ in range(2)]
    assert runs[0].final_auroc > 0.7, runs[0].final_auroc
    np.testing.assert_array_equal(runs[0].loss_curve, runs[1].loss_curve)
