"""Port parity for the detector: the paper autoencoder's forward pass,
masked loss, anomaly scores and per-device gradients, from params that
``repro`` initialised and handed over through the weight bridge.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.autoencoder_paper import AutoencoderConfig as JCfg
from repro.models import autoencoder as JAE
from repro.models import detector as JD
from repro.models import params as JP
from repro_torch.configs import autoencoder_paper as TCfg
from repro_torch.models import autoencoder as TAE
from repro_torch.models import detector as TD
from repro_torch.models import params as TP

# float32 products summed in another order than XLA's: agree to ~1e-6
# relative, so 1e-5 leaves a margin without hiding a wrong formula
RTOL = ATOL = 1e-5

CFGS = [dict(input_dim=112, hidden=(32, 16), code_dim=8, dropout=0.2),
        dict(input_dim=112, hidden=(128, 64), code_dim=32, dropout=0.2)]


def _pair(kw):
    return JCfg(**kw), TCfg.AutoencoderConfig(**kw)


def _params(jcfg, seed=0):
    jp = JD.AutoencoderDetector(jcfg).init_params(jax.random.PRNGKey(seed))
    npt = jax.tree.map(np.asarray, jp)
    return jp, npt, TP.from_numpy_tree(npt, device="cpu")


@pytest.mark.parametrize("kw", CFGS)
def test_forward_loss_scores_match(kw):
    jcfg, tcfg = _pair(kw)
    jp, _, tp = _params(jcfg)
    rng = np.random.default_rng(0)
    x = rng.standard_normal((37, kw["input_dim"])).astype(np.float32)
    valid = (rng.random(37) < 0.7).astype(np.float32)
    xj, xt = jnp.asarray(x), torch.from_numpy(x)
    np.testing.assert_allclose(
        TAE.forward(tp, tcfg, xt).numpy(),
        np.asarray(JAE.forward(jp, jcfg, xj)), rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(
        TAE.recon_loss(tp, tcfg, xt).numpy(),
        np.asarray(JAE.recon_loss(jp, jcfg, xj)), rtol=RTOL, atol=ATOL)
    jd, td = JD.AutoencoderDetector(jcfg), TD.AutoencoderDetector(tcfg)
    np.testing.assert_allclose(
        td.loss(tp, xt, torch.from_numpy(valid)).numpy(),
        np.asarray(jd.loss(jp, xj, jnp.asarray(valid))), rtol=RTOL,
        atol=ATOL)
    np.testing.assert_allclose(
        td.anomaly_scores(tp, xt).numpy(),
        np.asarray(jd.anomaly_scores(jp, xj)), rtol=RTOL, atol=ATOL)


def test_masked_loss_all_invalid_is_zero():
    """A device with no samples (the zero-count clusters of the paper
    split) divides by max(sum(valid), 1): loss 0, not NaN."""
    jcfg, tcfg = _pair(CFGS[0])
    jp, _, tp = _params(jcfg)
    x = np.ones((5, 112), np.float32)
    v = np.zeros(5, np.float32)
    got = TD.AutoencoderDetector(tcfg).loss(tp, torch.from_numpy(x),
                                            torch.from_numpy(v))
    want = JD.AutoencoderDetector(jcfg).loss(jp, jnp.asarray(x),
                                             jnp.asarray(v))
    assert float(got) == float(want) == 0.0


@pytest.mark.parametrize("kw", CFGS)
def test_per_device_gradients_match_vmap_grad(kw, tiny_padded):
    """The port's one batched backward pass gives each device its own
    gradient: equal to ``jax.vmap(jax.grad(loss))`` over the devices."""
    from repro_torch.core.simulate import _device_grads
    jcfg, tcfg = _pair(kw)
    jp, _, tp = _params(jcfg, seed=1)
    dx, counts = tiny_padded
    valid = (np.arange(dx.shape[1])[None, :]
             < counts[:, None]).astype(np.float32)
    jd = JD.AutoencoderDetector(jcfg)
    gj = jax.vmap(jax.grad(lambda p, x, v: jd.loss(p, x, v, None)),
                  in_axes=(None, 0, 0))(jp, jnp.asarray(dx),
                                        jnp.asarray(valid))
    layout = TP.FlatLayout.of(tp)
    flat = layout.flatten(tp)
    g = _device_grads(TD.AutoencoderDetector(tcfg), layout,
                      flat.expand(dx.shape[0], -1), torch.from_numpy(dx),
                      torch.from_numpy(valid), None)
    got = TP.to_numpy_tree(layout.unflatten(g))
    want = jax.tree.map(np.asarray, gj)
    for path, leaf in TP.tree_items(want):
        node = got
        for key in path:
            node = node[key]
        assert node.shape == leaf.shape, path
        # gradients reach ~2e2 on this data: 1e-5 absolute plus 1e-5
        # relative covers the reordered float32 sums
        np.testing.assert_allclose(node, leaf, rtol=RTOL, atol=ATOL,
                                   err_msg=str(path))


@pytest.mark.parametrize("kw", CFGS)
def test_param_count_and_bytes_equal(kw):
    jcfg, tcfg = _pair(kw)
    jd, td = JD.AutoencoderDetector(jcfg), TD.AutoencoderDetector(tcfg)
    assert jd.param_count() == td.param_count()
    assert jd.param_bytes() == td.param_bytes()
    _, npt, tp = _params(jcfg)
    assert TP.param_count(tp) == JP.param_count(npt)
    assert TP.param_bytes(tp) == JP.param_bytes(npt)


def test_weight_bridge_round_trip_and_layout():
    jcfg, _ = _pair(CFGS[0])
    _, npt, tp = _params(jcfg)
    back = TP.to_numpy_tree(tp)
    for (pa, a), (pb, b) in zip(TP.tree_items(npt), TP.tree_items(back)):
        assert pa == pb
        assert a.dtype == b.dtype and a.tobytes() == b.tobytes()
    # the flat layout follows jax.tree.leaves order and round-trips
    layout = TP.FlatLayout.of(tp)
    flat = layout.flatten(tp)
    want = np.concatenate([np.ravel(x) for x in jax.tree.leaves(npt)])
    np.testing.assert_array_equal(flat.numpy(), want)
    again = TP.to_numpy_tree(layout.unflatten(flat))
    for (_, a), (_, b) in zip(TP.tree_items(npt), TP.tree_items(again)):
        np.testing.assert_array_equal(a, b)


def test_port_init_distribution():
    """The port's own init: normal weights with std 1/sqrt(fan_in), zero
    biases (``repro``'s distribution; not its draws)."""
    _, tcfg = _pair(CFGS[1])
    p = TD.AutoencoderDetector(tcfg).init_params(
        torch.Generator().manual_seed(0), device="cpu")
    assert sorted(p) == [f"fc{i}" for i in range(6)]
    for i in range(6):
        w, b = p[f"fc{i}"]["w"], p[f"fc{i}"]["b"]
        assert not b.any()
        std = float(w.std()) * np.sqrt(w.shape[0])
        # >= 2048 draws per layer: the sample std is within 10% of 1
        assert 0.9 < std < 1.1, (i, std)


def test_init_params_needs_a_device():
    """``device=None`` means CUDA: without a card the call raises."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    _, tcfg = _pair(CFGS[0])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TD.AutoencoderDetector(tcfg).init_params(torch.Generator())


def test_dropout_uses_the_generator():
    """Dropout draws from the given generator: same seed, same mask."""
    _, tcfg = _pair(CFGS[0])
    tp = TD.AutoencoderDetector(tcfg).init_params(
        torch.Generator().manual_seed(0), device="cpu")
    x = torch.ones((4, 112))
    a = TAE.forward(tp, tcfg, x, torch.Generator().manual_seed(5))
    b = TAE.forward(tp, tcfg, x, torch.Generator().manual_seed(5))
    c = TAE.forward(tp, tcfg, x, torch.Generator().manual_seed(6))
    assert torch.equal(a, b) and not torch.equal(a, c)
