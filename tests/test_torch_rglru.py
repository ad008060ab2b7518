"""Port parity for the recurrent block: the RG-LRU scan kernel's plain
version against ``repro``'s Pallas kernel (interpret mode), and the
RG-LRU block, its causal conv, the GLU MLP and the norms against
``repro``'s, from params that ``repro`` initialised and handed over
through the weight bridge.

Tolerances: the scan's plain loop does the Pallas kernel's multiply and
add in the same order, so it agrees to 1e-6; the blocks sum float32
products in another order than XLA's, so rtol = atol = 1e-5 (1e-2 for
the bfloat16 case, the rounding step of bf16 at these magnitudes).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCHS as JARCHS
from repro.kernels.rglru_scan import rglru_scan as j_scan
from repro.models import mlp as JM
from repro.models import params as JP
from repro.models import rglru as JG
from repro.models import transformer as JT
from repro_torch.configs.registry import ARCHS as TARCHS
from repro_torch.kernels import ops, ref
from repro_torch.kernels import rglru_scan as trs
from repro_torch.models import mlp as TM
from repro_torch.models import params as TP
from repro_torch.models import rglru as TG

TOL = dict(rtol=1e-5, atol=1e-5)


def _ab(B, S, W, seed=0):
    rng = np.random.default_rng(seed)
    a = 1.0 / (1.0 + np.exp(-rng.standard_normal((B, S, W))))
    return (a.astype(np.float32),
            rng.standard_normal((B, S, W)).astype(np.float32),
            rng.standard_normal((B, W)).astype(np.float32))


# the shapes of tests/test_kernels.py (with and without an initial state)
@pytest.mark.parametrize("B,S,W,t_block,w_block,with_h0", [
    (1, 64, 8, 32, 8, False), (2, 128, 16, 32, 8, False),
    (1, 256, 64, 32, 8, False), (3, 128, 32, 32, 8, False),
    (2, 64, 16, 16, 16, True), (1, 128, 8, 16, 8, True)])
def test_scan_plain_matches_pallas_kernel(B, S, W, t_block, w_block,
                                          with_h0):
    a, b, h0 = _ab(B, S, W)
    want = j_scan(jnp.asarray(a), jnp.asarray(b),
                  jnp.asarray(h0) if with_h0 else None, t_block=t_block,
                  w_block=w_block, interpret=True)
    got = ops.rglru(torch.from_numpy(a), torch.from_numpy(b),
                    torch.from_numpy(h0) if with_h0 else None)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                               atol=1e-6)


def test_scan_plain_ragged_is_the_reference_loop():
    """Lengths the Pallas kernel cannot tile: the plain version is the
    oracle's loop, bit for bit."""
    a, b, h0 = (torch.from_numpy(x) for x in _ab(3, 101, 37, seed=1))
    assert torch.equal(trs.rglru_scan_plain(a, b, h0),
                       ref.rglru_reference(a, b, h0))


def test_scan_rejects_bad_input():
    a, b, h0 = (torch.from_numpy(x) for x in _ab(2, 8, 4))
    with pytest.raises(ValueError):
        ops.rglru(a, b, h0[:1])
    with pytest.raises(TypeError):
        ops.rglru(a.double(), b.double())


def _rec_params(seed=0):
    cfg = JARCHS["recurrentgemma-9b"].reduced()
    jp, _ = JT.init_params(jax.random.PRNGKey(seed), cfg)
    jlayer = jax.tree.map(lambda x: x[0], jp["units"]["l0"])  # the rec layer
    tlayer = TP.from_numpy_tree(jax.tree.map(np.asarray, jlayer),
                                device="cpu")
    return cfg, TARCHS["recurrentgemma-9b"].reduced(), jlayer, tlayer


@pytest.mark.parametrize("with_state", [False, True])
def test_rglru_apply_matches(with_state):
    jcfg, tcfg, jp, tp = _rec_params()
    rng = np.random.default_rng(2)
    W, cw = jcfg.recurrent.lru_width, jcfg.recurrent.conv1d_width
    x = rng.standard_normal((2, 40, jcfg.d_model)).astype(np.float32)
    st = {"h": rng.standard_normal((2, W)).astype(np.float32),
          "conv": rng.standard_normal((2, cw - 1, W)).astype(np.float32)}
    jst = jax.tree.map(jnp.asarray, st) if with_state else None
    tst = ({k: torch.from_numpy(v) for k, v in st.items()} if with_state
           else None)
    jout, jnew = JG.rglru_apply(jp["mix"], jnp.asarray(x), jcfg, state=jst,
                                use_pallas=True)
    tout, tnew = TG.rglru_apply(tp["mix"], torch.from_numpy(x), tcfg,
                                state=tst)
    np.testing.assert_allclose(tout.numpy(), np.asarray(jout), **TOL)
    for k in ("h", "conv"):
        np.testing.assert_allclose(tnew[k].numpy(), np.asarray(jnew[k]),
                                   **TOL)


def test_rglru_decode_matches():
    jcfg, tcfg, jp, tp = _rec_params(seed=1)
    rng = np.random.default_rng(3)
    W, cw = jcfg.recurrent.lru_width, jcfg.recurrent.conv1d_width
    x = rng.standard_normal((3, 1, jcfg.d_model)).astype(np.float32)
    st = {"h": rng.standard_normal((3, W)).astype(np.float32),
          "conv": rng.standard_normal((3, cw - 1, W)).astype(np.float32)}
    jout, jnew = JG.rglru_decode(jp["mix"], jnp.asarray(x), jcfg,
                                 jax.tree.map(jnp.asarray, st))
    tout, tnew = TG.rglru_decode(tp["mix"], torch.from_numpy(x), tcfg,
                                 {k: torch.from_numpy(v)
                                  for k, v in st.items()})
    np.testing.assert_allclose(tout.numpy(), np.asarray(jout), **TOL)
    for k in ("h", "conv"):
        np.testing.assert_allclose(tnew[k].numpy(), np.asarray(jnew[k]),
                                   **TOL)


@pytest.mark.parametrize("cw,with_state", [(4, False), (4, True),
                                           (1, False)])
def test_causal_conv1d_matches(cw, with_state):
    rng = np.random.default_rng(4)
    xw = rng.standard_normal((2, 9, 12)).astype(np.float32)
    w = rng.standard_normal((cw, 12)).astype(np.float32)
    b = rng.standard_normal((12,)).astype(np.float32)
    st = rng.standard_normal((2, cw - 1, 12)).astype(np.float32)
    jo, js = JG._causal_conv1d(jnp.asarray(xw), jnp.asarray(w),
                               jnp.asarray(b),
                               jnp.asarray(st) if with_state else None)
    to, ts = TG._causal_conv1d(torch.from_numpy(xw), torch.from_numpy(w),
                               torch.from_numpy(b),
                               torch.from_numpy(st) if with_state else None)
    np.testing.assert_allclose(to.numpy(), np.asarray(jo), **TOL)
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), **TOL)


@pytest.mark.parametrize("glu,act", [(True, "gelu"), (False, "silu")])
def test_mlp_apply_matches(glu, act):
    jp, _ = JM.mlp_init(jax.random.PRNGKey(5), 64, 96, glu, "float32")
    tp = TP.from_numpy_tree(jax.tree.map(np.asarray, jp), device="cpu")
    x = np.random.default_rng(6).standard_normal((2, 7, 64)).astype(
        np.float32)
    np.testing.assert_allclose(
        TM.mlp_apply(tp, torch.from_numpy(x), act, glu).numpy(),
        np.asarray(JM.mlp_apply(jp, jnp.asarray(x), act, glu)), **TOL)


def test_mlp_apply_bf16_casts_params_per_call():
    """float32 params, bfloat16 activations: the weights are cast to the
    activations' dtype for the call, as repro does."""
    jp, _ = JM.mlp_init(jax.random.PRNGKey(7), 64, 96, True, "float32")
    tp = TP.from_numpy_tree(jax.tree.map(np.asarray, jp), device="cpu")
    x = np.random.default_rng(8).standard_normal((2, 5, 64)).astype(
        np.float32)
    got = TM.mlp_apply(tp, torch.from_numpy(x).bfloat16(), "gelu", True)
    want = JM.mlp_apply(jp, jnp.asarray(x, jnp.bfloat16), "gelu", True)
    assert got.dtype == torch.bfloat16 and tp["up"]["w"].dtype == torch.float32
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), rtol=1e-2,
                               atol=1e-2)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rmsnorm_matches(dtype):
    rng = np.random.default_rng(9)
    x = rng.standard_normal((3, 5, 32)).astype(np.float32) * 3
    scale = rng.standard_normal(32).astype(np.float32)
    want = JP.rmsnorm_apply({"scale": jnp.asarray(scale)},
                            jnp.asarray(x, jnp.dtype(dtype)), 1e-6)
    got = TP.rmsnorm_apply({"scale": torch.from_numpy(scale)},
                           torch.from_numpy(x).to(getattr(torch, dtype)),
                           1e-6)
    assert str(got.dtype) == f"torch.{dtype}"
    tol = 1e-2 if dtype == "bfloat16" else 1e-5
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), rtol=tol,
                               atol=tol)
