"""Port parity for whisper-large-v3's encoder-decoder half against
``repro``: ``encode`` (through ``repro``'s Pallas attention in interpret
mode and through its blocked XLA attention) and ``cross_attend`` within
1e-4, the prefill table ``sinusoidal_positions`` bit for bit, the decode
row ``_sinusoidal_at`` within 1e-6 + position x 2^-23 (the last bit of
the float32 ``exp`` of its frequencies, XLA's against torch's), the GELU
MLP without a gate within 1e-5, and the decoder's cross-attention at a
decode step.  Params come
from ``repro``'s ``init_params`` on the reduced config (2 encoder and 2
decoder layers, d 256, 4 heads of 64, 16 frames) through the weight
bridge, inputs from numpy.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCHS as JARCHS
from repro.models import mlp as JMLP
from repro.models import transformer as JT
from repro.serving import decode as JD
from repro_torch.configs.registry import ARCHS as TARCHS
from repro_torch.models import mlp as TMLP
from repro_torch.models import params as TP
from repro_torch.models import transformer as TT
from repro_torch.serving import decode as TD
from torch_threads import one_torch_thread  # noqa: F401

ARCH = "whisper-large-v3"
TOL = dict(rtol=1e-4, atol=1e-4)


@pytest.fixture(scope="module")
def model():
    jcfg, tcfg = JARCHS[ARCH].reduced(), TARCHS[ARCH].reduced()
    assert dataclasses.asdict(jcfg) == dataclasses.asdict(tcfg)
    assert tcfg.is_encdec and tcfg.attention.rope_theta == 0
    assert (tcfg.act, tcfg.glu) == ("gelu", False)
    jp, _ = JT.init_params(jax.random.PRNGKey(0), jcfg)
    tp = TP.from_numpy_tree(jax.tree.map(np.asarray, jp), device="cpu")
    return jcfg, tcfg, jp, tp


def _x(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


@pytest.mark.parametrize("use_pallas", [True, False])
def test_encode_matches_repro(model, use_pallas):
    jcfg, tcfg, jp, tp = model
    frames = _x((2, jcfg.encoder_seq, jcfg.d_model), 1)
    want = JT.encode(jp, jcfg, jnp.asarray(frames), use_pallas=use_pallas)
    got = TT.encode(tp, tcfg, torch.from_numpy(frames))
    assert got.shape == (2, jcfg.encoder_seq, jcfg.d_model)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("S,F", [(96, 16), (7, 16), (16, 40)])
def test_cross_attend_matches_repro(model, S, F):
    """Sq = S queries on F encoder frames, every frame visible, for both
    decoder layers' params."""
    jcfg, tcfg, jp, tp = model
    h = _x((2, S, jcfg.d_model), S)
    enc = _x((2, F, jcfg.d_model), F + 1)
    for layer in range(jcfg.num_layers):
        jl = jax.tree.map(lambda w: w[layer], jp["cross"]["layers"])
        tl = TP.tree_map_with_path(lambda _, w: w[layer],
                                   tp["cross"]["layers"])
        want = JT.cross_attend(jl["attn"], jnp.asarray(h), jnp.asarray(enc),
                               jcfg, use_pallas=True)
        got = TT.cross_attend(tl["attn"], torch.from_numpy(h),
                              torch.from_numpy(enc), tcfg)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
        k, v = TT.cross_kv(tl["attn"], torch.from_numpy(enc), tcfg,
                           torch.float32)
        assert k.shape == v.shape == (2, F, tcfg.attention.num_kv_heads,
                                      tcfg.attention.head_dim)
        torch.testing.assert_close(
            TT.cross_out(tl["attn"], torch.from_numpy(h), k, v, tcfg), got,
            rtol=0, atol=0)


@pytest.mark.parametrize("S,d,offset", [(16, 256, 0), (1500, 1280, 0),
                                        (448, 1280, 0), (5, 64, 1000)])
def test_sinusoidal_positions_bitwise(S, d, offset):
    want = np.asarray(JT.sinusoidal_positions(S, d, offset))
    got = TT.sinusoidal_positions(S, d, offset)
    assert got.dtype == torch.float32 and got.shape == (S, d)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("d", [256, 1280])
@pytest.mark.parametrize("position", [0, 1, 17, 415, 447, 4096])
def test_sinusoidal_at_matches_repro(position, d):
    """The decode row in float32 arithmetic.  Its frequencies are float32
    ``exp``s, and XLA's and torch's differ by one ulp (2^-24 of a value
    below 1) in ~5% of them; the angle, position x frequency, carries
    that as position x 2^-24.  So the row is within 1e-6 + position x
    2^-23 of repro's (1e-6 up to position 8), and within twice that of
    the float64 prefill table's row."""
    want = np.asarray(JD._sinusoidal_at(jnp.int32(position), d))
    got = TD._sinusoidal_at(position, d)
    assert got.dtype == torch.float32 and got.shape == (d,)
    tol = 1e-6 + position * 2.0 ** -23
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=tol)
    table = TT.sinusoidal_positions(1, d, position)[0]
    torch.testing.assert_close(got, table, rtol=0, atol=2 * tol)
    # the angles themselves: the same float32 frequencies up to one ulp
    half = torch.arange(0, d, 2, dtype=torch.float32)
    rate = -jnp.log(10000.0) / d
    freq = np.array(jnp.exp(jnp.asarray(half.numpy()) * rate))
    torch.testing.assert_close(
        torch.exp(half * float(-torch.log(torch.tensor(10000.0)) / d)),
        torch.from_numpy(freq), rtol=2.0 ** -23, atol=0)


def test_gelu_mlp_without_gate_matches_repro(model):
    """Whisper is the zoo's first served MLP with act "gelu" (tanh
    approximation on both sides) and no gate."""
    jcfg, tcfg, jp, tp = model
    x = _x((2, 9, jcfg.d_model), 5) * 3.0
    jm = jax.tree.map(lambda w: w[0], jp["units"]["l0"]["mlp"])
    tm = TP.tree_map_with_path(lambda _, w: w[0], tp["units"]["l0"]["mlp"])
    assert set(tm) == {"up", "down"}
    want = JMLP.mlp_apply(jm, jnp.asarray(x), "gelu", False)
    got = TMLP.mlp_apply(tm, torch.from_numpy(x), "gelu", False)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)


def test_cross_decode_matches_repro(model):
    jcfg, tcfg, jp, tp = model
    a = jcfg.attention
    x = _x((3, 1, jcfg.d_model), 8)
    xk, xv = (_x((3, jcfg.encoder_seq, a.num_kv_heads, a.head_dim), s)
              for s in (9, 10))
    jc = jax.tree.map(lambda w: w[1], jp["cross"]["layers"])
    tc = TP.tree_map_with_path(lambda _, w: w[1], tp["cross"]["layers"])
    want = JD._cross_decode(jc, jnp.asarray(x), jnp.asarray(xk),
                            jnp.asarray(xv), jcfg)
    got = TD._cross_decode(tc, torch.from_numpy(x), torch.from_numpy(xk),
                           torch.from_numpy(xv), tcfg)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_prefill_equals_decode(model):
    """A decode step at position S gives the logits of a prefill over
    S + 1 tokens on the same frames (repro's test_serving.py, 2e-3)."""
    _, tcfg, _, tp = model
    g = torch.Generator().manual_seed(3)
    toks = torch.randint(0, tcfg.vocab_size, (2, 41), generator=g)
    frames = torch.randn((2, tcfg.encoder_seq, tcfg.d_model), generator=g)
    want, _ = TD.prefill(tp, tcfg, {"tokens": toks, "frames": frames})
    _, cache = TD.prefill(tp, tcfg, {"tokens": toks[:, :40],
                                     "frames": frames})
    cache = TD.pad_cache(cache, tcfg, 40, 41)
    got, new = TD.decode_step(tp, tcfg, toks[:, 40:], cache, 40)
    torch.testing.assert_close(got, want, rtol=2e-3, atol=2e-3)
    assert new["cross"] is cache["cross"]
