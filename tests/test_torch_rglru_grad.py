"""The RG-LRU scan's gradient: the port's backward against autograd and
against ``repro``.

``repro`` differentiates the recurrence h_t = a_t h_{t-1} + b_t through
``jax.lax.associative_scan`` (``repro.models.rglru._lru_scan`` with
``use_pallas=False``, the path ``SeqDetector`` trains on); the port's
gradient is ``rglru_scan.RGLRUScanFn``, whose backward is a CUDA kernel on
the card and ``rglru_scan_backward_plain`` on the CPU.

* The plain backward equals ``torch.autograd`` through the plain forward
  loop bit for bit: the same multiplies and adds, each rounded, in the
  same order.
* It agrees with ``jax.grad`` through ``repro``'s associative scan within
  rtol 1e-5 / atol 1e-6 (the scan's tree of products rounds in another
  order than the sequential loop).
* ``RGLRUScanFn``'s forward is ``rglru_scan_plain`` unchanged, and
  ``ops.rglru`` is differentiable on the CPU through it.

* The few-chains backward kernel's start, g = -0 against a_S = +0 (the
  TMA zero fill), gives the plain backward bit for bit, signed zeros
  planted in dh's last step included.

Cases: (B, S, W) = (3, 7, 16) (SeqDetector's window and width), (2, 33,
40) (ragged, more than one of the kernel's 32-step stages), S = 1, and B
= 1 as RecurrentGemma trains: (1, 70, 132) (three stages, a ragged last
one, channels past four warps' 128) and (1, 65, 6); each with and
without h0.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import rglru as JR
from repro_torch.kernels import ops, ref
from repro_torch.kernels import rglru_scan as rs
from torch_threads import one_torch_thread  # noqa: F401

CASES = [(3, 7, 16), (2, 33, 40), (4, 1, 8), (1, 70, 132), (1, 65, 6)]
RTOL, ATOL = 1e-5, 1e-6


def _inputs(B, S, W, seed):
    rng = np.random.default_rng(seed)
    a = (1.0 / (1.0 + np.exp(-rng.normal(size=(B, S, W))))).astype(
        np.float32)
    b = rng.normal(size=(B, S, W)).astype(np.float32)
    h0 = rng.normal(size=(B, W)).astype(np.float32)
    dh = rng.normal(size=(B, S, W)).astype(np.float32)
    return a, b, h0, dh


def _torch(*xs):
    return [torch.from_numpy(x) for x in xs]


@pytest.mark.parametrize("with_h0", [False, True])
@pytest.mark.parametrize("B,S,W", CASES)
def test_plain_backward_equals_autograd_bitwise(B, S, W, with_h0):
    a, b, h0, dh = _torch(*_inputs(B, S, W, B * S + W))
    leaves = [a.clone().requires_grad_(True), b.clone().requires_grad_(True),
              h0.clone().requires_grad_(True) if with_h0 else None]
    h = ref.rglru_reference(*leaves)
    want = torch.autograd.grad(h, [t for t in leaves if t is not None], dh)
    got = rs.rglru_scan_backward_plain(a, h.detach(),
                                       h0 if with_h0 else None, dh)
    assert (got[2] is None) == (not with_h0)
    for g, w in zip([t for t in got if t is not None], want):
        assert torch.equal(g, w)


@pytest.mark.parametrize("with_h0", [False, True])
@pytest.mark.parametrize("B,S,W", CASES)
def test_backward_matches_jax_grad_of_associative_scan(B, S, W, with_h0):
    a, b, h0, dh = _inputs(B, S, W, 7 * B + S)

    def jloss(a_, b_, h0_):
        h = JR._lru_scan(a_, b_, h0_ if with_h0 else None, use_pallas=False)
        return jnp.sum(h * dh)
    # jitted: one XLA compile a case, where eager dispatch compiles each of
    # the scan's ops (~1 s against ~9 s a case on a CPU)
    want = jax.jit(jax.grad(jloss, argnums=(0, 1, 2)))(
        jnp.asarray(a), jnp.asarray(b), jnp.asarray(h0))
    ta, tb, th0, tdh = _torch(a, b, h0, dh)
    h = rs.rglru_scan_plain(ta, tb, th0 if with_h0 else None)
    got = rs.rglru_scan_backward_plain(ta, h, th0 if with_h0 else None, tdh)
    for name, g, w in zip(("da", "db", "dh0"), got, want):
        if name == "dh0" and not with_h0:
            assert g is None
            continue
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=RTOL,
                                   atol=ATOL, err_msg=name)


@pytest.mark.parametrize("with_h0", [False, True])
@pytest.mark.parametrize("B,S,W", CASES)
def test_scan_fn_forward_unchanged_and_differentiable(B, S, W, with_h0):
    a, b, h0, dh = _torch(*_inputs(B, S, W, S + W))
    h0 = h0 if with_h0 else None
    assert torch.equal(rs.RGLRUScanFn.apply(a, b, h0),
                       rs.rglru_scan_plain(a, b, h0))
    leaves = [t.clone().requires_grad_(True) for t in (a, b, h0)
              if t is not None]
    h = ops.rglru(*leaves, *([None] if h0 is None else []))
    assert torch.equal(h.detach(), rs.rglru_scan_plain(a, b, h0))
    grads = torch.autograd.grad(h, leaves, dh)
    want = rs.rglru_scan_backward_plain(a, h.detach(), h0, dh)
    for g, w in zip(grads, [t for t in want if t is not None]):
        assert torch.equal(g, w)


@pytest.mark.parametrize("with_h0", [False, True])
@pytest.mark.parametrize("B,S,W", CASES)
def test_zero_fill_start_is_the_plain_backward(B, S, W, with_h0):
    """The few-chains kernel takes no branch at step S - 1: its g starts at
    -0 and the step reads a_S from the TMA zero fill, +0, so g_{S-1} =
    dh_{S-1} + (+0 * -0), which is dh_{S-1} bit for bit (a -0 stays -0),
    as the plain loop's g_{S-1} = dh_{S-1}; every later step is the plain
    loop's multiply then add."""
    a, b, h0, dh = _torch(*_inputs(B, S, W, 3 * S + W))
    dh[:, -1, ::2] = -0.0
    dh[:, -1, 1::4] = 0.0
    h0 = h0 if with_h0 else None
    h = rs.rglru_scan_plain(a, b, h0)
    g = torch.full((B, W), -0.0)
    da, db = torch.empty_like(a), torch.empty_like(a)
    for t in range(S - 1, -1, -1):
        a_next = a[:, t + 1] if t + 1 < S else torch.zeros_like(g)
        g = dh[:, t] + a_next * g
        h_prev = (h[:, t - 1] if t > 0 else
                  torch.zeros_like(g) if h0 is None else h0)
        da[:, t], db[:, t] = g * h_prev, g
    want = rs.rglru_scan_backward_plain(a, h, h0, dh)
    bits = [x.view(torch.int32) for x in (da, db, want[0], want[1])]
    assert torch.equal(bits[0], bits[2]) and torch.equal(bits[1], bits[3])
    assert torch.equal(db[:, -1].view(torch.int32),
                       dh[:, -1].view(torch.int32))
    if with_h0:
        assert torch.equal((a[:, 0] * g).view(torch.int32),
                           want[2].view(torch.int32))


def test_scan_without_grad_records_nothing():
    """Serving's scans (no input needs a gradient) stay plain calls: no
    autograd node, values unchanged."""
    a, b, h0, _ = _torch(*_inputs(2, 5, 8, 0))
    h = ops.rglru(a, b, h0)
    assert h.grad_fn is None
    assert torch.equal(h, rs.rglru_scan_plain(a, b, h0))


def test_backward_checks_its_inputs():
    a, b, _, dh = _torch(*_inputs(2, 5, 8, 1))
    with pytest.raises(ValueError, match="CUDA"):
        rs.rglru_scan_bwd_cuda(a, b, None, dh)
    with pytest.raises(ValueError, match="one non-empty"):
        rs.rglru_scan_bwd_cuda(a, b, None, dh[:, :3])
