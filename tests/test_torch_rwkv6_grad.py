"""The WKV scan's gradient on the CPU: the plain backward
(``rwkv6_scan_backward_plain``, written out as the CUDA backward kernel
computes it) against ``jax.grad`` of ``repro.kernels.ref``'s
``rwkv6_reference``, with a non-zero initial state and a gradient of
the final state; and ``WKVScanFn`` through ``rwkv6_scan``.  float32;
bound 1e-5 x each gradient's largest |value| (another order of the
sums)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.ref import rwkv6_reference
from repro_torch.kernels import rwkv6_scan as wk

CASES = [(2, 9, 3, 8, True, True), (1, 40, 2, 16, True, False),
         (2, 33, 1, 8, False, True), (1, 5, 2, 32, True, True)]


def _inputs(B, S, H, N, seed):
    rng = np.random.default_rng(seed)

    def randn(*shape, scale=1.0):
        return (rng.standard_normal(shape) * scale).astype(np.float32)
    r, k, v = (randn(B, S, H, N, scale=0.5) for _ in range(3))
    w = (1 / (1 + np.exp(-(randn(B, S, H, N) + 2.0)))).astype(np.float32)
    u = randn(H, N, scale=0.3)
    s0 = randn(B, H, N, N, scale=0.1)
    dy = randn(B, S, H, N)
    ds = randn(B, H, N, N)
    return r, k, v, w, u, s0, dy, ds


@pytest.mark.parametrize("B,S,H,N,with_s0,with_ds", CASES)
def test_plain_backward_equals_jax_grad(B, S, H, N, with_s0, with_ds):
    r, k, v, w, u, s0, dy, ds = _inputs(B, S, H, N, S + N)
    if not with_s0:
        s0 = np.zeros_like(s0)

    def f(*xs):
        y, st = rwkv6_reference(*xs)
        return jnp.sum(y * dy) + (jnp.sum(st * ds) if with_ds else 0.0)
    ref = jax.grad(f, argnums=tuple(range(6)))(r, k, v, w, u, s0)
    got = wk.rwkv6_scan_backward_plain(
        *(torch.from_numpy(x) for x in (r, k, v, w, u, s0, dy)),
        torch.from_numpy(ds) if with_ds else None)
    for g, rr in zip(got, ref):
        rr = np.asarray(rr)
        scale = max(float(np.max(np.abs(rr))), 1e-6)
        assert float(np.max(np.abs(g.numpy() - rr))) <= 1e-5 * scale


def test_rwkv6_scan_is_differentiable():
    """rwkv6_scan on CPU tensors that need a gradient goes through
    WKVScanFn, whose gradients are the plain backward's bit for bit; an
    unused final state comes back as no gradient (None)."""
    r, k, v, w, u, s0, dy, _ = (torch.from_numpy(x)
                                for x in _inputs(2, 12, 2, 8, 0))
    leaves = [x.clone().requires_grad_(True) for x in (r, k, v, w, u, s0)]
    y, _ = wk.rwkv6_scan(*leaves)
    y.backward(dy)
    ref = wk.rwkv6_scan_backward_plain(r, k, v, w, u, s0, dy, None)
    for leaf, g in zip(leaves, ref):
        assert torch.equal(leaf.grad, g)
    assert torch.equal(y.detach(), wk.rwkv6_scan_plain(r, k, v, w, u, s0)[0])


def test_backward_raises_for_cpu_tensors_on_the_card_path():
    r, k, v, w, u, s0, dy, _ = (torch.from_numpy(x)
                                for x in _inputs(1, 3, 1, 8, 0))
    with pytest.raises(ValueError, match="CUDA"):
        wk.rwkv6_scan_bwd_cuda(r, k, v, w, u, s0, dy)
