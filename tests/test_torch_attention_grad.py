"""The attention kernel's gradient on the CPU: the plain backward
(``flash_attention_backward_plain``, written out as the CUDA backward
kernel computes it) against ``jax.grad`` of ``repro.kernels.ref``'s
``attention_reference`` over the masks, GQA groups, Sq != Sk, a window
and fully masked rows; and ``FlashAttentionFn`` through
``flash_attention``.  float32 inputs; bound 2e-5 x each gradient's
largest |value| (float32 sums in another order).  A row that sees no key
is 0 in the kernels but the mean of v in the reference, so the cases
zero the output gradient of such rows before comparing (both then give
them zero gradient); their own test checks the kernels' zero."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.ref import attention_reference
from repro_torch.kernels import flash_attention as fa

CASES = [  # (B, Sq, Sk, H, KVH, D, causal, window)
    (2, 16, 16, 4, 4, 8, True, None),
    (1, 13, 13, 4, 2, 16, True, None),
    (2, 9, 12, 6, 1, 8, False, None),
    (1, 20, 20, 5, 1, 8, True, 6),
    (2, 11, 7, 4, 2, 8, False, 3),
    (1, 6, 10, 2, 2, 8, True, None),      # Sq < Sk, causal
    (1, 10, 4, 2, 1, 8, False, 2),        # rows past Sk + window: no key
]


def _inputs(case, seed):
    B, Sq, Sk, H, KVH, D, _, _ = case
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, Sq, H, D)).astype(np.float32)
    k = rng.standard_normal((B, Sk, KVH, D)).astype(np.float32)
    v = rng.standard_normal((B, Sk, KVH, D)).astype(np.float32)
    do = rng.standard_normal((B, Sq, H, D)).astype(np.float32)
    seen = fa.visible(Sq, Sk, case[6], case[7]).any(dim=1).numpy()
    do[:, ~seen] = 0.0
    return q, k, v, do


def _jax_grads(q, k, v, do, causal, window):
    def f(q, k, v):
        return jnp.sum(attention_reference(q, k, v, causal=causal,
                                           window=window) * do)
    return jax.grad(f, argnums=(0, 1, 2))(q, k, v)


def _close(got, ref):
    ref = np.asarray(ref)
    scale = max(float(np.max(np.abs(ref))), 1e-6)
    assert float(np.max(np.abs(got - ref))) <= 2e-5 * scale


@pytest.mark.parametrize("case", CASES)
def test_plain_backward_equals_jax_grad(case):
    """The plain backward, recomputing lse and given the forward's lse (as
    the tensor-core backward reads it): the two bit for bit, both within
    the bound of jax.grad."""
    causal, window = case[6], case[7]
    q, k, v, do = _inputs(case, hash(case) % 2**32)
    tq, tk, tv, tdo = (torch.from_numpy(x) for x in (q, k, v, do))
    o, lse = fa.flash_attention_plain(tq, tk, tv, causal, window,
                                      return_lse=True)
    got = fa.flash_attention_backward_plain(tq, tk, tv, o, tdo, causal,
                                            window)
    given = fa.flash_attention_backward_plain(tq, tk, tv, o, tdo, causal,
                                              window, lse=lse)
    for g, h, r in zip(got, given, _jax_grads(q, k, v, do, causal, window)):
        assert torch.equal(g, h)
        _close(g.numpy(), r)


@pytest.mark.parametrize("case", CASES[:4])
def test_flash_attention_is_differentiable(case):
    """flash_attention on CPU tensors that need a gradient goes through
    FlashAttentionFn: its gradients are the plain backward's, bit for
    bit, and the forward is unchanged."""
    causal, window = case[6], case[7]
    q, k, v, do = (torch.from_numpy(x) for x in _inputs(case, 1))
    leaves = [x.clone().requires_grad_(True) for x in (q, k, v)]
    out = fa.flash_attention(*leaves, causal=causal, window=window)
    out.backward(do)
    o = fa.flash_attention_plain(q, k, v, causal, window)
    assert torch.equal(out.detach(), o)
    for leaf, ref in zip(leaves, fa.flash_attention_backward_plain(
            q, k, v, o, do, causal, window)):
        assert torch.equal(leaf.grad, ref)


def test_fully_masked_rows_have_zero_gradient():
    """A row that sees no key (query 9 of a 2-wide window over 4 keys)
    outputs 0 and gets 0 gradient."""
    q, k, v, _ = (torch.from_numpy(x) for x in _inputs(CASES[-1], 2))
    do = torch.ones_like(q)
    o = fa.flash_attention_plain(q, k, v, False, 2)
    dq, _, _ = fa.flash_attention_backward_plain(q, k, v, o, do, False, 2)
    assert torch.all(o[:, 5:] == 0) and torch.all(dq[:, 5:] == 0)


def test_backward_raises_without_a_card_kernel_for_cpu_tensors():
    q = torch.zeros(1, 4, 2, 8)
    with pytest.raises(ValueError, match="CUDA"):
        fa.flash_attention_bwd_cuda(q, q[:, :, :1], q[:, :, :1], q, q)
