"""Training at bf16 params (``ModelConfig.param_dtype="bfloat16"``)
against ``repro``, on the CPU.

(a) ``loss_fn``'s value, aux and every gradient leaf for five families
(dense, Qwen3's mixed tree with float32 qk-norm scales, MoE, hybrid,
SSM) with ``repro``'s bf16 params carried over, through
``test_torch_train_model.py``'s ``check_family``: the loss within rtol
2e-6 (measured 7e-8), each gradient in its leaf's dtype and within 1e-2
x its own largest |value| + 1e-5 x the largest of any leaf (measured
<= 4.7e-3: both round the same sums of bf16 products in other orders,
one bf16 ulp is 2^-8 of a value).

(b) The optimizers run eagerly on bf16 and mixed trees (bf16 leaves and
a float32 one) for three steps against ``repro``'s: SGD, Adam and AdamW,
clip on and off, ``state_dtype`` None, float32 and bfloat16.  The params
and moments of every bf16 leaf are ``repro``'s bit for bit, as are all
of them without the clip; under the clip the float32 leaf of a mixed
tree is within rtol 1e-5 and an atol of 1e-6 x the leaf's largest
|value| (measured 2.4e-6 relative, in nu: the global norm's float32 sums
in another order, over three steps; a bf16 leaf takes the clip's scale
rounded to bf16, which hides that), far inside one bf16 ulp (2^-8).  Matching bit for bit took two changes to the
port's optimizers: JAX's weak type of a Python constant against a bf16
tensor, and its float32 product of the learning rate and a bf16
gradient.
"""
import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import OptimizerConfig as ROptimizerConfig
from repro.optim import optimizers as RO
from repro_torch.configs.base import OptimizerConfig
from repro_torch.models import params as P
from repro_torch.optim import optimizers as O
from test_torch_train_model import check_family
from torch_threads import one_torch_thread  # noqa: F401


@pytest.mark.parametrize("family", ["dense", "qwen3", "moe", "hybrid",
                                    "ssm"])
def test_bf16_loss_and_grads_equal_repro(family):
    check_family(family, param_dtype="bfloat16", leaf_tol=1e-2)


SHAPES = {"a": (64, 32), "b": (128,), "c": (3, 16, 8)}
#: (optimizer, grad_clip, state_dtype): SGD keeps no state
OPT_CASES = [("sgd", c, None) for c in (0.0, 1e-3)] + [
    (n, c, sd) for n, c, sd in itertools.product(
        ("adam", "adamw"), (0.0, 1e-3), (None, "float32", "bfloat16"))]


def _trees(mixed, steps=3, seed=0):
    """repro's params and ``steps`` gradients: every leaf bf16, or with
    leaf "b" float32 (``mixed``, as Qwen3's qk-norm scales)."""
    rng = np.random.default_rng(seed)

    def tree(scale):
        return {k: jnp.asarray(
            rng.standard_normal(s).astype(np.float32) * scale,
            jnp.float32 if mixed and k == "b" else jnp.bfloat16)
            for k, s in SHAPES.items()}
    return tree(0.05), [tree(1e-2) for _ in range(steps)]


def _port(tree):
    return P.from_numpy_tree(jax.tree.map(np.asarray, tree), "cpu")


@pytest.mark.parametrize("mixed", [False, True])
@pytest.mark.parametrize("name,clip,state_dtype", OPT_CASES)
def test_optimizers_on_bf16_trees_equal_repro(name, clip, state_dtype,
                                              mixed):
    kw = dict(name=name, lr=1e-2, schedule="cosine", warmup_steps=1,
              total_steps=5, grad_clip=clip)
    if name == "adamw":
        kw["weight_decay"] = 0.1
    ropt = RO.make_optimizer(ROptimizerConfig(**kw), state_dtype=state_dtype)
    opt = O.make_optimizer(OptimizerConfig(**kw), state_dtype=state_dtype)
    jp, jgs = _trees(mixed)
    tp = _port(jp)
    with jax.disable_jit():
        js, ts = ropt.init(jp), opt.init(tp)
        for jg in jgs:
            ju, js = ropt.update(jg, js, jp)
            jp = RO.apply_updates(jp, ju)
            tu, ts = opt.update(_port(jg), ts, tp)
            tp = O.apply_updates(tp, tu)
    pairs = [(jp, tp)] + ([(js.mu, ts.mu), (js.nu, ts.nu)]
                          if name != "sgd" else [])
    for jt, tt in pairs:
        want, got = dict(P.tree_items(_port(jt))), dict(P.tree_items(tt))
        for k, w in want.items():
            assert got[k].dtype == w.dtype, k
            if w.dtype == torch.bfloat16 or not clip:
                assert torch.equal(got[k], w), k
            else:
                torch.testing.assert_close(
                    got[k], w, rtol=1e-5,
                    atol=1e-6 * float(w.abs().max()))
