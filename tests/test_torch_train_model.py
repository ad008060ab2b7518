"""The zoo's training forward (``repro_torch.models.transformer``'s
``loss_fn``) against ``repro``'s under ``jax.value_and_grad``, one tiny
float32 config per family (each arch's ``reduced()``: dense, moe,
hybrid, ssm, audio, vlm; the recurrent and encoder-decoder families in
``test_torch_train_model_rec.py``, which imports :func:`check_family`)
with ``repro``'s params carried over; remat on equal to remat off;
``grad_bf16_boundary``.

Bounds: the loss within rtol 2e-6; each gradient leaf within 5e-4 x its
own largest |value| + 1e-5 x the largest |value| of any leaf (float32
sums in another order; the second term covers leaves whose exact
gradient is 0, such as a key bias under the softmax, which both sides
give as rounding noise)."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCHS as RARCHS
from repro.models import params as RP
from repro.models import transformer as RT
from repro_torch.configs import ARCHS
from repro_torch.models import params as P
from repro_torch.models import transformer as T
from torch_threads import one_torch_thread  # noqa: F401

FAMILIES = {"dense": "qwen1.5-0.5b", "moe": "llama4-scout-17b-a16e",
            "hybrid": "recurrentgemma-9b", "ssm": "rwkv6-7b",
            "audio": "whisper-large-v3", "vlm": "internvl2-26b",
            "qwen3": "qwen3-8b"}


def _batch(cfg, seed=0, B=2, S=16):
    rng = np.random.default_rng(seed)
    b = {"tokens": rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32),
         "labels": rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)}
    if cfg.frontend.kind == "vision":
        b["prefix"] = rng.standard_normal((B, 4, cfg.d_model)).astype(
            np.float32)
    if cfg.is_encdec:
        b["frames"] = rng.standard_normal((B, 8, cfg.d_model)).astype(
            np.float32)
    return b


def _torch_batch(b):
    return {k: torch.from_numpy(v).long() if v.dtype == np.int32
            else torch.from_numpy(v) for k, v in b.items()}


def _loss_and_grads(params, cfg, batch):
    leaves = {path: x.clone().requires_grad_(True)
              for path, x in P.tree_items(params)}
    total, aux = T.loss_fn(P.tree_from_items(leaves.items()), cfg, batch)
    total.backward()
    return total.detach(), aux, {path: x.grad for path, x in leaves.items()}


def check_family(family, param_dtype="float32", leaf_tol=5e-4):
    """loss_fn's value, aux and every gradient leaf vs repro's, with the
    params at ``param_dtype``: each gradient in its leaf's dtype, within
    ``leaf_tol`` x its own largest |value| + 1e-5 x the largest of any
    leaf."""
    arch = FAMILIES[family]
    rcfg, cfg = (dataclasses.replace(c[arch].reduced(),
                                     param_dtype=param_dtype)
                 for c in (RARCHS, ARCHS))
    params, _ = RT.init_params(jax.random.PRNGKey(0), rcfg)
    batch = _batch(rcfg)
    (rl, rm), rg = jax.jit(jax.value_and_grad(
        lambda p, b: RT.loss_fn(p, rcfg, b), has_aux=True))(
            params, {k: jnp.asarray(v) for k, v in batch.items()})
    tl, tm, tg = _loss_and_grads(
        P.from_numpy_tree(jax.tree.map(np.asarray, params), "cpu"), cfg,
        _torch_batch(batch))
    np.testing.assert_allclose(float(tl), float(rl), rtol=2e-6)
    np.testing.assert_allclose(float(tm["moe_aux"]), float(rm["moe_aux"]),
                               rtol=2e-6, atol=1e-9)
    ref = dict(P.tree_items(jax.tree.map(np.asarray, rg)))
    assert ref.keys() == tg.keys()
    ref = {k: r.astype(np.float32) for k, r in ref.items()}
    top = max(float(np.max(np.abs(r))) for r in ref.values())
    leaves = dict(P.tree_items(jax.tree.map(np.asarray, params)))
    for path, r in ref.items():
        g = tg[path]
        assert g is not None, path
        assert str(g.dtype).split(".")[-1] == leaves[path].dtype.name, path
        bound = leaf_tol * float(np.max(np.abs(r))) + 1e-5 * top
        assert float(np.max(np.abs(g.float().numpy() - r))) <= bound, path


@pytest.mark.parametrize("family", ["dense", "moe", "vlm"])
def test_loss_and_grads_equal_repro(family):
    check_family(family)


@pytest.mark.parametrize("family", ["dense", "hybrid", "audio"])
def test_remat_equals_no_remat(family):
    """torch.utils.checkpoint recomputes the same numbers: the loss and
    every gradient bit for bit."""
    cfg = ARCHS[FAMILIES[family]].reduced()
    params = T.init_params(torch.Generator().manual_seed(0), cfg, "cpu")
    batch = _torch_batch(_batch(cfg, seed=1))
    outs = [_loss_and_grads(params, dataclasses.replace(cfg, remat=r),
                            batch) for r in ("none", "full")]
    assert torch.equal(outs[0][0], outs[1][0])
    for path, g in outs[0][2].items():
        assert torch.equal(g, outs[1][2][path]), path


def test_vlm_loss_covers_text_positions_only():
    cfg = ARCHS["internvl2-26b"].reduced()
    params = T.init_params(torch.Generator().manual_seed(0), cfg, "cpu")
    batch = _torch_batch(_batch(cfg))
    h, _ = T.forward_train(params, cfg, batch)
    assert h.shape[1] == 4 + 16
    want = T.xent_loss(params, cfg, h[:, 4:], batch["labels"])
    assert torch.equal(T.loss_fn(params, cfg, batch)[1]["xent"], want)


def test_xent_loss_masks_padded_vocab_and_rows():
    cfg = dataclasses.replace(ARCHS["qwen1.5-0.5b"].reduced(),
                              vocab_size=1000)
    assert T.padded_vocab(cfg) == 1024
    params = T.init_params(torch.Generator().manual_seed(0), cfg, "cpu")
    g = torch.Generator().manual_seed(1)
    h = torch.randn((2, 8, cfg.d_model), generator=g)
    labels = torch.randint(0, 1000, (2, 8), generator=g)
    mask = torch.zeros(2, 8)
    mask[0] = 1.0
    logits = T.logits_fn(params, cfg, h[:1])[..., :1000]
    want = torch.mean(torch.logsumexp(logits, -1)
                      - torch.gather(logits, -1, labels[:1, :, None])[..., 0])
    got = T.xent_loss(params, cfg, h, labels, mask, chunk=4)
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6)
    assert float(T.xent_loss(params, cfg, h, labels, torch.zeros(2, 8))) == 0


def test_grad_bf16_boundary_equals_repro():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((5, 7)).astype(np.float32)
    c = rng.standard_normal((5, 7)).astype(np.float32)
    ref = jax.grad(lambda a: jnp.sum(RP.grad_bf16_boundary(a) * c))(x)
    tx = torch.from_numpy(x).requires_grad_(True)
    y = P.grad_bf16_boundary(tx)
    assert torch.equal(y.detach(), tx.detach())
    (y * torch.from_numpy(c)).sum().backward()
    np.testing.assert_array_equal(tx.grad.numpy(), np.asarray(ref))
    assert not np.array_equal(tx.grad.numpy(), c)


def test_tree_helpers_equal_repro():
    rng = np.random.default_rng(0)
    tree = {"a": rng.standard_normal((3, 4)).astype(np.float32),
            "b": {"c": rng.standard_normal((5,)).astype(np.float32)}}
    ttree = P.from_numpy_tree(tree, "cpu")
    np.testing.assert_allclose(float(P.global_norm(ttree)),
                               float(RP.global_norm(tree)), rtol=1e-6)
    z = P.tree_zeros_like(ttree)
    assert all(torch.equal(v, torch.zeros_like(v))
               for _, v in P.tree_items(z))
    cast = P.cast_tree(ttree, torch.bfloat16)
    assert all(v.dtype == torch.bfloat16 for _, v in P.tree_items(cast))
