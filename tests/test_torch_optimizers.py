"""The port's optimizers (``repro_torch.optim.optimizers``):
``tests/test_optimizers.py``'s cases on the port, and ``update`` against
``repro``'s over a random tree for sgd / adam / adamw x each schedule x
clip on and off, at rtol 1e-6 with an atol of 1e-6 x the leaf's largest
|value| (float32 rounding of the same arithmetic: pow, cos and the
global norm's sum may differ in the last bit, and under the clip Adam
carries one ulp of the norm into an element whose moments nearly
cancel, up to 2e-6 of that element)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import OptimizerConfig as ROptimizerConfig
from repro.optim import optimizers as RO
from repro_torch.configs.base import OptimizerConfig
from repro_torch.optim.optimizers import (adam, apply_updates,
                                          clip_by_global_norm, make_optimizer,
                                          make_schedule, sgd)
from torch_threads import one_torch_thread  # noqa: F401


def t(x):
    return torch.tensor(x, dtype=torch.float32)


def quad_grad(params):
    return {k: 2 * p for k, p in params.items()}   # grad of ||p||^2


def test_sgd_descends_quadratic():
    cfg = OptimizerConfig(name="sgd", lr=0.1, schedule="constant",
                          warmup_steps=0, grad_clip=0.0)
    opt = sgd(cfg)
    params = {"w": t([1.0, -2.0])}
    state = opt.init(params)
    for _ in range(50):
        upd, state = opt.update(quad_grad(params), state, params)
        params = apply_updates(params, upd)
    assert float(torch.linalg.norm(params["w"])) < 1e-3


def test_adam_descends_quadratic():
    cfg = OptimizerConfig(name="adam", lr=0.05, schedule="constant",
                          warmup_steps=0, grad_clip=0.0)
    opt = adam(cfg)
    params = {"w": t([3.0, -1.0])}
    state = opt.init(params)
    for _ in range(200):
        upd, state = opt.update(quad_grad(params), state, params)
        params = apply_updates(params, upd)
    assert float(torch.linalg.norm(params["w"])) < 1e-2


def test_adam_first_step_is_lr_sized():
    cfg = OptimizerConfig(name="adam", lr=0.01, schedule="constant",
                          warmup_steps=0, grad_clip=0.0)
    opt = adam(cfg)
    params = {"w": t([1.0])}
    upd, _ = opt.update({"w": t([1234.5])}, opt.init(params), params)
    np.testing.assert_allclose(abs(float(upd["w"][0])), 0.01, rtol=1e-3)


def test_adamw_weight_decay():
    cfg = OptimizerConfig(name="adamw", lr=0.1, weight_decay=0.5,
                          schedule="constant", warmup_steps=0, grad_clip=0.0)
    opt = make_optimizer(cfg)
    params = {"w": t([10.0])}
    upd, _ = opt.update({"w": t([0.0])}, opt.init(params), params)
    np.testing.assert_allclose(float(upd["w"][0]), -0.5, rtol=1e-5)


def test_adam_state_dtype_override():
    opt = adam(OptimizerConfig(name="adam"), state_dtype="bfloat16")
    state = opt.init({"w": torch.zeros(4)})
    assert state.mu["w"].dtype == torch.bfloat16
    assert state.nu["w"].dtype == torch.bfloat16


def test_clip_by_global_norm():
    grads = {"a": t([3.0]), "b": t([4.0])}
    clipped, norm = clip_by_global_norm(grads, 1.0)
    np.testing.assert_allclose(float(norm), 5.0, rtol=1e-6)
    total = np.hypot(float(clipped["a"][0]), float(clipped["b"][0]))
    np.testing.assert_allclose(total, 1.0, rtol=1e-5)
    small, _ = clip_by_global_norm(grads, 100.0)
    np.testing.assert_allclose(float(small["a"][0]), 3.0, rtol=1e-6)


def test_schedule_warmup_and_cosine():
    s = make_schedule(OptimizerConfig(lr=1.0, warmup_steps=10,
                                      total_steps=110, schedule="cosine"))
    assert float(s(0)) < float(s(5)) < float(s(9))
    np.testing.assert_allclose(float(s(9)), 1.0, rtol=1e-5)
    assert float(s(109)) < 0.01
    assert float(s(20)) > float(s(60)) > float(s(100))


def test_schedule_linear_and_constant():
    lin = make_schedule(OptimizerConfig(lr=2.0, warmup_steps=0,
                                        total_steps=100, schedule="linear"))
    np.testing.assert_allclose(float(lin(50)), 1.0, rtol=0.05)
    const = make_schedule(OptimizerConfig(lr=2.0, warmup_steps=1,
                                          schedule="constant"))
    np.testing.assert_allclose(float(const(1000)), 2.0, rtol=1e-6)


def test_make_optimizer_rejects_unknown():
    with pytest.raises(ValueError):
        make_optimizer(OptimizerConfig(name="lion"))


def _tree(rng, scale):
    return {"a": {"w": (rng.standard_normal((3, 5)) * scale).astype(
        np.float32)},
            "b": (rng.standard_normal((7,)) * scale).astype(np.float32),
            "c": (rng.standard_normal((2, 2, 2)) * scale).astype(np.float32)}


@pytest.mark.parametrize("clip", [0.0, 1.0])
@pytest.mark.parametrize("schedule", ["constant", "linear", "cosine"])
@pytest.mark.parametrize("name", ["sgd", "adam", "adamw"])
def test_update_equals_repro(name, schedule, clip):
    """Five updates from the same params and grads: every update and
    moment within rtol 1e-6 of repro's, atol 1e-6 x the leaf's scale."""
    kw = dict(name=name, lr=0.03, warmup_steps=2, total_steps=6,
              schedule=schedule, grad_clip=clip,
              weight_decay=0.1 if name == "adamw" else 0.0)
    ropt = RO.make_optimizer(ROptimizerConfig(**kw))
    topt = make_optimizer(OptimizerConfig(**kw))
    rng = np.random.default_rng(hash((name, schedule, clip)) % 2**32)
    p_np = _tree(rng, 1.0)
    rp = {k: (jnp.asarray(v) if not isinstance(v, dict) else
              {kk: jnp.asarray(vv) for kk, vv in v.items()})
          for k, v in p_np.items()}
    tp = {k: (torch.from_numpy(v) if not isinstance(v, dict) else
              {kk: torch.from_numpy(vv) for kk, vv in v.items()})
          for k, v in p_np.items()}
    rs, ts = ropt.init(rp), topt.init(tp)
    for step in range(5):
        g_np = _tree(rng, 3.0)
        rg = {k: (jnp.asarray(v) if not isinstance(v, dict) else
                  {kk: jnp.asarray(vv) for kk, vv in v.items()})
              for k, v in g_np.items()}
        tg = {k: (torch.from_numpy(v) if not isinstance(v, dict) else
                  {kk: torch.from_numpy(vv) for kk, vv in v.items()})
              for k, v in g_np.items()}
        ru, rs = ropt.update(rg, rs, rp)
        tu, ts = topt.update(tg, ts, tp)
        for path in (("a", "w"), ("b",), ("c",)):
            def get(tree):
                for k in path:
                    tree = tree[k]
                return tree
            pairs = [(get(tu), get(ru))]
            if name != "sgd":
                pairs += [(get(ts.mu), get(rs.mu)), (get(ts.nu), get(rs.nu))]
            for got, ref in pairs:
                ref = np.asarray(ref)
                np.testing.assert_allclose(
                    got.numpy(), ref, rtol=1e-6,
                    atol=1e-6 * float(np.max(np.abs(ref))))
        rp, tp = RO.apply_updates(rp, ru), apply_updates(tp, tu)
        assert int(ts.step) == int(rs.step) == step + 1


def test_step_and_lr_stay_on_the_params_device():
    opt = adam(OptimizerConfig())
    state = opt.init({"w": torch.zeros(3)})
    assert state.step.dtype == torch.int32 and state.step.dim() == 0
    lr = make_schedule(OptimizerConfig())(state.step)
    assert lr.dtype == torch.float32 and lr.device == state.step.device
