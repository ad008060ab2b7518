"""The port's training launcher (``python -m repro_torch.launch.train``)
on the CPU: ``tests/test_system.py``'s four launcher cases with
``--device cpu`` (their output parsed by that file's ``parse_losses``),
and a 3-step run whose losses equal those of an oracle built from
``repro``'s ``loss_fn``, Adam and ``TokenPipeline`` on the same batches
and initial params (rtol 1e-5: float32 sums in another order, carried
through three Adam steps), the final params within rtol 1e-4, atol
1e-5."""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCHS as RARCHS
from repro.configs import OptimizerConfig as ROptimizerConfig
from repro.data.pipeline import TokenPipeline as RPipeline
from repro.models import transformer as RT
from repro.optim.optimizers import apply_updates, make_optimizer
from repro_torch.configs import ARCHS, TolFLConfig
from repro_torch.core import distributed as D
from repro_torch.data.pipeline import TokenPipeline, shard_batch
from repro_torch.launch import train
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.models import params as P
from torch_threads import one_torch_thread  # noqa: F401

BASE = ["--steps", "6", "--batch", "4", "--seq", "64", "--data-axis", "1",
        "--device", "cpu"]


def parse_losses(stdout):
    return [float(l.split("loss")[1].split()[0])
            for l in stdout.splitlines() if l.startswith("step")]


def launch(capsys, *extra):
    assert train.main(BASE + list(extra)) == 0
    return capsys.readouterr().out


def test_train_launcher_runs_and_learns(capsys):
    out = launch(capsys, "--arch", "qwen1.5-0.5b", "--steps", "10")
    losses = parse_losses(out)
    assert len(losses) == 10
    assert all(np.isfinite(losses))
    assert losses[-1] < losses[0]
    assert out.startswith("mesh={'data': 1, 'model': 1} groups=1 clusters=1")


def test_train_launcher_psum_schedule(capsys):
    losses = parse_losses(launch(capsys, "--arch", "granite-3-2b",
                                 "--schedule", "tolfl_psum"))
    assert len(losses) == 6 and all(np.isfinite(losses))


def test_train_launcher_with_failure_injection(capsys):
    out = launch(capsys, "--arch", "qwen1.5-0.5b", "--fail-epoch", "3",
                 "--fail-kind", "server")
    losses = parse_losses(out)
    assert len(losses) == 6 and all(np.isfinite(losses))
    n_eff = [l.split("n_eff=")[1].split()[0] for l in out.splitlines()
             if l.startswith("step")]
    assert n_eff == ["256"] * 3 + ["0"] * 3


def test_train_launcher_checkpointing(capsys, tmp_path):
    launch(capsys, "--arch", "qwen1.5-0.5b", "--steps", "10",
           "--ckpt-dir", str(tmp_path))
    assert os.listdir(tmp_path) == ["ckpt_00000010.msgpack"]


@pytest.mark.parametrize("schedule", ["tolfl_ring", "tolfl_psum"])
def test_step_metrics_hold_no_gradient_buffer(schedule):
    """A step's metrics are tensors of their own: none is a view of the
    flat gradient or broadcast buffer, which a caller holding the metrics
    over the next step would otherwise keep alive (a params-sized float32
    buffer of device memory)."""
    cfg = ARCHS["qwen1.5-0.5b"].reduced()
    ocfg = train.OptimizerConfig()
    mesh = make_host_mesh(data=1, model=1, device="cpu")
    step = D.make_train_step(
        cfg, TolFLConfig(num_clusters=1, schedule=schedule), ocfg, mesh)
    state = D.init_state(torch.Generator().manual_seed(0), cfg, ocfg)
    batch = shard_batch(next(TokenPipeline(cfg.vocab_size, 64, 4)
                             .batches(1)), mesh)
    _, metrics = step(state, batch, torch.ones((1,)))
    assert metrics
    for name, value in metrics.items():
        assert (value.untyped_storage().nbytes()
                == value.numel() * value.element_size()), name


def test_three_steps_equal_the_repro_oracle():
    args = train.parse_args(BASE + ["--arch", "qwen1.5-0.5b", "--steps",
                                    "3"])
    got = train.run(args, log=lambda *_: None)
    cfg = ARCHS["qwen1.5-0.5b"].reduced()
    ocfg = ROptimizerConfig(lr=args.lr, warmup_steps=5, total_steps=3)
    state0 = D.init_state(torch.Generator().manual_seed(0), cfg,
                          train.OptimizerConfig())
    params = jax.tree.map(jnp.asarray, P.to_numpy_tree(state0["params"]))
    rcfg = RARCHS["qwen1.5-0.5b"].reduced()
    opt = make_optimizer(ocfg)
    ostate = opt.init(params)
    vg = jax.jit(jax.value_and_grad(
        lambda p, b: RT.loss_fn(p, rcfg, b)[0]))
    want = []
    for batch in RPipeline(vocab_size=rcfg.vocab_size, seq_len=64,
                           global_batch=4, num_groups=1).batches(3):
        lv, g = vg(params, {k: jnp.asarray(v) for k, v in batch.items()})
        upd, ostate = opt.update(g, ostate, params)
        params = apply_updates(params, upd)
        want.append(float(lv))
    np.testing.assert_allclose(got["losses"], want, rtol=1e-5)
    assert got["n_eff"] == [256.0] * 3
    final = dict(P.tree_items(P.to_numpy_tree(got["state"]["params"])))
    for path, ref in P.tree_items(jax.tree.map(np.asarray, params)):
        # atol 1e-5, 1/30 of one step's lr: Adam turns the rounding noise
        # of an exactly-zero gradient (the k bias under the softmax) into
        # steps of up to lr on both sides
        np.testing.assert_allclose(final[path], ref, rtol=1e-4, atol=1e-5)
