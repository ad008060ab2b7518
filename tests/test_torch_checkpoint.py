"""The port's checkpoints (``repro_torch.training.checkpoint``):
``tests/test_checkpoint.py``'s cases on the port, its msgpack subset
against the ``msgpack`` package, and files crossing between the
packages: one ``repro`` wrote restored by the port, one the port wrote
restored by ``repro``, bit for bit."""
import os

import jax
import jax.numpy as jnp
import msgpack
import numpy as np
import pytest
import torch

from repro.training import checkpoint as RC
from repro_torch.optim.optimizers import AdamState
from repro_torch.training.checkpoint import (CheckpointManager, packb,
                                             restore, save, tree_leaves,
                                             unpackb)


def make_tree(seed=0):
    g = torch.Generator().manual_seed(seed)
    return {"params": {"w": torch.randn((4, 4), generator=g),
                       "b": torch.zeros(4, dtype=torch.bfloat16)},
            "step": torch.tensor(7, dtype=torch.int32)}


def zeros_like(tree):
    return {"params": {k: torch.zeros_like(v)
                       for k, v in tree["params"].items()},
            "step": torch.zeros_like(tree["step"])}


def trees_equal(a, b):
    la, lb = tree_leaves(a), tree_leaves(b)
    return len(la) == len(lb) and all(
        x.dtype == y.dtype and torch.equal(x, y) for x, y in zip(la, lb))


def test_roundtrip(tmp_path):
    tree = make_tree()
    p = save(str(tmp_path / "ckpt.msgpack"), tree, step=7)
    got, step = restore(p, zeros_like(tree))
    assert step == 7
    assert trees_equal(got, tree)
    assert got["params"]["b"].dtype == torch.bfloat16


def test_restore_shape_mismatch_rejected(tmp_path):
    p = save(str(tmp_path / "c.msgpack"), make_tree())
    bad = {"params": {"w": torch.zeros((2, 2)), "b": torch.zeros(4)},
           "step": torch.zeros((), dtype=torch.int32)}
    with pytest.raises(AssertionError):
        restore(p, bad)


def test_no_tmp_left_behind(tmp_path):
    save(str(tmp_path / "c.msgpack"), make_tree())
    assert sorted(os.listdir(tmp_path)) == ["c.msgpack"]


def test_manager_keep_last_k(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep=2)
    tree = make_tree()
    for s in (1, 2, 3, 4):
        mgr.save(tree, s)
    assert sorted(os.listdir(tmp_path)) == ["ckpt_00000003.msgpack",
                                            "ckpt_00000004.msgpack"]
    assert mgr.latest_step() == 4


def test_manager_restore_latest(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep=3)
    assert mgr.restore_latest(make_tree()) is None
    t2 = make_tree(2)
    mgr.save(make_tree(1), 10)
    mgr.save(t2, 20)
    got, step = mgr.restore_latest(zeros_like(t2))
    assert step == 20
    assert trees_equal(got, t2)


def test_optimizer_state_roundtrip(tmp_path):
    """A NamedTuple state (Adam's) round-trips in jax.tree's leaf order."""
    tree = {"params": {"w": torch.ones(3)},
            "opt": AdamState(torch.tensor(2, dtype=torch.int32),
                             {"w": torch.full((3,), 0.5)},
                             {"w": torch.full((3,), 0.25)}),
            "step": torch.tensor(2, dtype=torch.int32)}
    p = save(str(tmp_path / "s.msgpack"), tree, 2)
    like = {"params": {"w": torch.zeros(3)},
            "opt": AdamState(torch.tensor(0, dtype=torch.int32),
                             {"w": torch.zeros(3)}, {"w": torch.zeros(3)}),
            "step": torch.tensor(0, dtype=torch.int32)}
    got, _ = restore(p, like)
    assert isinstance(got["opt"], AdamState)
    assert trees_equal(got, tree)


@pytest.mark.parametrize("obj", [
    {b"a": [1, 2, -3, 300, 70000, -200, 2 ** 40, -2 ** 40, 127, -32, -33]},
    {b"bin8": b"x" * 200, b"bin16": b"y" * 3000, b"bin32": b"z" * 70000},
    {i: list(range(i)) for i in range(20)},
    [b"", 0, {b"nested": {b"k": [b"v"] * 17}}]])
def test_msgpack_subset_matches_the_package(obj):
    assert packb(obj) == msgpack.packb(obj)
    assert unpackb(msgpack.packb(obj)) == msgpack.unpackb(
        msgpack.packb(obj), strict_map_key=False)


def _repro_tree():
    k = jax.random.PRNGKey(3)
    return {"params": {"w": jax.random.normal(k, (4, 4)),
                       "b": jnp.arange(4, dtype=jnp.bfloat16)},
            "step": jnp.asarray(11, jnp.int32)}


def test_repro_file_restored_by_the_port(tmp_path):
    tree = _repro_tree()
    p = RC.save(str(tmp_path / "r.msgpack"), tree, step=11)
    got, step = restore(p, {"params": {"w": torch.zeros(4, 4),
                                       "b": torch.zeros(4)},
                            "step": torch.zeros((), dtype=torch.int32)})
    assert step == 11
    np.testing.assert_array_equal(got["params"]["w"].numpy(),
                                  np.asarray(tree["params"]["w"]))
    assert got["params"]["b"].dtype == torch.bfloat16
    np.testing.assert_array_equal(got["params"]["b"].float().numpy(),
                                  np.asarray(tree["params"]["b"], np.float32))
    assert int(got["step"]) == 11


def test_port_file_restored_by_repro(tmp_path):
    tree = make_tree(5)
    p = save(str(tmp_path / "t.msgpack"), tree, step=7)
    like = jax.tree.map(jnp.zeros_like, _repro_tree())
    got, step = RC.restore(p, like)
    assert step == 7
    np.testing.assert_array_equal(np.asarray(got["params"]["w"]),
                                  tree["params"]["w"].numpy())
    assert got["params"]["b"].dtype == jnp.bfloat16
    assert int(got["step"]) == 7
