"""The port's logical sharding (``repro_torch.sharding.logical``) and
logical-axes trees against ``repro``'s, on the host.

``repro``'s ``spec_for`` reads only a mesh's ``axis_names`` and the shape
of its ``devices``, so it runs here on a stub mesh of (16, 16),
(2, 16, 16), (4, 2) or (2, 2) devices; the port's takes a ``HostMesh`` of
the same shape (no process group: a DeviceMesh is made only when a
layout is asked for).  Every leaf of every assigned architecture's
params, Adam state and decode caches is compared under both rule sets,
plus random axes tuples and shapes under hypothesis.  The axes trees are
compared whole.  ``repro``'s trees come from ``jax.eval_shape`` of its
init at full width (no allocation), once an architecture.
"""
import functools

import jax
import numpy as np
import pytest
import torch
from hypothesis_compat import given, settings, st

from repro.configs import ARCHS as R_ARCHS
from repro.configs import ASSIGNED, OptimizerConfig as ROptimizerConfig
from repro.core import distributed as RD
from repro.models import params as RP
from repro.serving.decode import cache_logical_axes as r_cache_axes
from repro.serving.decode import cache_shape as r_cache_shape
from repro.sharding import logical as RL
from repro_torch.configs import ARCHS, INPUT_SHAPES, OptimizerConfig
from repro_torch.core import distributed as D
from repro_torch.launch.mesh import HostMesh
from repro_torch.models import params as P
from repro_torch.serving import decode as TD
from repro_torch.sharding import logical as L

MESHES = {"16x16": (("data", "model"), (16, 16)),
          "2x16x16": (("pod", "data", "model"), (2, 16, 16)),
          "4x2": (("data", "model"), (4, 2)),
          "2x2": (("data", "model"), (2, 2))}
MODES = ("replicated_data", "fsdp")
#: (batch, seq, long_context) of the two decode shapes
CACHES = ((INPUT_SHAPES["decode_32k"].global_batch,
           INPUT_SHAPES["decode_32k"].seq_len, False),
          (INPUT_SHAPES["long_500k"].global_batch,
           INPUT_SHAPES["long_500k"].seq_len, True))


class _StubMesh:
    """What ``repro``'s spec_for reads of a jax mesh."""

    def __init__(self, names, shape):
        self.axis_names = names
        self.devices = np.empty(shape, dtype=object)


def _meshes(name):
    names, shape = MESHES[name]
    return (_StubMesh(names, shape),
            HostMesh(names, shape, 0, torch.device("cpu")))


def _tree_leaves(tree, is_leaf=None):
    """{path: leaf} of a nested dict / NamedTuple tree."""
    out = {}

    def rec(t, path):
        if is_leaf is not None and is_leaf(t):
            out[path] = t
        elif isinstance(t, dict):
            for k, v in t.items():
                rec(v, path + (k,))
        elif isinstance(t, tuple) and hasattr(t, "_fields"):
            for k, v in zip(t._fields, t):
                rec(v, path + (k,))
        elif t is not None:
            out[path] = t
    rec(tree, ())
    return out


@functools.lru_cache(maxsize=None)
def _repro_state_axes(arch):
    """repro's state_logical_axes (its params_logical_axes inside), once
    an architecture: Maverick's init traces in ~7 s."""
    return RD.state_logical_axes(R_ARCHS[arch], ROptimizerConfig())


@functools.lru_cache(maxsize=None)
def _leaves(arch):
    """(axes, shape) of every leaf of the arch's params, Adam state and
    both decode caches, the axes ``repro``'s and the shapes the port's
    meta init gives."""
    cfg = ARCHS[arch]
    ocfg = OptimizerConfig()
    axes = _tree_leaves(_repro_state_axes(arch), is_leaf=RP.is_axes_leaf)
    shapes = _tree_leaves(D.state_shapes(cfg, ocfg))
    out = [(axes[p], tuple(s.shape)) for p, s in shapes.items()]
    for b, s, long_ctx in CACHES:
        cs = TD.cache_shape(cfg, b, s, long_ctx)
        ca = dict(P.tree_items(TD.cache_logical_axes(cs)))
        out += [(ca[p], tuple(x.shape)) for p, x in P.tree_items(cs)]
    return out


def test_rules_for_equals_repro():
    for mode in MODES:
        assert L.rules_for(mode) == RL.rules_for(mode)
    assert L.BASE_RULES == RL.BASE_RULES
    assert L.FSDP_RULES == RL.FSDP_RULES


@pytest.mark.parametrize("arch", ASSIGNED)
def test_params_logical_axes_equal_repro(arch):
    got = _tree_leaves(D.params_logical_axes(ARCHS[arch]),
                       is_leaf=P.is_axes_leaf)
    want = _tree_leaves(_repro_state_axes(arch)["params"],
                        is_leaf=RP.is_axes_leaf)
    assert got == want


@pytest.mark.parametrize("arch", ASSIGNED)
def test_state_and_cache_logical_axes_equal_repro(arch):
    got = _tree_leaves(D.state_logical_axes(ARCHS[arch], OptimizerConfig()),
                       is_leaf=P.is_axes_leaf)
    want = _tree_leaves(_repro_state_axes(arch), is_leaf=RP.is_axes_leaf)
    assert got == want
    for b, s, long_ctx in CACHES:
        rc = r_cache_axes(r_cache_shape(R_ARCHS[arch], b, s, long_ctx))
        want = {tuple(k.key for k in path): v for path, v in
                jax.tree_util.tree_flatten_with_path(
                    rc, is_leaf=RP.is_axes_leaf)[0]}
        got = dict(P.tree_items(TD.cache_logical_axes(
            TD.cache_shape(ARCHS[arch], b, s, long_ctx))))
        assert got == want


@pytest.mark.parametrize("arch", ASSIGNED)
def test_spec_for_equals_repro_on_every_leaf(arch):
    """Every leaf of the params, the Adam state and both decode caches,
    on every mesh, under both rule sets: entry for entry."""
    n = 0
    for mesh_name in MESHES:
        rmesh, tmesh = _meshes(mesh_name)
        for mode in MODES:
            rules = L.rules_for(mode)
            for ax, shape in _leaves(arch):
                want = tuple(RL.spec_for(ax, shape, rules, rmesh))
                got = L.spec_for(ax, shape, rules, tmesh)
                assert isinstance(got, L.PartitionSpec)
                assert tuple(got) == want, (ax, shape, mesh_name, mode)
                n += 1
    assert n > 100


AXES = st.sampled_from([None] + sorted(L.BASE_RULES))


DIMS = st.sampled_from([1, 2, 3, 4, 6, 8, 16, 20, 32, 40, 64, 512, 1000])


@settings(max_examples=200, deadline=None)
@given(n=st.integers(0, 4), a0=AXES, a1=AXES, a2=AXES, a3=AXES, d0=DIMS,
       d1=DIMS, d2=DIMS, d3=DIMS, mesh_name=st.sampled_from(sorted(MESHES)),
       mode=st.sampled_from(MODES), with_shape=st.booleans())
def test_spec_for_equals_repro_hypothesis(n, a0, a1, a2, a3, d0, d1, d2, d3,
                                          mesh_name, mode, with_shape):
    rmesh, tmesh = _meshes(mesh_name)
    axes = (a0, a1, a2, a3)[:n]
    shape = (d0, d1, d2, d3)[:n] if with_shape else None
    rules = L.rules_for(mode)
    assert tuple(L.spec_for(axes, shape, rules, tmesh)) == \
        tuple(RL.spec_for(axes, shape, rules, rmesh))


def test_spec_for_without_mesh_is_empty():
    assert tuple(L.spec_for(("batch", "embed"), (8, 16))) == ()


def test_constrain_is_the_identity_without_a_mesh():
    x = torch.randn(4, 8, 16)
    assert L.current_mesh() is None
    assert L.constrain(x, ("batch", "seq", "embed")) is x
    assert L.constrain(x, ("batch", "seq", "ff")) is x


def test_activate_mesh_and_manual_axes_nest():
    _, m1 = _meshes("4x2")
    _, m2 = _meshes("2x2")
    with L.activate_mesh(m1, L.rules_for("fsdp")):
        assert L.current_mesh() is m1
        assert L.current_rules() is L.FSDP_RULES
        with L.activate_mesh(m2):
            assert L.current_mesh() is m2
            assert L.current_rules() == L.BASE_RULES
            with L.manual_axes(("data",)):
                assert L.current_manual() == frozenset({"data"})
            assert L.current_manual() == frozenset()
        assert L.current_mesh() is m1
    assert L.current_mesh() is None
    assert L.mesh_axis_sizes(m1) == {"data": 4, "model": 2}


def test_placements_map_one_to_one():
    from torch.distributed.tensor import Replicate, Shard
    spec = L.PartitionSpec(("pod", "data"), None, "model")
    assert L.placements_for(spec, ("pod", "data", "model")) == (
        Shard(0), Shard(0), Shard(2))
    assert L.placements_for(L.PartitionSpec(None, "model"),
                            ("data", "model")) == (Replicate(), Shard(1))


def test_host_mesh_groups_count_pod_and_data():
    """Ranks that differ only in their model index are one federated
    group: rank = group x model + model index."""
    for r in range(8):
        m = HostMesh(("data", "model"), (4, 2), r, torch.device("cpu"))
        assert (m.group, m.model_index, m.num_groups) == (r // 2, r % 2, 4)
    m = HostMesh(("pod", "data", "model"), (2, 16, 16), 300,
                 torch.device("cpu"))
    assert (m.group, m.model_index, m.num_groups) == (18, 12, 32)
