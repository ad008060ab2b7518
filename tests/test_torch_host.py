"""Port parity for the host-side numpy modules, and the port's import
boundary.

The port keeps its own copies of ``repro``'s pure-numpy modules (data
generation, federated split, topology, AUROC), so their arrays must be
BYTE-identical to ``repro``'s for the same seeds.
"""
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from repro.core import topology as jtopo
from repro.data import commsml as jcommsml
from repro.data import federated as jfed
from repro.training import metrics as jmetrics
from repro_torch.core import topology as ttopo
from repro_torch.data import commsml as tcommsml
from repro_torch.data import federated as tfed
from repro_torch.training import metrics as tmetrics

REPO = Path(__file__).resolve().parents[1]


def _same_bytes(a, b):
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype and a.shape == b.shape, (a.dtype, b.dtype,
                                                       a.shape, b.shape)
    assert a.tobytes() == b.tobytes()


@pytest.mark.parametrize("seed,spc", [(0, 50), (3, 120)])
def test_commsml_generate_byte_identical(seed, spc):
    xa, ya = jcommsml.generate(seed=seed, samples_per_class=spc)
    xb, yb = tcommsml.generate(seed=seed, samples_per_class=spc)
    _same_bytes(xa, xb)
    _same_bytes(ya, yb)


@pytest.mark.parametrize("n,k,anom,seed", [(10, 5, [3], 0), (6, 2, [3], 1),
                                           (8, 4, [2, 3], 2), (4, 1, [0], 0)])
def test_make_split_and_pad_byte_identical(n, k, anom, seed):
    X, y = jcommsml.generate(seed=0, samples_per_class=60)
    a = jfed.make_split(X, y, n, k, anom, seed=seed)
    b = tfed.make_split(X, y, n, k, anom, seed=seed)
    assert a.clusters == b.clusters
    assert len(a.device_data) == len(b.device_data)
    for da, db in zip(a.device_data, b.device_data):
        _same_bytes(da, db)
    _same_bytes(a.test_x, b.test_x)
    _same_bytes(a.test_y, b.test_y)
    _same_bytes(a.sample_counts(), b.sample_counts())
    for xa, xb in zip(jfed.pad_devices(a), tfed.pad_devices(b)):
        _same_bytes(xa, xb)


@pytest.mark.parametrize("n,k", [(10, 5), (10, 1), (10, 10), (12, 3), (1, 1)])
def test_topology_arrays_identical(n, k):
    a, b = jtopo.Topology(n, k), ttopo.Topology(n, k)
    assert a.clusters == b.clusters
    assert a.heads == b.heads
    assert a.members_per_cluster == b.members_per_cluster
    _same_bytes(a.device_cluster_array(), b.device_cluster_array())
    _same_bytes(a.head_mask(), b.head_mask())
    for d in range(n):
        assert a.cluster_of(d) == b.cluster_of(d)
        assert a.is_head(d) == b.is_head(d)
    sa, sb = jtopo.special_cases(n), ttopo.special_cases(n)
    assert {key: (t.num_devices, t.num_clusters) for key, t in sa.items()} \
        == {key: (t.num_devices, t.num_clusters) for key, t in sb.items()}


@pytest.mark.parametrize("ties", [False, True])
def test_auroc_identical(ties):
    rng = np.random.default_rng(7)
    scores = rng.standard_normal((6, 300)).astype(np.float32)
    if ties:
        scores = np.round(scores, 1)     # many tied ranks
    labels = (rng.random(300) < 0.3).astype(np.int32)
    for row in scores:
        assert jmetrics.auroc(row, labels) == tmetrics.auroc(row, labels)
    _same_bytes(jmetrics.auroc_batch(scores, labels),
                tmetrics.auroc_batch(scores, labels))
    for xa, xb in zip(jmetrics.roc_curve(scores[0], labels),
                      tmetrics.roc_curve(scores[0], labels)):
        _same_bytes(xa, xb)


def test_reconstruction_error_matches():
    import jax.numpy as jnp
    import torch
    rng = np.random.default_rng(8)
    x = rng.standard_normal((9, 4, 5)).astype(np.float32)
    xh = rng.standard_normal((9, 4, 5)).astype(np.float32)
    want = np.asarray(jmetrics.reconstruction_error(jnp.asarray(x),
                                                    jnp.asarray(xh)))
    got = tmetrics.reconstruction_error(torch.from_numpy(x),
                                        torch.from_numpy(xh)).numpy()
    # float32 sums of 20 squares in another order: rtol 1e-6
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)


_POISONED_IMPORT = """
import importlib, pkgutil, sys
sys.modules["jax"] = None
sys.modules["repro"] = None
import repro_torch
names = [m.name for m in pkgutil.walk_packages(repro_torch.__path__,
                                               "repro_torch.")]
for name in names:
    importlib.import_module(name)
import chip_smoke
print(len(names))
"""


def test_port_imports_without_jax_or_repro():
    """Every module of the port, and chip_smoke.py, imports with ``jax``
    and ``repro`` made unimportable; chip_smoke's body does not run on
    import."""
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join([str(REPO / "src"), str(REPO)])
    out = subprocess.run([sys.executable, "-c", _POISONED_IMPORT], env=env,
                         cwd=str(REPO), capture_output=True, text=True,
                         timeout=120)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.strip().splitlines()[-1]) >= 15, out.stdout


def test_port_sources_name_no_jax_import():
    """The no-runtime-link rule, read off the sources."""
    import re
    pat = re.compile(r"^\s*(import|from)\s+(jax|repro)\b", re.M)
    files = sorted((REPO / "src" / "repro_torch").rglob("*.py"))
    files.append(REPO / "chip_smoke.py")
    for f in files:
        assert not pat.search(f.read_text()), f
