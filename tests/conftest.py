"""Shared fixtures for the Tol-FL test suite.

NOTE: deliberately NO XLA_FLAGS device-count override here — smoke tests
and benches must see the single real CPU device (brief, step 0).  The
multi-device distributed tests spawn subprocesses that set the flag
themselves (tests/test_distributed.py).
"""
import os

import pytest

from repro.configs.autoencoder_paper import AutoencoderConfig
from repro.core import compilecache
from repro.data import commsml, federated


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs an NVIDIA card; skipped without one")


@pytest.fixture(scope="session", autouse=True)
def _hermetic_compile_cache(tmp_path_factory):
    """Point the persistent compilation cache at a per-session temp
    directory so the suite never writes ``~/.cache/repro-jax``.  An
    explicit ``REPRO_CACHE_DIR`` still wins (the cross-process
    disk-cache tests set it in their subprocess env, not here)."""
    if os.environ.get(compilecache.ENV_VAR):
        yield
        return
    compilecache.enable_persistent_cache(
        str(tmp_path_factory.mktemp("repro-jax-cache")))
    yield


@pytest.fixture(scope="session")
def tiny_ae_cfg():
    """Small autoencoder for fast simulator tests."""
    return AutoencoderConfig(input_dim=commsml.N_FEATURES,
                             hidden=(32, 16), code_dim=8, dropout=0.2)


@pytest.fixture(scope="session")
def tiny_commsml():
    """Small Comms-ML draw: (X, y) with 200 samples/class."""
    return commsml.generate(seed=0, samples_per_class=200)


@pytest.fixture(scope="session")
def tiny_split(tiny_commsml):
    """10 devices, 5 clusters, class 3 anomalous."""
    X, y = tiny_commsml
    return federated.make_split(X, y, num_devices=10, num_clusters=5,
                                anomaly_classes=[3], seed=0)


@pytest.fixture(scope="session")
def tiny_padded(tiny_split):
    return federated.pad_devices(tiny_split)
