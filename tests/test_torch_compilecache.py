"""The port's kernel build cache (``core/compilecache``, ``kernels/_build``)
on the CPU, with a fake ``nvcc``.

* ``default_cache_dir`` reads ``REPRO_CACHE_DIR`` as ``repro``'s does (the
  same "off" values, ``~`` expanded); unset, the port's cache stays in the
  checkout's ``build/repro_torch``.
* A fake ``nvcc`` (a shell script first on ``PATH`` that honours ``-o``
  and ``--version``): a first process builds every ``csrc/*.cu``
  (``misses`` = their count), a second process sharing the cache dir
  builds none and loads them all (``hits``), and another ``--version``
  string builds them all again (the toolkit is in the fingerprint).
* ``REPRO_CACHE_DIR=off`` builds into a temporary directory of the
  process's own, removed when it exits.
"""
import json
import os
import stat
import subprocess
import sys
from pathlib import Path

import pytest
from repro.core import compilecache as JCC

from repro_torch.core import compilecache as TCC
from repro_torch.kernels import _build

SRC = str(Path(__file__).resolve().parents[1] / "src")
N_SOURCES = len(_build.sources())

FAKE_NVCC = """#!/bin/sh
if [ "$1" = "--version" ]; then
  cat "$(dirname "$0")/version"
  exit 0
fi
out=""
while [ $# -gt 0 ]; do
  if [ "$1" = "-o" ]; then out="$2"; shift; fi
  shift
done
echo "ptxas info: fake build"
echo "not a library" > "$out"
"""

#: one process: resolve every library, print the counters and paths
CHILD = """
import json
from repro_torch.core import compilecache
from repro_torch.kernels import _build
paths = _build.build_all()
print(json.dumps({"stats": compilecache.xla_compile_stats(),
                  "dirs": sorted({str(p.parent) for p in paths.values()}),
                  "cache_dir": compilecache.persistent_cache_dir()}))
"""


@pytest.mark.parametrize("value", ["off", "OFF", " none ", "0", "",
                                   "disabled", "false", "~/kernels-here",
                                   "/abs/cache", "rel/cache"])
def test_default_cache_dir_reads_env_as_repro(monkeypatch, value):
    monkeypatch.setenv("REPRO_CACHE_DIR", value)
    assert TCC.ENV_VAR == JCC.ENV_VAR
    assert TCC.default_cache_dir() == JCC.default_cache_dir()


def test_default_cache_dir_unset_is_the_checkout_build(monkeypatch):
    monkeypatch.delenv("REPRO_CACHE_DIR", raising=False)
    want = Path(__file__).resolve().parents[1] / "build" / "repro_torch"
    assert TCC.default_cache_dir() == str(want)


@pytest.fixture()
def fake_nvcc(tmp_path):
    bin_dir = tmp_path / "bin"
    bin_dir.mkdir()
    nvcc = bin_dir / "nvcc"
    nvcc.write_text(FAKE_NVCC)
    nvcc.chmod(nvcc.stat().st_mode | stat.S_IXUSR)
    (bin_dir / "version").write_text("Cuda compilation tools, release 12.9\n")
    return bin_dir


def _child(bin_dir, cache):
    env = dict(os.environ, PYTHONPATH=SRC, REPRO_CACHE_DIR=cache,
               PATH=f"{bin_dir}{os.pathsep}{os.environ.get('PATH', '')}")
    out = subprocess.run([sys.executable, "-c", CHILD], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    return json.loads(out.stdout.strip().splitlines()[-1])


def test_second_process_builds_nothing(fake_nvcc, tmp_path):
    cache = str(tmp_path / "cache")
    first = _child(fake_nvcc, cache)
    assert first["stats"]["misses"] == N_SOURCES == 9
    assert first["stats"]["hits"] == 0
    assert first["stats"]["requests"] == N_SOURCES
    assert first["dirs"] == [str(tmp_path / "cache" / "repro_torch"
                                 / "kernels")]
    assert first["cache_dir"] == cache
    second = _child(fake_nvcc, cache)
    assert second["stats"]["misses"] == 0
    assert second["stats"]["hits"] == N_SOURCES
    assert second["stats"]["exe_hits"] == second["stats"]["exe_stores"] == 0


def test_toolkit_change_rebuilds_everything(fake_nvcc, tmp_path):
    cache = str(tmp_path / "cache")
    assert _child(fake_nvcc, cache)["stats"]["misses"] == N_SOURCES
    (fake_nvcc / "version").write_text(
        "Cuda compilation tools, release 13.0\n")
    again = _child(fake_nvcc, cache)
    assert again["stats"]["misses"] == N_SOURCES
    assert again["stats"]["hits"] == 0
    libs = list((tmp_path / "cache" / "repro_torch" / "kernels").glob(
        "*.so"))
    assert len(libs) == 2 * N_SOURCES


def test_off_builds_into_a_private_temporary_dir(fake_nvcc, tmp_path):
    got = _child(fake_nvcc, "off")
    assert got["cache_dir"] is None
    assert got["stats"]["misses"] == N_SOURCES
    (private,) = got["dirs"]
    assert Path(private).name.startswith("repro_torch-kernels-")
    assert not Path(private).exists()          # removed at exit
    repo = str(Path(__file__).resolve().parents[1])
    assert not private.startswith(repo)


def test_enable_disable_ensure_as_repro(monkeypatch, tmp_path):
    monkeypatch.setattr(TCC, "_state", {"dir": None, "ensured": False,
                                        "private": None})
    monkeypatch.setenv("REPRO_CACHE_DIR", str(tmp_path / "a"))
    assert TCC.ensure_persistent_cache() == str(tmp_path / "a")
    assert TCC.kernel_dir() == tmp_path / "a" / "repro_torch" / "kernels"
    assert TCC.enable_persistent_cache(str(tmp_path / "b")) == str(
        tmp_path / "b")
    assert TCC.ensure_persistent_cache() == str(tmp_path / "b")
    TCC.disable_persistent_cache()
    assert TCC.persistent_cache_dir() is None
    assert TCC.ensure_persistent_cache() is None      # an explicit choice
    monkeypatch.setenv("REPRO_CACHE_DIR", "off")
    assert TCC.enable_persistent_cache() is None


def test_counters_and_reset():
    before = TCC.xla_compile_stats()
    TCC.count_resolution(hit=True)
    TCC.count_resolution(hit=False)
    got = TCC.xla_compile_stats()
    assert got["hits"] - before["hits"] == 1
    assert got["misses"] - before["misses"] == 1
    assert got["requests"] == got["hits"] + got["misses"]
    TCC.reset_xla_compile_stats()
    assert TCC.xla_compile_stats() == {"requests": 0, "hits": 0,
                                       "misses": 0, "exe_hits": 0,
                                       "exe_stores": 0}
    assert set(TCC.xla_compile_stats()) == set(JCC.xla_compile_stats())


def test_fingerprint_covers_the_toolkit(monkeypatch):
    src = next(iter(_build.sources().values()))
    monkeypatch.setattr(_build, "toolkit_version", lambda: "release 12.9")
    before = _build.library_path(src)
    monkeypatch.setattr(_build, "toolkit_version", lambda: "release 13.0")
    assert _build.library_path(src) != before
    monkeypatch.setattr(_build, "toolkit_version", lambda: "release 12.9")
    assert _build.library_path(src) == before
