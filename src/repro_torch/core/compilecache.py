"""Where the port's compiled work lives across processes, and what it cost.

Port of ``repro.core.compilecache``.  What ``repro`` compiles is XLA
programs; what the port compiles is its CUDA kernel libraries: each
``csrc/*.cu`` is built by ``nvcc`` into a shared library at first use
(:mod:`repro_torch.kernels._build`).  That build is the port's cold-start
cost, and this module points it at a directory that outlives the
process, so a second process loads the libraries instead of running
``nvcc``.  The names are ``repro``'s, which ``repro_torch.api`` exports;
each docstring says what it means here.

Environment:

``REPRO_CACHE_DIR``
    The cache directory, read as ``repro`` reads it: ``~`` expanded, and
    the values ``off`` / ``none`` / ``0`` / ``disabled`` / ``false`` /
    empty turn the cache off.  Set, the port's libraries go to
    ``<dir>/repro_torch/kernels/``, apart from JAX's entries at the
    directory's root and in ``executables/``.  Unset, they stay in
    ``build/repro_torch/`` at the root of the checkout.  Off, each
    process builds into a temporary directory of its own, removed when
    it exits.

The scoring service's CUDA graphs are not cached on disk: a graph holds
the device addresses of the tensors it captured and cannot be written
out, so ``exe_hits`` and ``exe_stores`` stay 0.
"""
from __future__ import annotations

import atexit
import os
import shutil
import tempfile
import threading
from pathlib import Path
from typing import Dict, Optional

ENV_VAR = "REPRO_CACHE_DIR"
_OFF_VALUES = {"", "0", "off", "none", "disabled", "false"}
#: the kernels' directory when ``REPRO_CACHE_DIR`` is unset
CHECKOUT_BUILD = str(Path(__file__).resolve().parents[3] / "build"
                     / "repro_torch")

_lock = threading.Lock()
_counts = {"hits": 0, "misses": 0}
_state: Dict[str, Optional[object]] = {"dir": None, "ensured": False,
                                        "private": None}


def default_cache_dir() -> Optional[str]:
    """``REPRO_CACHE_DIR`` (``off``-like values: None, the cache off), or
    ``build/repro_torch`` at the root of the checkout when it is unset."""
    env = os.environ.get(ENV_VAR)
    if env is not None:
        if env.strip().lower() in _OFF_VALUES:
            return None
        return os.path.abspath(os.path.expanduser(env))
    return CHECKOUT_BUILD


def enable_persistent_cache(path: Optional[str] = None) -> Optional[str]:
    """Build and load the kernel libraries under ``path`` (default:
    :func:`default_cache_dir`); returns the directory in use, or None when
    ``REPRO_CACHE_DIR`` turns the cache off."""
    path = default_cache_dir() if path is None else os.path.abspath(
        os.path.expanduser(path))
    if path is not None:
        _state["dir"] = path
    return path


def disable_persistent_cache() -> None:
    """Turn the cache off for this process: libraries not resolved yet
    build into a temporary directory of the process's own."""
    _state["dir"] = None
    _state["ensured"] = True   # an explicit choice: ensure() stays out


def ensure_persistent_cache() -> Optional[str]:
    """The first kernel resolution of a process lands here: it enables
    the default directory, unless ``REPRO_CACHE_DIR`` turns the cache off
    or an earlier :func:`enable_persistent_cache` /
    :func:`disable_persistent_cache` call chose otherwise."""
    if _state["ensured"] or _state["dir"] is not None:
        return _state["dir"]
    _state["ensured"] = True
    return enable_persistent_cache()


def persistent_cache_dir() -> Optional[str]:
    """The directory currently in use, or None while the cache is off."""
    return _state["dir"]


def kernel_dir() -> Path:
    """Where the kernel libraries are built and loaded from now (see the
    module docstring)."""
    root = ensure_persistent_cache()
    if root is None:
        if _state["private"] is None:
            private = tempfile.mkdtemp(prefix="repro_torch-kernels-")
            atexit.register(shutil.rmtree, private, ignore_errors=True)
            _state["private"] = private
        return Path(_state["private"])
    if root == CHECKOUT_BUILD:
        return Path(root)
    return Path(root) / "repro_torch" / "kernels"


def count_resolution(hit: bool) -> None:
    """One kernel library resolved in this process: loaded from the cache
    directory (``hit``) or built by ``nvcc`` first."""
    with _lock:
        _counts["hits" if hit else "misses"] += 1


def xla_compile_stats() -> Dict[str, int]:
    """The port's compile counters since process start (or the last
    :func:`reset_xla_compile_stats`), under ``repro``'s keys: ``requests``
    = kernel libraries resolved, ``hits`` = loaded from the cache
    directory, ``misses`` = actually built by ``nvcc``.  A library counts
    once a process (again after ``campaign.clear_executable_caches``), so
    a warm cache reads ``misses == 0``.  ``exe_hits`` / ``exe_stores`` are
    0: the port stores no executable on disk (see the module docstring)."""
    with _lock:
        c = dict(_counts)
    return {"requests": c["hits"] + c["misses"], "hits": c["hits"],
            "misses": c["misses"], "exe_hits": 0, "exe_stores": 0}


def reset_xla_compile_stats() -> None:
    """Zero every counter behind :func:`xla_compile_stats`."""
    with _lock:
        for k in _counts:
            _counts[k] = 0
