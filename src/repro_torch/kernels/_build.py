"""Build the port's CUDA sources into shared libraries loaded with ctypes.

Every ``csrc/<name>.cu`` is compiled by its own ``nvcc`` process for
``sm_90a`` into ``<dir>/<name>-<hash>.so``, where ``<dir>`` is the kernel
directory of :mod:`repro_torch.core.compilecache` (``build/repro_torch/``
at the root of the checkout unless ``REPRO_CACHE_DIR`` says otherwise)
and ``<hash>`` covers the source, every ``csrc/*.cuh`` header, the flags
and the toolkit (``nvcc --version``): a changed source, header or
toolkit builds anew, an unchanged one is loaded as it is.  Stale sources
are all compiled at once, one ``nvcc`` each, started together; each
writes to a file of its own process and renames it into place, so
processes that share the directory never read a half-written library.
Each source exposes a plain C interface (pointers, sizes and the
stream), so no PyTorch header is compiled.  The build runs at first use,
never at import; it raises if ``nvcc`` is missing or a compile fails.

Each library a process resolves counts once in
``compilecache.xla_compile_stats()``: a hit when it was on disk, a miss
when ``nvcc`` built it.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict, Tuple

from repro_torch.core import compilecache

CSRC = Path(__file__).resolve().parent.parent / "csrc"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

#: library path -> how this process resolved it ("disk" or "compiled")
_RESOLVED: Dict[Path, str] = {}


def nvcc_path() -> str:
    """``nvcc`` on PATH, else under ``$CUDA_HOME`` (default
    ``/usr/local/cuda``); raises if neither has it."""
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if cand.is_file():
        return str(cand)
    raise RuntimeError("nvcc not found on PATH or under CUDA_HOME: the "
                       "CUDA kernels of repro_torch cannot be built")


@functools.lru_cache(maxsize=None)
def _nvcc_version(nvcc: str) -> str:
    return subprocess.run([nvcc, "--version"], capture_output=True,
                          text=True, check=True, timeout=60).stdout


def toolkit_version() -> str:
    """``nvcc --version``'s output, or "" where there is no ``nvcc`` (a
    stale library then fails to build, and a library on disk was built
    by a toolkit this machine does not have, so it reads as stale)."""
    try:
        nvcc = nvcc_path()
    except RuntimeError:
        return ""
    return _nvcc_version(nvcc)


def sources() -> Dict[str, Path]:
    return {p.stem: p for p in sorted(CSRC.glob("*.cu"))}


def library_path(src: Path) -> Path:
    """Where ``src`` builds to: named by a hash of the source, of every
    header in ``csrc`` (any of them may be included), of the flags and of
    the toolkit's version."""
    h = hashlib.sha256(src.read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.name.encode() + header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    h.update(toolkit_version().encode())
    digest = h.hexdigest()
    return compilecache.kernel_dir() / f"{src.stem}-{digest[:16]}.so"


def build_all() -> Dict[str, Path]:
    """Compile every stale source, one ``nvcc`` each, all started
    together; returns the library path of every source and counts each
    library this process had not resolved yet.  The compiler's output
    (``-Xptxas -v``: registers, spills) lands beside each library as
    ``<name>-<hash>.log``."""
    paths = {name: library_path(src) for name, src in sources().items()}
    stale = [(sources()[name], out) for name, out in paths.items()
             if not out.exists()]
    if stale:
        nvcc = nvcc_path()
        stale[0][1].parent.mkdir(parents=True, exist_ok=True)
        procs = []
        for src, out in stale:
            tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
            procs.append((src, out, tmp, subprocess.Popen(
                [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(src)],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True)))
        failed = []
        for src, out, tmp, proc in procs:
            log, _ = proc.communicate()
            out.with_suffix(".log").write_text(log)
            if proc.returncode != 0:
                failed.append(f"{src.name} (exit {proc.returncode}):\n{log}")
            else:
                os.replace(tmp, out)
                if out not in _RESOLVED:
                    _RESOLVED[out] = "compiled"
                    compilecache.count_resolution(hit=False)
        if failed:
            raise RuntimeError("nvcc failed for " + "\n".join(failed))
    for out in paths.values():
        if out not in _RESOLVED:
            _RESOLVED[out] = "disk"
            compilecache.count_resolution(hit=True)
    return paths


def resolve() -> Tuple[str, float]:
    """Resolve and load every library now: ``(source, seconds)``, where
    ``source`` is ``"compiled"`` if ``nvcc`` ran, else ``"disk"`` if a
    library was read from the cache directory, else ``"memory"`` (all
    were loaded already), and ``seconds`` the wall time of the builds and
    loads."""
    t0 = time.perf_counter()
    before = dict(_RESOLVED)
    loaded = load.cache_info().currsize
    for name in build_all():
        load(name)
    new = [src for path, src in _RESOLVED.items() if path not in before]
    source = ("compiled" if "compiled" in new else
              "disk" if new or load.cache_info().currsize > loaded
              else "memory")
    return source, time.perf_counter() - t0


def clear() -> None:
    """Forget the libraries this process resolved and loaded: the next
    use reads them from the cache directory again (the loaded ones stay
    mapped: ctypes cannot unload a library)."""
    _RESOLVED.clear()
    load.cache_clear()


def build_log(name: str) -> str:
    """The compiler's output for ``csrc/<name>.cu`` (after a build)."""
    return library_path(sources()[name]).with_suffix(".log").read_text()


@functools.lru_cache(maxsize=None)
def load(name: str) -> ctypes.CDLL:
    """The shared library built from ``csrc/<name>.cu`` (built first if
    stale; loaded once per process)."""
    return ctypes.CDLL(str(build_all()[name]))
