"""Build the port's CUDA sources into shared libraries loaded with ctypes.

Every ``csrc/<name>.cu`` is compiled by its own ``nvcc`` process for
``sm_90a`` into ``build/repro_torch/<name>-<hash>.so`` at the root of the
checkout, where ``<hash>`` covers the source, every ``csrc/*.cuh`` header
and the flags: a changed source or header builds anew, an unchanged one
is loaded as it is.  Stale sources are all compiled at once, one
``nvcc`` each, started together.  Each source exposes a plain C
interface (pointers, sizes and the stream), so no PyTorch header is
compiled.  The build runs at first use, never at import; it raises if
``nvcc`` is missing or a compile fails.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


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


def sources() -> Dict[str, Path]:
    return {p.stem: p for p in sorted(CSRC.glob("*.cu"))}


def library_path(src: Path) -> Path:
    """Where ``src`` builds to: named by a hash of the source, of every
    header in ``csrc`` (any of them may be included) and of the flags."""
    h = hashlib.sha256(src.read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.name.encode() + header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    digest = h.hexdigest()
    return BUILD_DIR / f"{src.stem}-{digest[:16]}.so"


def build_all() -> Dict[str, Path]:
    """Compile every stale source, one ``nvcc`` each, all started
    together; returns the library path of every source.  The compiler's
    output (``-Xptxas -v``: registers, spills) lands beside each library
    as ``<name>-<hash>.log``."""
    stale = [(src, library_path(src)) for src in sources().values()
             if not library_path(src).exists()]
    if stale:
        nvcc = nvcc_path()
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
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
        if failed:
            raise RuntimeError("nvcc failed for " + "\n".join(failed))
    return {name: library_path(src) for name, src in sources().items()}


def build_log(name: str) -> str:
    """The compiler's output for ``csrc/<name>.cu`` (after a build)."""
    return library_path(sources()[name]).with_suffix(".log").read_text()


@functools.lru_cache(maxsize=None)
def load(name: str) -> ctypes.CDLL:
    """The shared library built from ``csrc/<name>.cu`` (built first if
    stale; loaded once per process)."""
    return ctypes.CDLL(str(build_all()[name]))
