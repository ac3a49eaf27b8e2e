"""Build the port's CUDA kernels with ``nvcc`` at first use and load them.

Each ``csrc/<name>.cu`` exposes a plain C interface (no PyTorch headers,
so a build takes seconds, not minutes) and is compiled for Hopper
(``sm_90a``) into ``_build/<name>-<hash>.so`` beside this package, cached
by the hash of the sources and flags.  The library is loaded with
``ctypes``; every C entry returns ``cudaGetLastError()`` after its launch,
and ``check`` raises on a nonzero code.

Nothing here runs at import time: the CPU tests import every module, and
this machine may have no ``nvcc`` at all.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict, Iterable, List

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[1] / "_build"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_LIBS: Dict[str, ctypes.CDLL] = {}


class KernelBuildError(RuntimeError):
    """``nvcc`` is missing or refused a kernel source."""


def _nvcc() -> str:
    cands = [os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                          "bin", "nvcc"), shutil.which("nvcc")]
    for c in cands:
        if c and os.path.exists(c):
            return c
    raise KernelBuildError("nvcc not found (set CUDA_HOME or put nvcc on "
                           "PATH); the CUDA kernels build only where the "
                           "CUDA toolkit is installed")


def _sources(name: str) -> List[Path]:
    """The kernel's own ``.cu`` plus every shared ``.cuh`` header."""
    return [CSRC / f"{name}.cu"] + sorted(CSRC.glob("*.cuh"))


def _lib_path(name: str) -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in _sources(name):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:16]}.so"


def build(names: Iterable[str]) -> None:
    """Build the named kernels that are not built yet, one ``nvcc`` per
    source, all started together; raises ``KernelBuildError`` if any
    fails."""
    jobs = []
    for name in names:
        out = _lib_path(name)
        if out.exists():
            continue
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-I", str(CSRC), "-o", str(tmp),
               str(CSRC / f"{name}.cu")]
        jobs.append((name, out, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    errors = []
    for name, out, tmp, proc in jobs:
        log, _ = proc.communicate()
        (BUILD_DIR / f"{name}.log").write_text(log)
        if proc.returncode != 0:
            errors.append(f"nvcc failed on {name}.cu (exit {proc.returncode}):"
                          f"\n{log}")
        else:
            os.replace(tmp, out)  # atomic: a concurrent builder sees all or nothing
    if errors:
        raise KernelBuildError("\n".join(errors))


def build_log(name: str) -> str:
    """The compiler's output of the last build of ``name`` (ptxas register
    and shared-memory report), or '' if it was not built here."""
    p = BUILD_DIR / f"{name}.log"
    return p.read_text() if p.exists() else ""


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, built on first use."""
    lib = _LIBS.get(name)
    if lib is None:
        build([name])
        lib = _LIBS[name] = ctypes.CDLL(str(_lib_path(name)))
    return lib


def sass(name: str) -> str:
    """The SASS of the built ``csrc/<name>.cu`` (``cuobjdump
    --dump-sass``), building it first if need be."""
    build([name])
    tool = os.path.join(os.path.dirname(_nvcc()), "cuobjdump")
    out = subprocess.run([tool, "--dump-sass", str(_lib_path(name))],
                         capture_output=True, text=True, check=True)
    return out.stdout


def check(code: int, what: str) -> None:
    """Raise if a C entry returned a nonzero ``cudaError_t``."""
    if code != 0:
        raise RuntimeError(f"CUDA kernel {what} failed to launch: "
                           f"cudaError_t {code}")
