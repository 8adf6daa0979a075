"""Lazy nvcc build and ctypes loader for the port's CUDA kernels.

Each ``ops/csrc/<name>.cu`` compiles on its own into a shared library
with a plain C interface::

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \
         -Xcompiler -fPIC -o ops/_build/lib<name>-<digest>.so ops/csrc/<name>.cu

and is loaded with `ctypes`. The build happens at the first launch on a
CUDA tensor (or in `build_all`), never at import: the CPU tests import
every module on machines without nvcc. The library name carries a digest
of the source and the flags, so an edited source never loads a stale
build (the digest also covers the shared ``csrc/*.cuh`` headers);
`ops/_build/` is listed in .gitignore. A failed build raises —
there is no fallback.

nvcc is found through ``$CUDA_HOME/bin/nvcc``, then ``PATH``, then the
toolkit's default install location.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, Iterable, List

CSRC_DIR = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "_build"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC"]

_LIBS: Dict[str, ctypes.CDLL] = {}
_LOCK = threading.Lock()


def nvcc_path() -> str:
    cands = []
    if os.environ.get("CUDA_HOME"):
        cands.append(os.path.join(os.environ["CUDA_HOME"], "bin", "nvcc"))
    found = shutil.which("nvcc")
    if found:
        cands.append(found)
    cands.append("/usr/local/cuda/bin/nvcc")
    for c in cands:
        if os.path.isfile(c) and os.access(c, os.X_OK):
            return c
    raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH); "
                       "the port's CUDA kernels build at first use")


def _target(name: str) -> Path:
    # the digest covers the source, every shared header and the flags
    src = (CSRC_DIR / f"{name}.cu").read_bytes() + b"".join(
        h.read_bytes() for h in sorted(CSRC_DIR.glob("*.cuh")))
    digest = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"lib{name}-{digest[:16]}.so"


def _start(name: str) -> "tuple[subprocess.Popen, Path, Path]":
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    out = _target(name)
    tmp = out.with_suffix(f".{os.getpid()}.{threading.get_ident()}.tmp")
    cmd = [nvcc_path(), *NVCC_FLAGS, "-Xptxas", "-v", "-o", str(tmp),
           str(CSRC_DIR / f"{name}.cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return proc, tmp, out


def _finish(name: str, proc: subprocess.Popen, tmp: Path, out: Path) -> str:
    log, _ = proc.communicate()
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed for {name}.cu "
                           f"(exit {proc.returncode}):\n{log}")
    os.replace(tmp, out)  # atomic: a concurrent loader sees all or nothing
    return log


def build_all(names: Iterable[str]) -> Dict[str, str]:
    """Compile every named source that is not built yet, one nvcc per
    source, all started together. Returns ``{name: nvcc log}`` for the
    sources it compiled (the log holds ``-Xptxas -v``'s register and
    shared-memory report)."""
    started: List = []
    for name in names:
        if not _target(name).exists():
            started.append((name, *_start(name)))
    return {name: _finish(name, proc, tmp, out)
            for name, proc, tmp, out in started}


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``ops/csrc/<name>.cu``, building it first
    when needed."""
    with _LOCK:
        lib = _LIBS.get(name)
        if lib is None:
            build_all([name])
            lib = ctypes.CDLL(str(_target(name)))
            _LIBS[name] = lib
        return lib
