"""Build and load the port's hand-written CUDA kernels.

Each ``csrc/<name>.cu`` is compiled by ``nvcc`` for ``sm_90a`` (Hopper) into
its own shared library with a plain C interface, loaded with :mod:`ctypes`.
The build runs at first use, from the sources in this checkout only, into
``build/kernels/`` at the repository root (listed in ``.gitignore``).  The
library's file name carries a hash of its source and of the flags, so an
edited source is rebuilt and an unchanged one is reused.  :func:`build_all`
starts one ``nvcc`` per source, all at once, and waits for them together.

Nothing here runs at import time: the CPU tests import every module of the
port on a machine without ``nvcc``.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
import tempfile
import threading
from typing import Dict, List, Sequence

__all__ = ["CSRC", "BUILD_DIR", "NVCC_FLAGS", "KERNELS", "build_all", "load"]

CSRC = pathlib.Path(__file__).resolve().parent / "csrc"
BUILD_DIR = pathlib.Path(__file__).resolve().parents[3] / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC")

#: every kernel source of the port: K1 (spmv), K2, K5, K3 and its backward,
#: K4
KERNELS = ("spmv", "cayley_spmv", "rmsnorm", "flash_attention",
           "flash_attention_bwd", "mamba_scan")

_LOCK = threading.Lock()
_LOADED: Dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = pathlib.Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise RuntimeError("nvcc not found: the port's CUDA kernels are built on "
                       "first use and need the CUDA toolkit")


def _library_path(name: str) -> pathlib.Path:
    src = CSRC / f"{name}.cu"
    digest = hashlib.sha256(src.read_bytes() + " ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}_{digest.hexdigest()[:16]}.so"


def build_all(names: Sequence[str] = KERNELS) -> List[pathlib.Path]:
    """Compile every named source that has no up-to-date library, one
    ``nvcc`` process per source, all started together.  Raises with the
    compiler's output if any of them fails."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    outs = [_library_path(n) for n in names]
    jobs = []
    for name, out in zip(names, outs):
        if out.exists():
            continue
        # write under a temporary name, then rename: a concurrent build
        # never loads a half-written library
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, str(CSRC / f"{name}.cu")]
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, text=True)
        jobs.append((name, out, tmp, proc))
    errors = []
    for name, out, tmp, proc in jobs:
        log, _ = proc.communicate()
        if proc.returncode != 0:
            os.unlink(tmp)
            errors.append(f"nvcc failed for {name}.cu (rc {proc.returncode}):"
                          f"\n{log}")
        else:
            os.replace(tmp, out)
    if errors:
        raise RuntimeError("\n".join(errors))
    return outs


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built first if needed."""
    with _LOCK:
        lib = _LOADED.get(name)
        if lib is None:
            (path,) = build_all([name])
            lib = _LOADED[name] = ctypes.CDLL(str(path))
        return lib
