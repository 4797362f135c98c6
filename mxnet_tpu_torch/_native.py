"""Build and load the port's CUDA kernels.

Every kernel lives as CUDA C++ under ``mxnet_tpu_torch/csrc/`` and is
compiled at first use with ``nvcc`` for Hopper (``sm_90a``) into a shared
library with a plain C interface, which is loaded with ``ctypes``. The
library is cached under ``csrc/build/`` (git-ignored), keyed by a hash of
the sources and flags, so an edited source rebuilds and an unchanged one
loads at once. A failed or impossible build raises with the compiler's
output: there is no fallback.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

from .base import MXNetError

__all__ = ["build", "load", "NVCC_FLAGS"]

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = CSRC / "build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v")

_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}
#: compiler output (ptxas register / shared-memory / spill report) of the
#: builds this process ran, by kernel name
build_logs: dict[str, str] = {}


def _nvcc():
    path = shutil.which("nvcc")
    if path is None:
        home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
        cand = Path(home) / "bin" / "nvcc"
        path = str(cand) if cand.exists() else None
    if path is None:
        raise MXNetError("nvcc not found (PATH, $CUDA_HOME/bin, "
                         "/usr/local/cuda/bin): the CUDA kernels are built "
                         "from source at first use")
    return path


def _target(name):
    src = CSRC / f"{name}.cu"
    if not src.exists():
        raise MXNetError(f"no kernel source {src}")
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    h.update(src.read_bytes())
    for hdr in sorted(CSRC.glob("*.cuh")):
        h.update(hdr.read_bytes())
    return src, BUILD_DIR / f"{name}-{h.hexdigest()[:16]}.so"


def build(names):
    """Compile every kernel in ``names`` that has no up-to-date library,
    one ``nvcc`` per source, all started together. Returns
    ``{name: library path}``."""
    out, running = {}, {}
    for name in names:
        src, lib = _target(name)
        out[name] = lib
        if lib.exists():
            continue
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = lib.with_name(f"{lib.name}.{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(src)]
        running[name] = (subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True), tmp, lib)
    failed = []
    for name, (proc, tmp, lib) in running.items():
        log, _ = proc.communicate()
        build_logs[name] = log
        if proc.returncode != 0:
            failed.append(f"nvcc failed for {name} "
                          f"(exit {proc.returncode}):\n{log}")
            continue
        os.replace(tmp, lib)  # atomic: no reader sees a half-written library
    if failed:
        raise MXNetError("\n".join(failed))
    return out


def load(name, bind):
    """The loaded library of kernel ``name`` (built on first use);
    ``bind(lib)`` declares its functions' ``argtypes``/``restype``."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            lib = ctypes.CDLL(str(build([name])[name]))
            bind(lib)
            _libs[name] = lib
        return lib
