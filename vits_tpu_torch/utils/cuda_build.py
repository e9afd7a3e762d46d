"""Builds the port's CUDA kernels from the sources in the checkout at first
use: `nvcc` for sm_90a into a shared library with a plain C interface,
loaded with ctypes. Libraries go to `build/vits_tpu_torch/` at the repo root,
named by a hash of their source and flags, so a rebuilt source never loads a
stale library. Nothing is built or imported when this module is imported."""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from typing import Dict, List, Optional

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(_PKG), "build", "vits_tpu_torch")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}
build_log: Dict[str, str] = {}  # source name -> nvcc/ptxas output of its build


class LaunchCounter:
    """Kernel launches made through a wrapper (reset and read by callers),
    and what the wrapper records of its last launch (`last`, or None)."""

    def __init__(self):
        self.launches = 0
        self.last = None


def nvcc_path() -> str:
    cand = [os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc"),
            shutil.which("nvcc") or ""]
    for c in cand:
        if c and os.path.exists(c):
            return c
    raise RuntimeError("nvcc not found (set CUDA_HOME); the port's kernels are "
                       "built from source on the machine with the GPU")


def _target(source: str) -> str:
    path = os.path.join(CSRC, source)
    with open(path, "rb") as f:
        digest = hashlib.sha256(f.read() + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    stem = os.path.splitext(source)[0]
    return os.path.join(BUILD_DIR, f"lib{stem}-{digest}.so")


def _start(source: str) -> Optional[subprocess.Popen]:
    out = _target(source)
    if os.path.exists(out):
        return None
    os.makedirs(BUILD_DIR, exist_ok=True)
    cmd = [nvcc_path(), *NVCC_FLAGS, "-o", out + ".tmp", os.path.join(CSRC, source)]
    return subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)


def _finish(source: str, proc: Optional[subprocess.Popen]):
    if proc is None:
        return
    log, _ = proc.communicate()
    build_log[source] = log
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on {source} (exit {proc.returncode}):\n{log}")
    os.replace(_target(source) + ".tmp", _target(source))


def build_all(sources: List[str]):
    """Compile every source at once (one nvcc each, all started together)."""
    with _lock:
        procs = [(s, _start(s)) for s in sources]
        for s, p in procs:
            _finish(s, p)


def load(source: str) -> ctypes.CDLL:
    """The loaded library of `csrc/<source>`, built first if needed."""
    with _lock:
        lib = _libs.get(source)
        if lib is None:
            _finish(source, _start(source))
            lib = ctypes.CDLL(_target(source))
            _libs[source] = lib
        return lib
