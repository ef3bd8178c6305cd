"""Build a CUDA source of csrc/ with nvcc and bind it with ctypes.

Each kernel file has a plain C interface, so nvcc builds it in seconds
and nothing links against PyTorch. The shared library goes into
``_build/`` beside the package (gitignored), named by the source's hash,
at first use; a file lock per library keeps concurrent processes from
building it twice while different libraries build side by side.
"""

from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import shutil
import subprocess
import time
from typing import NamedTuple

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "_build")


class Built(NamedTuple):
    lib: ctypes.CDLL
    seconds: float      # wall time of this call (build or cache hit)
    log: str            # nvcc's -Xptxas -v report; "" on a cache hit


def nvcc() -> str:
    for cand in (shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.isfile(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def build_library(source_name: str, defines: tuple = ()) -> Built:
    """Compile ``csrc/<source_name>`` for sm_90a (no multiply-add
    contraction: the kernels are bit-exact against their plain versions)
    and load it. ``defines`` are passed to nvcc as ``-D<name>`` and are part
    of the cached library's name, so a build with a define never stands in
    for the build without it. Raises RuntimeError with nvcc's output on
    failure."""
    source = os.path.join(CSRC_DIR, source_name)
    with open(source, "rb") as f:
        digest = hashlib.sha256(
            f.read() + " ".join(defines).encode()).hexdigest()[:16]
    os.makedirs(BUILD_DIR, exist_ok=True)
    stem = os.path.splitext(source_name)[0]
    so = os.path.join(BUILD_DIR, f"lib{stem}_{digest}.so")
    log = ""
    t0 = time.time()
    with open(so + ".lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if not os.path.isfile(so):
            tmp = so + ".tmp"
            cmd = [nvcc(), "-gencode", "arch=compute_90a,code=sm_90a",
                   "-std=c++17", "-O3", "-fmad=false", "-Xptxas", "-v",
                   "-shared", "-Xcompiler", "-fPIC",
                   *(f"-D{d}" for d in defines), "-o", tmp, source]
            proc = subprocess.run(cmd, capture_output=True, text=True)
            if proc.returncode != 0:
                raise RuntimeError(
                    f"nvcc failed ({proc.returncode}):\n{proc.stderr}")
            log = proc.stderr
            os.replace(tmp, so)
    return Built(ctypes.CDLL(so), time.time() - t0, log)
