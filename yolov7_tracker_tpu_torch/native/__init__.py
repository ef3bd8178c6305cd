"""Native (C++) host components of the port: the port's own copies of the
JAX package's ``native/`` sources, built with g++ at first use and bound
with ctypes.

* ``FrameLoader`` (frameloader.cpp): decodes a sequence's images ahead of
  the consumer on a pool of C++ threads into an in-order bounded ring, as
  the reference's DataLoader workers do (tracker/track.py:130). It needs
  OpenCV's C++ headers and libraries; where they are missing (the card's
  machine has no OpenCV), the loader decodes with cv2 on the caller's
  thread, as the JAX package's does, and says so once on stderr.
* ``lapjv`` (lapjv.cpp): the exact Jonker-Volgenant solve of the
  cost-limit problem on the host (lap.lapjv(extend_cost=True,
  cost_limit=thresh)). It raises if it cannot be built.

The libraries go into the package's gitignored ``_build/``, named by the
hash of their source and flags, never into the package tree.
"""

from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import subprocess
import sys
import warnings
from typing import Optional, Tuple

import numpy as np

from ..ops.cuda_build import BUILD_DIR

_HERE = os.path.dirname(os.path.abspath(__file__))
# the distro's opencv4 layout, as the JAX package builds it
OPENCV_FLAGS = ("-I/usr/include/opencv4", "-lopencv_imgcodecs",
                "-lopencv_core")
_LIBS = {}


def build(source_name: str, flags: Tuple[str, ...] = ()) -> ctypes.CDLL:
    """Compile ``native/<source_name>`` with g++ into ``_build/`` (once per
    source and flags; a file lock keeps two processes from building it
    twice) and load it. Raises RuntimeError with g++'s output on
    failure."""
    if source_name in _LIBS:
        return _LIBS[source_name]
    source = os.path.join(_HERE, source_name)
    with open(source, "rb") as f:
        digest = hashlib.sha256(
            f.read() + " ".join(flags).encode()).hexdigest()[:16]
    os.makedirs(BUILD_DIR, exist_ok=True)
    stem = os.path.splitext(source_name)[0]
    so = os.path.join(BUILD_DIR, f"lib{stem}_{digest}.so")
    with open(so + ".lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if not os.path.isfile(so):
            tmp = so + ".tmp"
            cmd = ["g++", "-O3", "-shared", "-fPIC", "-pthread", "-o", tmp,
                   source, *flags]
            try:
                proc = subprocess.run(cmd, capture_output=True, text=True)
            except OSError as e:
                raise RuntimeError(f"g++ cannot run: {e}") from e
            if proc.returncode != 0:
                raise RuntimeError(
                    f"g++ failed ({proc.returncode}) on {source_name}:\n"
                    f"{proc.stderr}")
            os.replace(tmp, so)
    lib = ctypes.CDLL(so)
    _LIBS[source_name] = lib
    return lib


# ---------------------------------------------------------------------------
# lapjv: exact JV with a cost limit (lapjv.cpp)
# ---------------------------------------------------------------------------

def _lapjv_lib() -> ctypes.CDLL:
    lib = build("lapjv.cpp")
    lib.lapjv_cost_limit.argtypes = [
        ctypes.c_int, ctypes.c_int,
        np.ctypeslib.ndpointer(np.float64, flags="C_CONTIGUOUS"),
        ctypes.c_double,
        np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS"),
        np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS"),
    ]
    lib.lapjv_cost_limit.restype = ctypes.c_int
    return lib


def available() -> bool:
    """Whether the lapjv library builds and loads here."""
    try:
        _lapjv_lib()
    except (RuntimeError, OSError):
        return False
    return True


def lapjv(cost: np.ndarray, thresh: float) -> Tuple[np.ndarray, np.ndarray]:
    """Exact assignment with cost-limit gating on the host: (row_to_col,
    col_to_row) int32 arrays, -1 where unmatched, the semantics of
    ops.assignment.linear_assignment_host. Raises RuntimeError if the
    library cannot be built."""
    cost = np.ascontiguousarray(cost, np.float64)
    n, m = cost.shape
    r2c = np.empty(n, np.int32)
    c2r = np.empty(m, np.int32)
    _lapjv_lib().lapjv_cost_limit(n, m, cost, float(thresh), r2c, c2r)
    return r2c, c2r


# ---------------------------------------------------------------------------
# FrameLoader: multithreaded decode + prefetch (frameloader.cpp)
# ---------------------------------------------------------------------------

_FL_FAILED = None       # why the frameloader did not build, once known


def _fl_lib() -> Optional[ctypes.CDLL]:
    """The frameloader library, or None (said once on stderr) where it
    cannot be built, e.g. without OpenCV's headers."""
    global _FL_FAILED
    if _FL_FAILED is not None:
        return None
    try:
        lib = build("frameloader.cpp", OPENCV_FLAGS)
    except (RuntimeError, OSError) as e:
        _FL_FAILED = str(e).splitlines()[0]
        print("native: the frame loader cannot be built "
              f"({_FL_FAILED}); frames decode with cv2 on the caller's "
              "thread", file=sys.stderr)
        return None
    lib.fl_open.argtypes = [
        ctypes.POINTER(ctypes.c_char_p), ctypes.c_int, ctypes.c_int,
        ctypes.c_int,
    ]
    lib.fl_open.restype = ctypes.c_void_p
    lib.fl_next.argtypes = [
        ctypes.c_void_p,
        np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS"),
        ctypes.c_long,
        np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS"),
    ]
    lib.fl_next.restype = ctypes.c_int
    lib.fl_close.argtypes = [ctypes.c_void_p]
    lib.fl_close.restype = None
    return lib


def frameloader_available() -> bool:
    """Whether the frame loader decodes on its native pool here."""
    return _fl_lib() is not None


class FrameLoader:
    """In-order multithreaded frame decoder: iterates BGR uint8 HWC arrays
    for a list of image paths (cv2.imread's contract), decoded ahead on
    ``n_threads`` C++ workers into a ring of ``capacity`` frames. Iterate
    once, or use as a context manager. An unreadable image raises OSError
    (``on_error="raise"``) or warns and is left out (``"skip"``). Where
    the native library cannot be built, it decodes with cv2 on the
    caller's thread."""

    def __init__(self, paths, n_threads: int = 4, capacity: int = 8,
                 max_hw: Tuple[int, int] = (2176, 4096),
                 on_error: str = "raise"):
        # max_hw only sizes the first staging buffer: a larger frame stays
        # in the ring (fl_next returns -2 with its size) and the buffer grows
        if on_error not in ("raise", "skip"):
            raise ValueError(
                f"on_error must be 'raise' or 'skip': {on_error!r}")
        self.on_error = on_error
        self.paths = list(paths)
        self._lib = _fl_lib()
        self._h = None
        self._max_bytes = max_hw[0] * max_hw[1] * 3
        if self._lib is not None and self.paths:
            arr = (ctypes.c_char_p * len(self.paths))(
                *[os.fsencode(p) for p in self.paths])
            self._h = self._lib.fl_open(arr, len(self.paths), int(n_threads),
                                        int(capacity))

    def _unreadable(self, path):
        if self.on_error == "skip":
            warnings.warn(f"skipping unreadable frame {path}")
            return
        raise OSError(f"cannot read frame {path}")

    def __iter__(self):
        if self._h is None:
            yield from self._iter_cv2()
            return
        buf = np.empty(self._max_bytes, np.uint8)
        hw = np.zeros(2, np.int32)
        consumed = 0
        try:
            while True:
                rc = self._lib.fl_next(self._h, buf, self._max_bytes, hw)
                if rc == -2:
                    # larger than the staging buffer: still in the ring
                    self._max_bytes = int(hw[0]) * int(hw[1]) * 3
                    buf = np.empty(self._max_bytes, np.uint8)
                    rc = self._lib.fl_next(self._h, buf, self._max_bytes, hw)
                if rc == -1:
                    return
                if rc == -3:
                    self._unreadable(self.paths[consumed])
                    consumed += 1
                    continue
                if rc < 0:
                    raise RuntimeError(f"frame loader returned {rc}")
                consumed += 1
                h, w = int(hw[0]), int(hw[1])
                yield buf[: h * w * 3].reshape(h, w, 3).copy()
        finally:
            self.close()

    def _iter_cv2(self):
        import cv2

        for path in self.paths:
            img = cv2.imread(path)
            if img is None:
                self._unreadable(path)
                continue
            yield img

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False

    def close(self):
        if self._h is not None:
            self._lib.fl_close(self._h)
            self._h = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass
