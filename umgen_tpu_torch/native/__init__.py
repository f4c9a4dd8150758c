"""The native (C++) collision-matrix helper, loaded through ctypes (port of
umgen_tpu/native/__init__.py).

`collision.cc` is the JAX package's source as it is
(tests/test_torch_native_collision.py holds the two files equal).  `load`
builds it with g++ at first use into umgen_tpu_torch/_build/ (git-ignored),
named by a hash of the source and the flags, so an edited source rebuilds
and an unchanged one is reused; a failed build raises.  There is no
fallback: `ops.collision.collision_matrix` runs the helper, and the numpy
version (`collision_matrix_np`) is reached only by its name.  The helper
serves the host-side metrics (the collision rate over whole decoded scenes,
the collision marks of the pred | GT video), the role numba played in the
reference (ref:plugin/misc/misc.py:181).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path
from typing import Optional

import numpy as np

SOURCE = Path(__file__).resolve().parent / "collision.cc"
BUILD_DIR = Path(__file__).resolve().parents[1] / "_build"
GXX_FLAGS = ("-O3", "-shared", "-fPIC", "-march=native")

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None


def library_path() -> Path:
    h = hashlib.sha256(" ".join(GXX_FLAGS).encode() + SOURCE.read_bytes())
    return BUILD_DIR / f"libumgen_native_{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile the helper with g++ unless this source's library exists
    (written under a temporary name and renamed, so that processes
    building at once each see a whole library)."""
    so = library_path()
    if not so.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
        res = subprocess.run(["g++", *GXX_FLAGS, "-o", str(tmp),
                              str(SOURCE)], capture_output=True, text=True)
        if res.returncode != 0:
            raise RuntimeError(f"g++ failed to build {SOURCE}:\n"
                               f"{res.stderr[-3000:]}")
        os.replace(tmp, so)
    return so


def load() -> ctypes.CDLL:
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            f32p = np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS")
            u8p = np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS")
            lib.umgen_bev_corners.argtypes = [f32p, ctypes.c_int64, f32p]
            lib.umgen_box_collision.argtypes = [f32p, ctypes.c_int64, f32p,
                                                ctypes.c_int64, u8p]
            lib.umgen_collision_matrix.argtypes = [f32p, ctypes.c_int64,
                                                   u8p]
            _lib = lib
        return _lib


def collision_matrix(boxes10: np.ndarray) -> np.ndarray:
    """(N, 10) metric boxes → (N, N) bool collision matrix, the diagonal
    False."""
    boxes10 = np.ascontiguousarray(boxes10, dtype=np.float32)
    n = boxes10.shape[0]
    out = np.zeros((n, n), dtype=np.uint8)
    load().umgen_collision_matrix(boxes10.reshape(n, 10), n, out)
    return out.astype(bool)
