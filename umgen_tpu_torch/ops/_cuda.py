"""Build the package's CUDA sources and bind them through ctypes.

The sources under umgen_tpu_torch/csrc/ have a plain C interface (no
PyTorch headers), so one `nvcc` call builds them into a shared library in
seconds.  The library is built at first use into umgen_tpu_torch/_build/
(git-ignored), named by a hash of the sources and flags, so an edit to a
source rebuilds it and an unchanged tree reuses it.  Nothing here runs at
import: the CPU tests import every module on machines without nvcc.

Every C entry point launches on the stream it is given and returns
cudaGetLastError(); `check` raises on anything but 0.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Optional, Sequence

import torch

PKG_DIR = Path(__file__).resolve().parents[1]
CSRC_DIR = PKG_DIR / "csrc"
BUILD_DIR = PKG_DIR / "_build"
SOURCES = ("flash_attention.cu", "decode_step.cu")
# --fmad=false keeps the epilogue arithmetic in the order it is written
# (the plain versions round after every multiply and add)
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "--fmad=false", "-Xptxas", "-v", "-shared",
              "-Xcompiler", "-fPIC")

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None

VOIDP = ctypes.c_void_p
INT = ctypes.c_int
INT64 = ctypes.c_longlong
FLOAT = ctypes.c_float


def nvcc_path() -> str:
    cands = []
    if os.environ.get("CUDA_HOME"):
        cands.append(Path(os.environ["CUDA_HOME"]) / "bin" / "nvcc")
    cands.append(Path("/usr/local/cuda/bin/nvcc"))
    for c in cands:
        if c.is_file():
            return str(c)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (set CUDA_HOME): the CUDA "
                           "kernels are built from csrc/ at first use")
    return found


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for name in sorted(p.name for p in CSRC_DIR.iterdir()
                       if p.suffix in (".cu", ".cuh")):
        h.update(name.encode())
        h.update((CSRC_DIR / name).read_bytes())
    return h.hexdigest()[:16]


def library_path() -> Path:
    return BUILD_DIR / f"libumgen_kernels_{_digest()}.so"


def build() -> Path:
    """Compile csrc/*.cu into the shared library unless it exists; the
    compiler's register/spill report goes to build.log beside it."""
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp),
           *[str(CSRC_DIR / s) for s in SOURCES]]
    res = subprocess.run(cmd, capture_output=True, text=True)
    (BUILD_DIR / "build.log").write_text(
        " ".join(cmd) + "\n" + res.stdout + res.stderr)
    if res.returncode != 0:
        raise RuntimeError(f"nvcc failed ({res.returncode}):\n{res.stderr}")
    os.replace(tmp, out)
    return out


def load() -> ctypes.CDLL:
    global _lib
    with _lock:
        if _lib is None:
            _lib = ctypes.CDLL(str(build()))
            _lib.umgen_cuda_error_string.argtypes = [INT]
            _lib.umgen_cuda_error_string.restype = ctypes.c_char_p
        return _lib


def function(name: str, argtypes: Sequence) -> ctypes._CFuncPtr:
    fn = getattr(load(), name)
    fn.argtypes = list(argtypes)
    fn.restype = INT
    return fn


def check(err: int, what: str) -> None:
    if err != 0:
        msg = load().umgen_cuda_error_string(err).decode()
        raise RuntimeError(f"{what}: CUDA error {err} ({msg})")


def stream_ptr(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def require(t: torch.Tensor, dtype: torch.dtype, what: str,
            align: int = 16) -> None:
    """Raise unless `t` is a contiguous CUDA tensor of `dtype` whose data
    pointer is `align`-byte aligned (the kernels load 16-byte vectors)."""
    if not t.is_cuda:
        raise ValueError(f"{what}: expected a CUDA tensor")
    if t.dtype != dtype:
        raise ValueError(f"{what}: expected {dtype}, got {t.dtype}")
    if not t.is_contiguous():
        raise ValueError(f"{what}: expected a contiguous tensor")
    if t.data_ptr() % align:
        raise ValueError(f"{what}: data pointer not {align}-byte aligned")
