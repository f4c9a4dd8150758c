"""Build the package's CUDA sources and bind them through ctypes.

The sources under umgen_tpu_torch/csrc/ have a plain C interface (no
PyTorch headers).  Each is compiled to an object with its own flags (one
`nvcc` a source, all started together), and the objects are linked into
one shared library, in seconds.  The library is built at first use into
umgen_tpu_torch/_build/ (git-ignored), named by a hash of the sources and
every source's flags, so an edit to a source or a flag rebuilds it and an
unchanged tree reuses it.  Nothing here runs at import: the CPU tests
import every module on machines without nvcc.

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
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xptxas", "-v", "-Xcompiler", "-fPIC")
# each source with the flags it adds to NVCC_FLAGS.  decode_step.cu and
# gelu.cu: --fmad=false keeps the arithmetic in the order it is written (the
# plain versions round after every multiply and add).  flash_attention.cu
# rounds where no plain version can follow a contraction anyway (bf16
# products in the tensor cores), so it lets the compiler fuse.
SOURCES = {"flash_attention.cu": (),
           "decode_step.cu": ("--fmad=false",),
           "gelu.cu": ("--fmad=false",)}

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
    for name, flags in sorted(SOURCES.items()):
        h.update(f"{name}: {' '.join(flags)}\n".encode())
    for name in sorted(p.name for p in CSRC_DIR.iterdir()
                       if p.suffix in (".cu", ".cuh")):
        h.update(name.encode())
        h.update((CSRC_DIR / name).read_bytes())
    return h.hexdigest()[:16]


def library_path() -> Path:
    return BUILD_DIR / f"libumgen_kernels_{_digest()}.so"


def build() -> Path:
    """Compile each source of SOURCES to an object with its own flags (the
    compilers run side by side), link the objects into the shared library,
    unless it exists; the compilers' register/spill reports go to build.log
    beside it."""
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = nvcc_path()
    tag = f"{os.getpid()}.tmp"
    jobs = []
    for name, flags in SOURCES.items():
        obj = BUILD_DIR / f"{Path(name).stem}.{tag}.o"
        cmd = [nvcc, *NVCC_FLAGS, *flags, "-c", "-o", str(obj),
               str(CSRC_DIR / name)]
        # each compiler reports into a file of its own: pipes read one
        # after another could fill and stall the other compiler
        report = obj.with_suffix(".log")
        with open(report, "w") as f:
            proc = subprocess.Popen(cmd, stdout=f, stderr=subprocess.STDOUT)
        jobs.append((cmd, obj, report, proc))
    log, failed = [], []
    for cmd, _, report, proc in jobs:
        proc.wait()
        text = report.read_text()
        report.unlink()
        log.append(" ".join(cmd) + "\n" + text)
        if proc.returncode != 0:
            failed.append(f"{cmd[-1]} ({proc.returncode}):\n{text}")
    tmp = out.with_suffix(f".{tag}")
    if not failed:
        cmd = [nvcc, "-shared", "-o", str(tmp), *[str(j[1]) for j in jobs]]
        res = subprocess.run(cmd, capture_output=True, text=True)
        log.append(" ".join(cmd) + "\n" + res.stdout + res.stderr)
        if res.returncode != 0:
            failed.append(f"link ({res.returncode}):\n{res.stderr}")
    for job in jobs:
        job[1].unlink(missing_ok=True)
    (BUILD_DIR / "build.log").write_text("\n".join(log))
    if failed:
        raise RuntimeError("nvcc failed: " + "\n".join(failed))
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


def _tensors(x):
    if isinstance(x, torch.Tensor):
        yield x
    elif isinstance(x, dict):
        for v in x.values():
            yield from _tensors(v)
    elif isinstance(x, (list, tuple)):
        for v in x:
            yield from _tensors(v)


def refuse_autograd(what: str, *inputs) -> None:
    """Raise where autograd is recording and an input (a tensor, or a tree
    of them) requires a gradient: the kernels are launched on raw pointers
    and have no backward, so autograd could not see them and the gradient
    through them would be silently dropped.  Checked before the device is:
    the plain versions of CPU tensors refuse alike."""
    if torch.is_grad_enabled() and any(
            t.requires_grad for x in inputs for t in _tensors(x)):
        raise RuntimeError(
            f"{what}: an input requires a gradient, and the kernel has no "
            "backward; train on the plain PyTorch path "
            "(use_pallas_attention=False, no fused decode), or call it "
            "under torch.no_grad()")
