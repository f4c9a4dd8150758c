"""The exact-erf GELU as one CUDA kernel (csrc/gelu.cu).

Replaces no TPU kernel: the JAX package's `jax.nn.gelu(approximate=False)`
is an XLA fusion.  Its plain PyTorch version, `models.modules._gelu_plain`
(XLA's float32 erfc in eager ops, 75 device passes over the activation),
stays the function's definition and serves CPU tensors; the kernel computes
it in one pass, bit for bit on every bf16, fp16 and float32 input (see the
source's header).

`gelu(x)` takes any bf16, fp16 or float32 CUDA tensor: a view is made
contiguous, and a tensor whose data starts off a 16-byte boundary copied,
before the launch (the kernel loads 16-byte vectors).  It raises for a CPU
tensor, for another dtype, and for an input that requires a gradient while
autograd records (the kernel has no backward; `models.modules.gelu` sends
those to `_GeluFn`).
"""

from __future__ import annotations

import torch

from umgen_tpu_torch.ops import _cuda

# launches of the CUDA kernel; reset by callers that want to see which
# kernels a run went through
LAUNCHES = {"gelu": 0}
# umgen_gelu(x, y, n, dtype, stream), as csrc/gelu.cu declares it
ARGTYPES = [_cuda.VOIDP, _cuda.VOIDP, _cuda.INT64, _cuda.INT, _cuda.VOIDP]
# the C entry's dtype codes
DTYPES = {torch.bfloat16: 0, torch.float16: 1, torch.float32: 2}


def gelu(x: torch.Tensor) -> torch.Tensor:
    """0.5·x·erfc(-x/√2) of a bf16, fp16 or float32 CUDA tensor, rounded as
    `modules._gelu_plain` rounds it, into a new contiguous tensor of x's
    shape."""
    _cuda.refuse_autograd("gelu", x)
    if x.dtype not in DTYPES:
        raise ValueError(f"gelu: expected one of {list(DTYPES)}, got "
                         f"{x.dtype}")
    if not x.is_cuda:
        raise ValueError("gelu: expected a CUDA tensor")
    x = x.contiguous()
    if x.data_ptr() % 16:
        x = x.clone()
    y = torch.empty_like(x)
    if x.numel():
        fn = _cuda.function("umgen_gelu", ARGTYPES)
        _cuda.check(fn(x.data_ptr(), y.data_ptr(), x.numel(),
                       DTYPES[x.dtype], _cuda.stream_ptr(x)), "gelu")
        LAUNCHES["gelu"] += 1
    return y
