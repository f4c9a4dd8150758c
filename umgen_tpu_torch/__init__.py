"""umgen_tpu_torch — the PyTorch / CUDA port of umgen_tpu for NVIDIA Hopper.

The JAX package (`umgen_tpu`) stays the reference; this package mirrors its
module layout so each module's counterpart is found by path:

    umgen_tpu/models/modules.py   ->  umgen_tpu_torch/models/modules.py
    umgen_tpu/ops/flash_attention ->  umgen_tpu_torch/ops/flash_attention.py
    ...

It imports `torch`, never `jax`, and nothing of the JAX package: it keeps its
own copies of the framework-free numpy modules it needs (`config.py`,
`layout.py`, `data/*`, `ops/metrics.py`, `tools/load_control_tokens.py`,
each its counterpart with only the imports rewritten).  The TPU's Pallas
kernels on the slice's path are hand-written CUDA kernels (`csrc/*.cu`,
built with nvcc for sm_90a at first use and bound through ctypes); every
kernel wrapper keeps a plain PyTorch version beside it, which serves CPU
tensors and the tests.

TF32 is switched off for float32 matmuls and cuDNN convolutions at import:
the reference computes float32 products in full float32, and a TF32 product
keeps only ~3 decimal digits.
"""

import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

__version__ = "0.1.0"
__all__ = ["__version__"]
