"""The port's CUDA kernels against their plain PyTorch versions, on a card.

Every test here is marked `cuda` and skips without a CUDA device: the
kernels have no CPU mode.  The file imports neither jax nor tests/conftest's
JAX set-up, so it runs on a machine without JAX:

    python -m pytest --noconftest -p no:cacheprovider -m cuda \\
        tests/test_torch_cuda.py
"""

import math

import pytest
import torch

from umgen_tpu_torch.ops import decode_kernel as tdk
from umgen_tpu_torch.ops import flash_attention as tfa
from umgen_tpu_torch.params import _Init
from umgen_tpu_torch.runtime.quantize import (pack_decode_weights,
                                              quantize_params_int8)

pytestmark = pytest.mark.cuda


@pytest.fixture()
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    return torch.device("cuda", 0)


@pytest.mark.parametrize("B,Sq,Sk,causal", [
    (1, 2207, 2207, False), (2, 1031, 1031, False), (1, 1031, 2207, True),
    (1, 100, 64, True)])
def test_flash_kernel_matches_plain(cuda_device, B, Sq, Sk, causal):
    # the kernel rounds unnormalized softmax weights to bf16, the plain
    # version normalized ones: ~2^-9.3 of an output before its bf16
    # rounding, so one ulp apart in about a third of the elements.  No
    # element beyond 4 ulps of the largest output, and a mean error within
    # 2^-8 of the mean |ref| (chip_smoke.py checks that these bounds reject
    # a 15% scale error, a dropped key tile and bf16 value sums)
    g = torch.Generator(device=cuda_device).manual_seed(0)
    q, k, v = (torch.randn(B, S, 16, 48, generator=g, device=cuda_device)
               .bfloat16() for S in (Sq, Sk, Sk))
    n0 = tfa.LAUNCHES["flash_attention"]
    out = tfa.flash_attention(q, k, v, causal)
    assert tfa.LAUNCHES["flash_attention"] == n0 + 1
    ref = tfa.flash_attention_plain(q, k, v, causal)
    if Sq > Sk:   # rows before the first key attend nothing: 0
        ref[:, :Sq - Sk] = 0
    d, r = (out.float() - ref.float()).abs(), ref.float().abs()
    assert d.max().item() <= 4 * 2.0 ** -8 * r.max().item()
    assert d.mean().item() <= 2.0 ** -8 * r.mean().item()


@pytest.mark.parametrize("B,Q,cache_len", [(1, 1, 0), (2, 1, 900),
                                           (2, 6, 0), (1, 2, 1030)])
def test_decode_kernel_matches_plain(cuda_device, B, Q, cache_len):
    """One layer at the model's width (d 768, 16 heads of 48): exact int8
    products, the attention's bf16 weights rounded under another blocking
    — a few bf16 ulps of h; the new K/V rows equal up to a rounding tie,
    written in place, the rest of the caches untouched.  A Q = 1 step at
    cache_len 0 attends only to itself and rounds where the plain version
    does: h and the new rows equal bit for bit."""
    g = torch.Generator(device=cuda_device).manual_seed(0)
    oar = _Init(g, cuda_device, torch.bfloat16).block_oar(768, 1)
    packed = pack_decode_weights(quantize_params_int8({"oar": oar})["oar"])
    kv = torch.randint(-100, 101, (2, 1, B, 2208, 768), generator=g,
                       device=cuda_device, dtype=torch.int8)
    x = torch.randn(B, Q, 768, generator=g, device=cuda_device).bfloat16()
    kk, vv = kv[0].clone(), kv[1].clone()
    name = "fused_decode_step_v5" if Q == 1 else "fused_decode_step_v5mq"
    n0 = tdk.LAUNCHES[name]
    h, kk2, vv2 = getattr(tdk, name)(packed, x, kk, vv, cache_len, n_head=16)
    assert tdk.LAUNCHES[name] == n0 + 1
    assert kk2 is kk and vv2 is vv
    ref = tdk.decode_step_plain(packed, x, kv[0], kv[1], cache_len, 16)
    rel = ((h.float() - ref.float()).abs().max()
           / ref.float().abs().max()).item()
    assert math.isfinite(rel) and rel <= 2e-2
    exact = Q == 1 and cache_len == 0
    if exact:
        assert torch.equal(h, ref)
    for got, want in ((kk, kv[0]), (vv, kv[1])):
        new = slice(cache_len, cache_len + Q)
        assert (got[:, :, new].int() - want[:, :, new].int()).abs().max() \
            <= (0 if exact else 1)
        assert torch.equal(got[:, :, :cache_len], want[:, :, :cache_len])
        assert torch.equal(got[:, :, cache_len + Q:],
                           want[:, :, cache_len + Q:])
