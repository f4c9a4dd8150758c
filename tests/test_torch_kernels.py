"""The port's kernel modules against the JAX package's TPU kernels.

On the CPU the port's wrappers run their kernels' plain PyTorch versions;
the JAX kernels run in Pallas interpret mode, as tests/test_flash_attention.py
and tests/test_decode_kernel.py run them.  The CUDA kernels themselves are
held against the plain versions in tests/test_torch_cuda.py, on a card.
"""

import functools as ft

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from umgen_tpu.config import ModelConfig
from umgen_tpu.models import modules as jnn
from umgen_tpu.models.rollout import Rollout as JRollout
from umgen_tpu.models.umgen import UMGen as JUMGen
from umgen_tpu.ops import decode_kernel as jdk
from umgen_tpu.ops import flash_attention as jfa
from umgen_tpu.runtime.quantize import quantize_params_int8 as j_quantize
from umgen_tpu_torch.models.rollout import Rollout
from umgen_tpu_torch.models.umgen import UMGen
from umgen_tpu_torch.ops import attention as tattn
from umgen_tpu_torch.ops import decode_kernel as tdk
from umgen_tpu_torch.ops import flash_attention as tfa
from umgen_tpu_torch.params import from_jax
from umgen_tpu_torch.runtime.quantize import pack_decode_weights, pack_fused


@pytest.fixture()
def interpret(monkeypatch):
    for mod in (jfa, jdk):
        monkeypatch.setattr(mod.pl, "pallas_call",
                            ft.partial(pl.pallas_call, interpret=True))


def _t(a, dtype=None):
    t = torch.tensor(np.asarray(jnp.asarray(a, jnp.float32)))
    return t.to(dtype) if dtype is not None else t


def _f32(a):
    if isinstance(a, torch.Tensor):
        return a.float().numpy()
    return np.asarray(jnp.asarray(a, jnp.float32))


# ---------------------------------------------------------------------------
# flash attention
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("causal,Sq,Sk", [
    (False, 256, 256), (False, 552, 552), (True, 256, 256),
    (True, 128, 384)])
def test_flash_plain_matches_jax(interpret, causal, Sq, Sk):
    # float32: both compute float32 logits, softmax and value sums; they
    # differ only in summation order (the JAX kernel's own test bound)
    B, H, Dh = 2, 2, 48
    rng = np.random.default_rng(0)
    q, k, v = (rng.normal(0, 1, (B, S, H, Dh)).astype(np.float32)
               for S in (Sq, Sk, Sk))
    ref = jfa.flash_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                              causal=causal, block_q=128)
    out = tfa.flash_attention(torch.tensor(q), torch.tensor(k),
                              torch.tensor(v), causal)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=2e-5,
                               rtol=2e-5)


def test_flash_plain_matches_jax_bf16(interpret):
    # bf16: the softmax weights and the output round to bf16 on both sides;
    # a rounding boundary between the two float32 sums moves an output by
    # one bf16 ulp (2^-8 relative, |o| < 2 here)
    B, H, Dh, S = 1, 4, 48, 640
    rng = np.random.default_rng(1)
    q, k, v = (jnp.asarray(rng.normal(0, 1, (B, S, H, Dh)), jnp.bfloat16)
               for _ in range(3))
    ref = _f32(jfa.flash_attention(q, k, v, causal=False))
    out = _f32(tfa.flash_attention(_t(q, torch.bfloat16),
                                   _t(k, torch.bfloat16),
                                   _t(v, torch.bfloat16), False))
    assert np.abs(out - ref).max() <= 2 * 2.0 ** -8 * 2
    assert np.mean(out != ref) < 0.01


def test_attention_dispatch_rule():
    """Sk >= 512 goes to flash_attention, shorter keys to sdpa; CPU tensors
    run the plain version and launch nothing."""
    calls = []
    real = tattn.flash_attention
    try:
        tattn.flash_attention = lambda *a, **kw: (calls.append(1),
                                                  real(*a, **kw))[1]
        for Sk, n in ((511, 0), (512, 1)):
            x = torch.randn(1, Sk, 2, 48)
            tattn.attn_impl(x, x, x, causal=False)
            assert len(calls) == n
    finally:
        tattn.flash_attention = real
    assert tfa.LAUNCHES["flash_attention"] == 0


# ---------------------------------------------------------------------------
# fused decode step (v5 / v5mq)
# ---------------------------------------------------------------------------
def _decode_setup(L=2, B=2, S=1104, seed=0):
    cfg = ModelConfig().scaled("tiny").replace(n_oar_layer=L)
    d, H = cfg.n_embd, cfg.n_head
    params = {"oar": jnn.init_stack(jax.random.PRNGKey(seed), L,
                                    jnn.init_block_oar, d, cfg.bias,
                                    jnp.bfloat16),
              "ln_oar": jnn.init_layernorm(d, jnp.bfloat16)}
    rng = np.random.default_rng(seed)
    # non-trivial layer norms and biases, so every packed slot matters
    for ln in ("ln1", "ln2"):
        params["oar"][ln]["w"] = jnp.asarray(
            1 + 0.1 * rng.normal(size=(L, d)), jnp.bfloat16)
    for lin in ("qkv", "proj"):
        b = params["oar"]["attn"][lin]["b"]
        params["oar"]["attn"][lin]["b"] = jnp.asarray(
            0.02 * rng.normal(size=b.shape), jnp.bfloat16)
    pq = j_quantize(params)
    kv = rng.integers(-100, 101, size=(2, L, B, S, d)).astype(np.int8)
    return cfg, pq, kv, rng


@pytest.mark.parametrize("Q", [1, 2, 6])
@pytest.mark.parametrize("cache_len", [0, 100, 900])
def test_decode_plain_matches_jax(interpret, Q, cache_len):
    """Both sides take exact int8 x int8 products; they differ in float32
    summation order, exp and rsqrt (last bit), which flips an occasional
    int8 activation rounding and moves h by a few bf16 ulps (2^-8 of its
    scale each; four allowed) at 2 layers.  The new int8 K/V rows agree
    exactly except at a rounding tie (+-1)."""
    cfg, pq, kv, rng = _decode_setup()
    H = cfg.n_head
    B, d = kv.shape[2], cfg.n_embd
    x = rng.normal(0, 1, (B, Q, d)).astype(np.float32)
    jx = jnp.asarray(x, jnp.bfloat16)
    jpacked = jdk.pack_fused_oar(pq["oar"])
    fn = jdk.fused_decode_step_v5 if Q == 1 else jdk.fused_decode_step_v5mq
    h_ref, kk_ref, vv_ref = fn(jpacked, jx, jnp.asarray(kv[0]),
                               jnp.asarray(kv[1]), jnp.int32(cache_len),
                               n_head=H)
    packed = pack_decode_weights(from_jax(pq)["oar"])
    kk, vv = torch.tensor(kv[0]), torch.tensor(kv[1])
    tfn = tdk.fused_decode_step_v5 if Q == 1 else tdk.fused_decode_step_v5mq
    h, kk2, vv2 = tfn(packed, _t(jx, torch.bfloat16), kk, vv, cache_len,
                      n_head=H)
    assert kk2 is kk and vv2 is vv          # written in place
    a, b = _f32(h_ref), _f32(h)
    assert np.abs(a - b).max() <= 4 * 2.0 ** -8 * np.abs(a).max()
    for ref, got in ((kk_ref, kk), (vv_ref, vv)):
        diff = np.abs(np.asarray(ref, np.int32) - got.numpy().astype(np.int32))
        assert diff.max() <= 1
        assert (diff == 0).mean() > 0.999
    assert tdk.LAUNCHES == {"fused_decode_step_v5": 0,
                            "fused_decode_step_v5mq": 0}


def test_decode_plain_blocking_matches_reference():
    """The plain version's S-blocks are the reference kernel's."""
    assert [tdk.pick_block_s(S) for S in (2208, 2207, 1693, 1031, 1104)] \
        == [jdk._pick_block_s(S, 0) for S in (2208, 2207, 1693, 1031, 1104)]


def test_decode_wrappers_reject_bad_shapes():
    cfg, pq, kv, _ = _decode_setup(L=1, S=64)
    packed = pack_decode_weights(from_jax(pq)["oar"])
    x = torch.zeros(2, 2, cfg.n_embd, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="one row"):
        tdk.fused_decode_step_v5(packed, x, torch.tensor(kv[0]),
                                 torch.tensor(kv[1]), 0, n_head=cfg.n_head)
    with pytest.raises(ValueError, match="Q\\*H <= 128"):
        tdk.fused_decode_step_v5mq(packed, x[:, :1], torch.tensor(kv[0]),
                                   torch.tensor(kv[1]), 0,
                                   n_head=cfg.n_head)


def test_oar_step_routes_and_eager_body_matches_jax():
    """Rollout.oar_step sends Q = 1 to v5 and 1 < Q·H <= 128 to v5mq (as
    rollout.py:213-266); the eager multi-row body matches the JAX XLA body
    (same bf16 matmuls and softmax, float32 summation order: a bf16 ulp of
    the hidden state's scale)."""
    cfg = ModelConfig(oar_cache_dtype="int8", fused_oar_kernel=True,
                      tar_cache_dtype="bfloat16",
                      tar_mode="temporal_cache").scaled("tiny")
    jm = JUMGen(cfg)
    jp = j_quantize(jm.init_params(jax.random.PRNGKey(1)))
    params = pack_fused(from_jax(jp))
    ro = Rollout(UMGen(cfg))
    hits = []
    real = (tdk.fused_decode_step_v5, tdk.fused_decode_step_v5mq)
    try:
        tdk.fused_decode_step_v5 = lambda *a, **k: (hits.append(1),
                                                    real[0](*a, **k))[1]
        tdk.fused_decode_step_v5mq = lambda *a, **k: (hits.append(6),
                                                      real[1](*a, **k))[1]
        kv = ro.init_kv(2)
        for Q in (6, 1):
            ro.oar_step(params, torch.zeros(2, Q, cfg.n_embd,
                                            dtype=torch.bfloat16),
                        *kv, cache_len=0 if Q == 6 else 6)
    finally:
        tdk.fused_decode_step_v5, tdk.fused_decode_step_v5mq = real
    assert hits == [6, 1]

    rng = np.random.default_rng(3)
    B, Q, S, cl = 2, 6, 2208, 40
    kv = rng.integers(-60, 61, size=(2, cfg.n_oar_layer, B, S,
                                     cfg.n_embd)).astype(np.int8)
    x = jnp.asarray(rng.normal(0, 1, (B, Q, cfg.n_embd)), jnp.bfloat16)
    jro = JRollout(JUMGen(cfg.replace(fused_oar_kernel=False)))
    h_ref, kk_ref, _ = jax.jit(jro.oar_step)(jp, x, jnp.asarray(kv[0]),
                                             jnp.asarray(kv[1]),
                                             jnp.int32(cl))
    kk = torch.tensor(kv[0])
    h, _, _ = ro._oar_step_eager(params, _t(x, torch.bfloat16), kk,
                                 torch.tensor(kv[1]), cl)
    a, b = _f32(h_ref), _f32(h)
    assert np.abs(a - b).max() <= 2.0 ** -7 * np.abs(a).max()
    diff = np.abs(np.asarray(kk_ref, np.int32) - kk.numpy().astype(np.int32))
    assert diff.max() <= 1
