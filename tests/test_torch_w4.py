"""The port's W4A8 OAR decode step against the JAX package's TPU kernels.

JAX packs W4A8 weights only at d = 768 (its group-scale rows 0:6 / 6:12 /
12:18, W4_GROUP 128), so these tests run at full width with two layers, as
tests/test_decode_kernel.py's W4 tests do.  The JAX kernels run in Pallas
interpret mode; the port's wrappers run their plain versions on the CPU.

The JAX reference is compiled with XLA's `xla_allow_excess_precision`
off.  By default XLA's CPU compiler may skip bf16 roundings that the
kernel writes (it keeps such intermediates in float32), and the fused
steps then differ from the kernel's stated arithmetic by several bf16 ulps
of the hidden state — measured: up to 4.6 ulps of its scale at two layers,
80% of the elements differing.  With the option off, a cache_len-0 step
of JAX's kernel and the port's plain version agree bit for bit; with a
cache prefix they differ in float32 summation order, exp and rsqrt, which
flips an occasional int8 re-quantization (a few ulps of h).
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
from umgen_tpu.runtime import quantize as jq
from umgen_tpu_torch.models.rollout import Rollout
from umgen_tpu_torch.models.umgen import UMGen
from umgen_tpu_torch.ops import decode_kernel as tdk
from umgen_tpu_torch.params import from_jax
from umgen_tpu_torch.runtime import quantize as tq

L, B, S = 2, 2, 512
# the JAX reference keeps every bf16 rounding its kernel writes
EXACT = {"xla_allow_excess_precision": False}


@pytest.fixture(autouse=True)
def two_threads():
    # the suite runs several workers on the same cores; torch's default of
    # one intra-op thread per core oversubscribes them
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture()
def interpret_kernels(monkeypatch):
    monkeypatch.setattr(jdk.pl, "pallas_call",
                        ft.partial(pl.pallas_call, interpret=True))


def exact(fn, *args, **static):
    """Run the jitted JAX function `fn` compiled with EXACT."""
    return fn.lower(*args, **static).compile(compiler_options=EXACT)(*args)


def _f32(a):
    if isinstance(a, torch.Tensor):
        return a.float().numpy()
    return np.asarray(jnp.asarray(a, jnp.float32))


@pytest.fixture(scope="module")
def raw_oar():
    """Raw bf16 OAR stack (2 layers, d 768) with layer norms and biases
    away from their init values, so every packed slot matters."""
    cfg = ModelConfig(n_oar_layer=L)
    d = cfg.n_embd
    oar = jnn.init_stack(jax.random.PRNGKey(0), L, jnn.init_block_oar, d,
                         cfg.bias, jnp.bfloat16)
    rng = np.random.default_rng(0)
    for ln in ("ln1", "ln2"):
        oar[ln]["w"] = jnp.asarray(1 + 0.1 * rng.normal(size=(L, d)),
                                   jnp.bfloat16)
    for lin in ("qkv", "proj"):
        b = oar["attn"][lin]["b"]
        oar["attn"][lin]["b"] = jnp.asarray(0.02 * rng.normal(size=b.shape),
                                            jnp.bfloat16)
    return cfg, oar, jdk.pack_fused_oar_w4(oar)


def test_w4_packing_matches_jax(raw_oar):
    """Nibbles, group scales and the vector block, bit for bit."""
    _, oar, jpacked = raw_oar
    params = {"oar": from_jax(oar), "ln_oar": torch.ones(768)}
    packed = tq.pack_fused_w4(params, params["oar"])["oar_packed"]
    for k in ("wqp4", "wfc4", "wpj4", "scales4"):
        np.testing.assert_array_equal(packed[k].numpy(),
                                      np.asarray(jpacked[k]), err_msg=k)
    np.testing.assert_array_equal(packed["vec"].numpy(),
                                  np.asarray(jpacked["vec"]).reshape(L, -1))
    # from_jax carries JAX's packing unchanged
    np.testing.assert_array_equal(from_jax(jpacked)["wqp4"].numpy(),
                                  np.asarray(jpacked["wqp4"]))


def test_quantize_all_stacks_matches_jax():
    assert tq.ALL_STACK_KEYS == jq.ALL_STACK_KEYS
    assert tq.TAR_STACK_KEYS == jq.TAR_STACK_KEYS
    cfg = ModelConfig().scaled("tiny")
    jp = JUMGen(cfg).init_params(jax.random.PRNGKey(1))
    ref = jq.quantize_params_int8(jp, jq.ALL_STACK_KEYS)
    got = tq.quantize_params_int8(from_jax(jp), tq.ALL_STACK_KEYS)
    n = 0

    def walk(a, b, path):
        nonlocal n
        if isinstance(a, dict):
            assert set(a) == set(b), path
            for k in a:
                walk(a[k], b[k], f"{path}/{k}")
            return
        n += "wq" in path
        np.testing.assert_array_equal(_f32(b), _f32(a), err_msg=path)
        assert b.dtype == from_jax(np.asarray(a)).dtype, path

    walk(ref, got, "")
    # the TAR family, the ego net, the embedding MLPs and every head
    for leaf in (got["tar"]["ta"]["qkv"], got["ego_ca"]["cross_attn"]["q"],
                 got["box_tar"]["mlp3"]["proj"], got["map_mlp_pre"]["fc"],
                 got["head_ego"], got["head_tar_map"], got["head_ar_map"]):
        assert leaf["wq"].dtype == torch.int8
    assert n == sum("wq" in k for k in _paths(got))


def _paths(tree, path=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _paths(v, f"{path}/{k}")
    else:
        yield path


def _dense_from_jax(w4, s):
    """JAX layout [K/2, N] packed + [K/128, N] scales → dense [K, N]."""
    wb = np.asarray(w4).astype(np.int32).reshape(-1, 128, w4.shape[-1])
    lo, hi = (wb << 28) >> 28, wb >> 4
    q = np.stack([lo, hi], axis=1).reshape(-1, w4.shape[-1])  # group order
    return q * np.repeat(np.asarray(s), 128, axis=0)


def _dense_from_kernel(wk, sk):
    """The CUDA GEMV's reading of [N, K/2] bytes + [N, K/128] scales:
    bytes j·128 + 4i .. 4i+3 of a column as word i of pair j, their low
    nibbles for input rows (2j)·128 + 4i + b, their high ones for
    (2j+1)·128 + 4i + b."""
    N, half = wk.shape
    K = 2 * half
    out = np.zeros((K, N))
    words = wk.astype(np.int32).reshape(N, half // 128, 32, 4)
    for j in range(half // 128):
        for i in range(32):
            w = words[:, j, i]                            # [N, 4] bytes
            rows = 4 * i + np.arange(4)
            out[2 * j * 128 + rows] = (((w << 28) >> 28)
                                       * sk[:, 2 * j, None]).T
            out[(2 * j + 1) * 128 + rows] = ((w >> 4)
                                             * sk[:, 2 * j + 1, None]).T
    return out


def test_w4_kernel_layout_unpacks_to_the_same_values(raw_oar):
    """The kernel's repacking holds the same weights and scales, at the
    offsets csrc/decode_step.cu's umgen_decode_step_w4 reads them."""
    _, _, jpacked = raw_oar
    packed = from_jax(jpacked)
    kl = tq.w4_kernel_layout(packed)
    d, G = 768, 6
    w_off = [0, 3 * d * d // 2, 2 * d * d, 4 * d * d, 6 * d * d]
    s_off = [0, 3 * d * G, 4 * d * G, 8 * d * G, 12 * d * G]
    sc = np.asarray(jpacked["scales4"])
    for layer in range(L):
        wqp = np.asarray(jpacked["wqp4"][layer])
        mats = [(wqp[:, :3 * d], sc[layer, :G, :3 * d]),
                (wqp[:, 3 * d:], sc[layer, :G, 3 * d:]),
                (np.asarray(jpacked["wfc4"][layer]), sc[layer, G:2 * G]),
                (np.asarray(jpacked["wpj4"][layer]),
                 sc[layer, 2 * G:].reshape(4 * G, d))]
        for i, (w, s) in enumerate(mats):
            N = w.shape[1]
            wk = kl["w4k"][layer, w_off[i]:w_off[i + 1]].numpy().reshape(N,
                                                                         -1)
            sk = kl["s4k"][layer, s_off[i]:s_off[i + 1]].numpy().reshape(N,
                                                                         -1)
            np.testing.assert_array_equal(_dense_from_kernel(wk, sk),
                                          _dense_from_jax(w, s))
        assert kl["w4k"].shape == (L, w_off[-1])
        assert kl["s4k"].shape == (L, s_off[-1])


@pytest.mark.parametrize("Q", [1, 2, 6])
@pytest.mark.parametrize("cache_len", [0, 300])
def test_w4_plain_matches_jax(raw_oar, interpret_kernels, Q, cache_len):
    """The plain version, fed JAX's packing through from_jax, against
    fused_decode_step_w4 / w4mq: h within 4 bf16 ulps of its scale, the
    new K/V rows within one grid step at rounding ties; a Q = 1 step at
    cache_len 0 attends only to itself and equals JAX bit for bit."""
    cfg, _, jpacked = raw_oar
    H, d = cfg.n_head, cfg.n_embd
    rng = np.random.default_rng(10 * Q + cache_len)
    kv = rng.integers(-100, 101, size=(2, L, B, S, d)).astype(np.int8)
    x = jnp.asarray(rng.normal(0, 1, (B, Q, d)), jnp.bfloat16)
    jfn = jdk.fused_decode_step_w4 if Q == 1 else jdk.fused_decode_step_w4mq
    h_ref, kk_ref, vv_ref = exact(jfn, jpacked, x, jnp.asarray(kv[0]),
                                  jnp.asarray(kv[1]), jnp.int32(cache_len),
                                  n_head=H)
    kk, vv = torch.tensor(kv[0]), torch.tensor(kv[1])
    tfn = tdk.fused_decode_step_w4 if Q == 1 else tdk.fused_decode_step_w4mq
    h, kk2, vv2 = tfn(from_jax(jpacked), torch.tensor(_f32(x)).bfloat16(),
                      kk, vv, cache_len, n_head=H)
    assert kk2 is kk and vv2 is vv          # written in place
    a, b = _f32(h_ref), _f32(h)
    assert np.abs(a - b).max() <= 4 * 2.0 ** -8 * np.abs(a).max()
    for ref, got in ((kk_ref, kk), (vv_ref, vv)):
        diff = np.abs(np.asarray(ref, np.int32)
                      - got.numpy().astype(np.int32))
        assert diff.max() <= 1
        assert (diff == 0).mean() > 0.999
    if Q == 1 and cache_len == 0:
        np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(np.asarray(kk_ref), kk.numpy())
    assert tdk.LAUNCHES["fused_decode_step_w4"] == 0
    assert tdk.LAUNCHES["fused_decode_step_w4mq"] == 0


@pytest.mark.parametrize("Q", [1, 2, 6])
def test_oar_step_routes_w4(raw_oar, interpret_kernels, Q):
    """Rollout.oar_step with W4-packed params sends Q = 1 to w4 and
    1 < Q·H <= 128 to w4mq on both sides (rollout.py:213-266), with the
    same result: ln_oar(h) within 4 bf16 ulps of its scale."""
    cfg, oar, jpacked = raw_oar
    cfg = cfg.replace(oar_cache_dtype="int8", fused_oar_kernel=True,
                      tar_mode="temporal_cache")
    H, d = cfg.n_head, cfg.n_embd
    rng = np.random.default_rng(Q)
    ln = jnp.asarray(1 + 0.1 * rng.normal(size=d), jnp.bfloat16)
    jparams = {"oar": jq.quantize_params_int8({"oar": oar})["oar"],
               "ln_oar": {"w": ln}, "oar_packed": jpacked}
    kv = rng.integers(-100, 101, size=(2, L, B, S, d)).astype(np.int8)
    x = jnp.asarray(rng.normal(0, 1, (B, Q, d)), jnp.bfloat16)
    cl = 200
    jro = JRollout(JUMGen(cfg))
    h_ref, kk_ref, _ = exact(jax.jit(jro.oar_step), jparams, x,
                             jnp.asarray(kv[0]), jnp.asarray(kv[1]),
                             jnp.int32(cl))
    ro = Rollout(UMGen(cfg))
    hits = []
    real = (tdk.fused_decode_step_w4, tdk.fused_decode_step_w4mq)
    try:
        tdk.fused_decode_step_w4 = lambda *a, **k: (hits.append("w4"),
                                                    real[0](*a, **k))[1]
        tdk.fused_decode_step_w4mq = lambda *a, **k: (hits.append("w4mq"),
                                                      real[1](*a, **k))[1]
        kk = torch.tensor(kv[0])
        h, _, _ = ro.oar_step(from_jax(jparams), torch.tensor(_f32(x))
                              .bfloat16(), kk, torch.tensor(kv[1]), cl)
    finally:
        tdk.fused_decode_step_w4, tdk.fused_decode_step_w4mq = real
    assert hits == ["w4" if Q == 1 else "w4mq"]
    a, b = _f32(h_ref), _f32(h)
    assert np.abs(a - b).max() <= 4 * 2.0 ** -8 * np.abs(a).max()
    diff = np.abs(np.asarray(kk_ref, np.int32) - kk.numpy().astype(np.int32))
    assert diff.max() <= 1


def test_decode_wrappers_take_their_own_packing(raw_oar):
    """v5 refuses W4A8 blocks and w4 refuses int8 ones; a W4A8 step takes
    any number of rows (here B·Q = 30, past the int8 kernel's 16-row
    tile)."""
    cfg, oar, jpacked = raw_oar
    w4 = from_jax(jpacked)
    v5 = tq.pack_decode_weights(
        tq.quantize_params_int8({"oar": from_jax(oar)})["oar"])
    x = torch.zeros(5, 6, cfg.n_embd, dtype=torch.bfloat16)
    kv = torch.zeros(L, 5, 64, cfg.n_embd, dtype=torch.int8)
    with pytest.raises(ValueError, match="got int8"):
        tdk.fused_decode_step_w4mq(v5, x, kv, kv.clone(), 0, cfg.n_head)
    with pytest.raises(ValueError, match="got W4A8"):
        tdk.fused_decode_step_v5(w4, x[:, :1], kv, kv.clone(), 0,
                                 cfg.n_head)
    h, _, _ = tdk.fused_decode_step_w4mq(w4, x, kv, kv.clone(), 0,
                                         cfg.n_head)
    assert h.shape == x.shape and torch.isfinite(h.float()).all()
