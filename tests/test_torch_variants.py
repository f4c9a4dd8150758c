"""The port's six remaining decode steps against the JAX package: v1
(`fused_decode_step`), v2, v3, v4, v6 and v7, their packings, `Rollout.
oar_step`'s dispatch to them, and one tiny-scale frame of the two CLI paths
that reach them (a bfloat16 OAR cache: v2; `--oar_kernel 7`: v7).

The steps run at d = 768 with two layers, JAX's kernels in Pallas interpret
mode, compiled with XLA's `xla_allow_excess_precision` off (tests/
test_torch_w4.py says why: XLA's CPU compiler otherwise skips bf16 roundings
the JAX code writes, and v2 / v1 are made of them); the port's wrappers run
their plain versions on the CPU.  What the variants compute (measured here,
in interpret mode):

  * v3, v4: v5's arithmetic on a 5-D int8 cache (v4 from six weight
    streams) — h and the new rows equal v5's bit for bit;
  * v6: as v5 with the new rows put on the int8 grid from float32 — h equal
    to v5's, a few rows' values one grid step from v5's;
  * v7: one query scale per (scene, head) instead of one per scene;
  * v2: a dense cache (bfloat16, float8_e4m3fn, or int8 dequantized to
    bf16), logits from bf16 products, bf16 softmax weights and bf16 block
    sums over S-blocks from the list with 276 in it;
  * v1: as v2 in one block over all of S, the normalized weights rounded.

Bounds: h within 4 bf16 ulps of its scale, as for the other nine steps
(measured: bit-equal in 35 of the 36 cases, 0.93 ulps in the other); layer
0's new rows equal; later layers' new rows at most one step of their
storage type apart (int8: 1; bf16: 2^-7, fp8: 2^-2 of the rows' largest
value) in fewer than 1% of the entries (measured: none differ).
"""

import functools as ft

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from umgen_tpu.config import ModelConfig
from umgen_tpu.data.synthetic import make_token_batch
from umgen_tpu.models import modules as jnn
from umgen_tpu.models import rollout as jrollout
from umgen_tpu.models.umgen import UMGen as JUMGen
from umgen_tpu.ops import decode_kernel as jdk
from umgen_tpu.runtime import quantize as jq
from umgen_tpu_torch.models.rollout import Rollout
from umgen_tpu_torch.models.umgen import UMGen
from umgen_tpu_torch.ops import decode_kernel as tdk
from umgen_tpu_torch.params import from_jax
from umgen_tpu_torch.runtime import quantize as tq

from test_torch_slice import (_check_decisions, _close, _decision_labels,
                              _exact_jit, _Recorder, _Replay)

L, S = 2, 512
EXACT = {"xla_allow_excess_precision": False}
TORCH_DTYPE = {"bfloat16": torch.bfloat16,
               "float8_e4m3fn": torch.float8_e4m3fn, "int8": torch.int8}
# one step of a storage type, relative to the rows' largest value (int8:
# absolute, in grid steps)
ROW_STEP = {"int8": 1.0, "bfloat16": 2.0 ** -7, "float8_e4m3fn": 2.0 ** -2}


@pytest.fixture(autouse=True)
def two_threads():
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


def _torch(a, dtype):
    return torch.tensor(_f32(a)).to(dtype)


@pytest.fixture(scope="module")
def packs():
    """One int8-quantized OAR stack (2 layers, d 768, layer norms and biases
    off their init) and its packings on both sides: {"qoar": (JAX, port),
    "v3": pack_fused_oar / pack_decode_weights, "v4": the six streams,
    "w4": W4A8 from the raw stack}."""
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
    qoar = jq.quantize_params_int8({"oar": oar})["oar"]
    tqoar = from_jax(qoar)
    jw4 = jdk.pack_fused_oar_w4(oar)
    return cfg, {"qoar": (qoar, tqoar),
                 "v3": (jdk.pack_fused_oar(qoar),
                        tq.pack_decode_weights(tqoar)),
                 "v4": (jdk.pack_fused_oar_v4(qoar),
                        tq.pack_fused_oar_v4(tqoar)),
                 "w4": (jw4, {**from_jax(jw4),
                              **tq.w4_kernel_layout(from_jax(jw4))})}


def _caches(rng, kv_dtype, B, d, five_d, H, S=S):
    """Random K/V caches ~N(0, 0.5²) of S rows in `kv_dtype` on both sides:
    JAX's in its layout (5-D or flat), the port's flat, or the 5-D view
    where `five_d`."""
    kvf = rng.normal(0, 0.5, (2, L, B, S, d)).astype(np.float32)
    if kv_dtype == "int8":
        jkv = [jnp.asarray(np.clip(np.round(k * 16), -127, 127), jnp.int8)
               for k in kvf]
    else:
        jkv = [jnp.asarray(k, jnp.bfloat16).astype(jnp.dtype(kv_dtype))
               for k in kvf]
    tkv = [_torch(k, TORCH_DTYPE[kv_dtype]) for k in jkv]
    if five_d:
        jkv = [k.reshape(L, B, S, H, d // H) for k in jkv]
    return jkv, tkv


def _compare_rows(ref, got, cl, Q, kv_dtype, what, fused=True, S=S):
    """JAX's and the port's caches after a step: everything but the new
    rows untouched; the new rows at most one step of the storage type apart
    (int8: one grid step; bf16 / fp8: one ulp of the rows' largest value).
    The fused steps (exact integer products): layer 0's new rows equal, and
    fewer than 1% of the entries differ elsewhere.  The eager bodies sum
    their bf16 products in another order on the two sides: most values are
    equal, the share that is not is printed."""
    new = slice(cl, cl + Q)
    for name, r, g in zip("KV", ref, got):
        r = _f32(r).reshape(L, -1, S, g.shape[-1] if g.ndim == 4
                            else g.shape[-1] * g.shape[-2])
        g = _f32(g).reshape(r.shape)
        np.testing.assert_array_equal(g[:, :, :cl], r[:, :, :cl])
        np.testing.assert_array_equal(g[:, :, cl + Q:], r[:, :, cl + Q:])
        if fused:
            np.testing.assert_array_equal(g[0, :, new], r[0, :, new],
                                          err_msg=f"{what}: layer 0 {name}")
        r, g = r[:, :, new], g[:, :, new]
        assert np.abs(r).max() > 0, (what, name)       # the rows were written
        step = ROW_STEP[kv_dtype] * (1 if kv_dtype == "int8"
                                     else np.abs(r).max())
        assert np.abs(r - g).max() <= step, (what, name,
                                             np.abs(r - g).max(), step)
        share = (r != g).mean()
        print(f"{what}: {name} rows that differ: {share:.4f}, largest "
              f"difference {np.abs(r - g).max() / step:.3g} steps")
        assert share < (0.01 if fused else 0.5), (what, name, share)


STEP_CASES = (
    [("fused_decode_step_v2", dt) for dt in ("bfloat16", "float8_e4m3fn",
                                             "int8")]
    + [("fused_decode_step", dt) for dt in ("bfloat16", "float8_e4m3fn")]
    + [(f"fused_decode_step_{v}", "int8") for v in ("v3", "v4", "v6", "v7")])


@pytest.mark.parametrize("cache_len", [0, 300])
@pytest.mark.parametrize("B", [1, 2])
@pytest.mark.parametrize("name,kv_dtype", STEP_CASES)
def test_variant_plain_matches_jax(packs, interpret_kernels, name, kv_dtype,
                                   B, cache_len):
    """Each of the six plain steps against its JAX kernel in interpret mode,
    every storage type it takes: h within 4 bf16 ulps of its scale, the new
    rows as `_compare_rows` bounds them, the caches passed returned and
    written in place; no kernel launched."""
    cfg, both = packs
    H, d = cfg.n_head, cfg.n_embd
    kind = {"fused_decode_step": "qoar", "fused_decode_step_v4": "v4"}.get(
        name, "v3")
    jpacked, tpacked = both[kind]
    five_d = name[-2:] not in ("v6", "v7")        # v1-v4 take 5-D caches
    rng = np.random.default_rng(100 * B + cache_len)
    jkv, tkv = _caches(rng, kv_dtype, B, d, five_d, H)
    if five_d and name[-2:] in ("v3", "v4"):
        tkv = [t.view(L, B, S, H, d // H) for t in tkv]
    x = jnp.asarray(rng.normal(0, 1, (B, 1, d)), jnp.bfloat16)
    ref = exact(getattr(jdk, name), jpacked, x, *jkv, jnp.int32(cache_len),
                n_head=H)
    out = getattr(tdk, name)(tpacked, _torch(x, torch.bfloat16), *tkv,
                             cache_len, n_head=H)
    assert out[1] is tkv[0] and out[2] is tkv[1]           # written in place
    a, b = _f32(ref[0]), _f32(out[0])
    assert np.abs(a - b).max() <= 4 * 2.0 ** -8 * np.abs(a).max()
    _compare_rows(ref[1:], out[1:], cache_len, 1, kv_dtype, name)
    assert not any(tdk.LAUNCHES.values())


# S = 768: v2's S-blocks are 384 rows (`pick_block_s` with V2_BLOCKS, as
# `_kernel_v2` picks them), so these cache lengths end a row before, on and
# a row after the first block's edge; v1 over all but the last row
MULTI_BLOCK_CASES = (
    [("fused_decode_step_v2", dt, cl)
     for dt in ("bfloat16", "float8_e4m3fn", "int8") for cl in (383, 384, 385)]
    + [("fused_decode_step", dt, 767) for dt in ("bfloat16", "float8_e4m3fn")])


@pytest.mark.parametrize("name,kv_dtype,cache_len", MULTI_BLOCK_CASES)
def test_dense_steps_over_several_s_blocks(packs, interpret_kernels, name,
                                           kv_dtype, cache_len):
    """v2 and v1 with the cache over several S-blocks (S = 768), the plain
    steps against JAX's kernels in interpret mode: the rounding points the
    card kernel is held to — the bf16 rescale of the flash state and the bf16
    block sums at a block edge, v1's one denominator — as in
    `test_variant_plain_matches_jax`, whose cases have one S-block."""
    cfg, both = packs
    H, d, B, S2 = cfg.n_head, cfg.n_embd, 1, 768
    assert tdk.pick_block_s(S2, prefer=tdk.V2_BLOCKS) == 384
    jpacked, tpacked = both["qoar" if name == "fused_decode_step" else "v3"]
    rng = np.random.default_rng(cache_len)
    jkv, tkv = _caches(rng, kv_dtype, B, d, True, H, S=S2)
    x = jnp.asarray(rng.normal(0, 1, (B, 1, d)), jnp.bfloat16)
    ref = exact(getattr(jdk, name), jpacked, x, *jkv, jnp.int32(cache_len),
                n_head=H)
    out = getattr(tdk, name)(tpacked, _torch(x, torch.bfloat16), *tkv,
                             cache_len, n_head=H)
    assert out[1] is tkv[0] and out[2] is tkv[1]
    a, b = _f32(ref[0]), _f32(out[0])
    assert np.abs(a - b).max() <= 4 * 2.0 ** -8 * np.abs(a).max()
    _compare_rows(ref[1:], out[1:], cache_len, 1, kv_dtype, name, S=S2)
    assert not any(tdk.LAUNCHES.values())


@pytest.mark.parametrize("cache_len", [0, 300])
def test_v3_v4_v6_equal_v5(packs, cache_len):
    """On the same values v3 and v4 give v5's h and rows bit for bit; v6
    gives v5's h, and rows at most one grid step from v5's (they differ
    where the bf16 rounding of a new K/V value crosses a grid boundary)."""
    cfg, both = packs
    H, d, B = cfg.n_head, cfg.n_embd, 2
    rng = np.random.default_rng(cache_len)
    _, tkv = _caches(rng, "int8", B, d, False, H)
    x = torch.tensor(rng.normal(0, 1, (B, 1, d))).bfloat16()
    k5, v5 = tkv[0].clone(), tkv[1].clone()
    h5 = tdk.fused_decode_step_v5(both["v3"][1], x, k5, v5, cache_len,
                                  n_head=H)[0]
    for name, kind in (("v3", "v3"), ("v4", "v4")):
        kk = tkv[0].clone().view(L, B, S, H, d // H)
        vv = tkv[1].clone().view(L, B, S, H, d // H)
        h, kk2, vv2 = getattr(tdk, f"fused_decode_step_{name}")(
            both[kind][1], x, kk, vv, cache_len, n_head=H)
        assert kk2 is kk and vv2 is vv and kk.ndim == 5
        assert torch.equal(h, h5), name
        assert torch.equal(kk.flatten(3), k5) and torch.equal(vv.flatten(3),
                                                              v5)
    k6, v6 = tkv[0].clone(), tkv[1].clone()
    h6 = tdk.fused_decode_step_v6(both["v3"][1], x, k6, v6, cache_len,
                                  n_head=H)[0]
    assert torch.equal(h6, h5)
    diff = (k6.int() - k5.int()).abs()
    assert diff.max() <= 1 and 0 < (diff != 0).sum() < 0.05 * B * L * d


def test_pack_fused_matches_jax(packs):
    """`pack_fused(params, kv_dtype, version)` takes the reference's
    arguments: version "v4" on an int8 cache gives `pack_fused_oar_v4`'s six
    streams, bit-equal to JAX's (plus the kernel's own layout under
    "kernel"); every other combination the one int8 layout, which holds
    JAX's `pack_fused_oar` values output-major; raw weights are refused."""
    _, both = packs
    jq8, tq8 = both["qoar"]
    jv4 = jq.pack_fused({"oar": jq8}, "int8", "v4")["oar_packed"]
    tv4 = tq.pack_fused({"oar": tq8}, "int8", "v4")["oar_packed"]
    assert set(tv4) == set(jv4) | {"kernel"}
    for k, a in jv4.items():
        b = tv4[k]
        assert b.dtype == (torch.float32 if k == "vec" else torch.int8)
        np.testing.assert_array_equal(np.asarray(a).reshape(b.shape),
                                      b.numpy(), err_msg=k)
    for k, a in tq.pack_fused_oar_v4(tq8).items():
        if k != "kernel":
            assert torch.equal(a, tv4[k])
    for kv_dtype, version in (("int8", "v3"), ("bfloat16", "v3"),
                              ("bfloat16", "v4"), ("float8_e4m3fn", "v3")):
        jp = jq.pack_fused({"oar": jq8}, kv_dtype, version)["oar_packed"]
        tp = tq.pack_fused({"oar": tq8}, kv_dtype, version)["oar_packed"]
        assert set(jp) == {"vec", "wqp", "wfc", "wpj"}
        assert set(tp) == {"vec", "wqkv", "wproj", "wfc", "wpj"}
        wqp = np.asarray(jp["wqp"])
        d = wqp.shape[1]
        np.testing.assert_array_equal(tp["wqkv"].numpy(),
                                      wqp[:, :, :3 * d].transpose(0, 2, 1))
        np.testing.assert_array_equal(tp["wproj"].numpy(),
                                      wqp[:, :, 3 * d:].transpose(0, 2, 1))
        np.testing.assert_array_equal(
            tp["wpj"].numpy(), np.asarray(jp["wpj"]).transpose(0, 2, 1))
        for k in tp:
            assert torch.equal(tp[k], tv4["kernel"][k])
    raw = {"oar": {"attn": {"qkv": {"w": torch.zeros(1, 4, 12)}}}}
    with pytest.raises(ValueError, match="quantize_params_int8"):
        tq.pack_fused(raw, "bfloat16")


# (case, Q, B, cache type, 5-D on the port's side, packing or None, config
# changes, the port's wrapper that must be hit or None for the eager body)
DISPATCH = [
    ("w4", 1, 2, "int8", False, "w4", {}, "fused_decode_step_w4"),
    ("v7", 1, 2, "int8", False, "v3", {"oar_kernel_version": 7},
     "fused_decode_step_v7"),
    ("v7-beyond-128-heads", 1, 9, "int8", False, "v3",
     {"oar_kernel_version": 7}, "fused_decode_step_v5"),
    ("v5", 1, 2, "int8", False, "v3", {}, "fused_decode_step_v5"),
    ("v4", 1, 2, "int8", True, "v4", {}, "fused_decode_step_v4"),
    ("v3", 1, 2, "int8", True, "v3", {}, "fused_decode_step_v3"),
    ("v2-bf16", 1, 2, "bfloat16", False, "v3", {}, "fused_decode_step_v2"),
    ("v2-fp8", 1, 2, "float8_e4m3fn", False, "v3", {},
     "fused_decode_step_v2"),
    ("v5mq", 2, 2, "int8", False, "v3", {}, "fused_decode_step_v5mq"),
    ("v1", 1, 2, "bfloat16", False, None, {}, "fused_decode_step"),
    ("eager-two-rows-bf16", 2, 2, "bfloat16", False, "v3", {}, None),
    ("eager-two-rows-5d-int8", 2, 2, "int8", True, "v3", {}, None),
    ("eager-unfused", 1, 2, "bfloat16", False, "v3",
     {"fused_oar_kernel": False}, None),
]


@pytest.mark.parametrize("case,Q,B,kv_dtype,five_d,packing,changes,want",
                         DISPATCH, ids=[c[0] for c in DISPATCH])
def test_oar_step_dispatch_matches_jax(packs, interpret_kernels, case, Q, B,
                                       kv_dtype, five_d, packing, changes,
                                       want):
    """`Rollout.oar_step`, one case a branch of the reference's dispatch
    (rollout.py:211-272), both packages from the same params and cache: the
    port calls the wrapper the reference's branch names (or none: the eager
    body), ln_oar(h) within 4 bf16 ulps of its scale, the new rows as
    `_compare_rows` bounds them.  JAX keeps bf16 / fp8 caches 5-D; the
    port's are flat, and 5-D where the branch is told by it."""
    cfg, both = packs
    cfg = cfg.replace(**{"oar_cache_dtype": kv_dtype,
                         "fused_oar_kernel": True,
                         "tar_mode": "temporal_cache", **changes})
    H, d, cl = cfg.n_head, cfg.n_embd, 200
    rng = np.random.default_rng(len(case) + Q)
    ln = jnp.asarray(1 + 0.1 * rng.normal(size=d), jnp.bfloat16)
    jparams = {"oar": both["qoar"][0], "ln_oar": {"w": ln}}
    tparams = {"oar": both["qoar"][1], "ln_oar": from_jax({"w": ln})}
    if packing:
        jparams["oar_packed"], tparams["oar_packed"] = both[packing]
    jkv, tkv = _caches(rng, kv_dtype, B, d, five_d or kv_dtype != "int8", H)
    if five_d:
        tkv = [t.view(L, B, S, H, d // H) for t in tkv]
    x = jnp.asarray(rng.normal(0, 1, (B, Q, d)), jnp.bfloat16)
    jro = jrollout.Rollout(JUMGen(cfg))
    h_ref, jk, jv = exact(jax.jit(jro.oar_step), jparams, x, *jkv,
                          jnp.int32(cl))
    ro = Rollout(UMGen(cfg))
    hits = []
    names = [n for n in dir(tdk) if n.startswith("fused_decode_step")]
    real = {n: getattr(tdk, n) for n in names}
    try:
        for n in names:
            setattr(tdk, n, lambda *a, _n=n, **k: (hits.append(_n),
                                                   real[_n](*a, **k))[1])
        h, ok, ov = ro.oar_step(tparams, _torch(x, torch.bfloat16), *tkv, cl)
    finally:
        for n in names:
            setattr(tdk, n, real[n])
    assert hits == ([want] if want else [])
    assert ok is tkv[0] and ov is tkv[1]                   # written in place
    a, b = _f32(h_ref), _f32(h)
    assert np.abs(a - b).max() <= 4 * 2.0 ** -8 * np.abs(a).max()
    _compare_rows((jk, jv), (ok, ov), cl, Q, kv_dtype, case,
                  fused=want is not None)


def test_fp8_store_saturates_where_jax_overflows():
    """`kv_store` to float8_e4m3fn saturates at ±448 (the kernel converts
    with the same rule); JAX's conversion gives NaN there — a divergence of
    the reference's, filed in ROADMAP.md Queue 3.  K/V of this model stay
    far below 448.  In range the two conversions agree."""
    x = np.array([500.0, -1000.0, 448.0, 460.0, 0.3, -1e-3, 17.0],
                 np.float32)
    got = tdk.kv_store(torch.tensor(x), torch.float8_e4m3fn)
    assert got.dtype == torch.float8_e4m3fn
    np.testing.assert_array_equal(got.float().numpy()[:4],
                                  [448.0, -448.0, 448.0, 448.0])
    ref = jnp.asarray(x, jnp.bfloat16).astype(jnp.float8_e4m3fn)
    assert np.isnan(_f32(ref)[:2]).all()
    np.testing.assert_array_equal(got.float().numpy()[2:], _f32(ref)[2:])
    assert torch.tensor(500.0).to(torch.float8_e4m3fn).float() == 448.0
    np.testing.assert_array_equal(
        tdk.kv_load(got, torch.bfloat16).float().numpy(),
        got.float().numpy())


def test_variant_wrappers_check_their_arguments(packs):
    """A wrapper refuses the cache types, shapes and packings it does not
    take, by name."""
    cfg, both = packs
    H, d = cfg.n_head, cfg.n_embd
    x = torch.zeros(2, 1, d, dtype=torch.bfloat16)
    flat = torch.zeros(L, 2, 64, d, dtype=torch.int8)
    v3, v4 = both["v3"][1], both["v4"][1]
    with pytest.raises(ValueError, match="5-D caches"):
        tdk.fused_decode_step_v3(v3, x, flat, flat.clone(), 0, H)
    with pytest.raises(ValueError, match="six-stream"):
        tdk.fused_decode_step_v4(v3, x, flat.view(L, 2, 64, H, d // H),
                                 flat.clone().view(L, 2, 64, H, d // H), 0, H)
    with pytest.raises(ValueError, match="six-stream"):
        tdk.fused_decode_step_v3(v4, x, flat.view(L, 2, 64, H, d // H),
                                 flat.clone().view(L, 2, 64, H, d // H), 0, H)
    with pytest.raises(ValueError, match="contiguous"):
        bad = flat.view(L, 2, 64, H, d // H).transpose(3, 4)
        tdk.fused_decode_step_v3(v3, x, bad, bad.clone(), 0, H)
    with pytest.raises(ValueError, match="requires int8 KV"):
        tdk.fused_decode_step_v7(v3, x, flat.bfloat16(), flat.bfloat16(), 0,
                                 H)
    with pytest.raises(ValueError, match="flat"):
        tdk.fused_decode_step_v6(v3, x, flat.view(L, 2, 64, H, d // H),
                                 flat.clone().view(L, 2, 64, H, d // H), 0, H)
    with pytest.raises(ValueError, match="as if it were fp8"):
        tdk.fused_decode_step_v2(v3, x, flat.half(), flat.half(), 0, H)
    with pytest.raises(ValueError, match="as if it were fp8"):
        tdk.fused_decode_step(both["qoar"][1], x, flat, flat.clone(), 0, H)
    with pytest.raises(ValueError, match="one row per scene"):
        tdk.fused_decode_step_v2(v3, torch.zeros(2, 2, d).bfloat16(),
                                 flat.bfloat16(), flat.bfloat16(), 0, H)
    with pytest.raises(ValueError, match="quantize_params_int8"):
        tdk.fused_decode_step({"attn": {"qkv": {"w": None}}}, x,
                              flat.bfloat16(), flat.bfloat16(), 0, H)
    # v1 packs its unpacked weights once while they live
    kv = flat.bfloat16()
    tdk.fused_decode_step(both["qoar"][1], x, kv, kv.clone(), 0, H)
    first = tdk._packed_once(both["qoar"][1])
    assert tdk._packed_once(both["qoar"][1]) is first
    for S_, prefer, want in ((2208, tdk.V2_BLOCKS, 552),
                             (828, tdk.V2_BLOCKS, 276),
                             (828, tdk.V5_BLOCKS, 828),
                             (1032, tdk.V2_BLOCKS, 344)):
        assert tdk.pick_block_s(S_, prefer=prefer) == want


def _count_steps(monkeypatch):
    hits = {}
    for name in [n for n in dir(tdk) if n.startswith("fused_decode_step")]:
        real = getattr(tdk, name)

        def counted(*a, _real=real, _name=name, **k):
            hits[_name] = hits.get(_name, 0) + 1
            return _real(*a, **k)
        monkeypatch.setattr(tdk, name, counted)
    return hits


@pytest.mark.parametrize("config", ["slice-bf16kv", "slice-v7"])
def test_variant_slice_matches_jax(config, monkeypatch):
    """The prefill frame of the two CLI paths this slice adds, at the tiny
    scale (bf16 rings, int8 decode weights, greedy, B = 2, a 2-frame
    window), as tests/test_torch_slice.py holds the earlier slices.
    slice-bf16kv: `--oar_kv_dtype bfloat16` — JAX decodes its 5-D bf16 cache
    through v2 in interpret mode and pushes the multi-row chunks through its
    XLA body; the port replays JAX's decisions through v2's plain version
    and its eager body on the flat bf16 cache.  slice-v7: `--oar_kernel 7`
    — v7 for the single-token steps (B·H = 8 <= 128), v5mq for the pushes,
    on both sides.  2196 single-token steps and 3 pushes; the tokens equal,
    ego logits and priors within 4 bf16 ulps of their scale and every
    decision's logit within 4 (the bounds of the earlier slices)."""
    changes = ({"oar_cache_dtype": "bfloat16"} if config == "slice-bf16kv"
               else {"oar_kernel_version": 7})
    cfg = ModelConfig(sample_method="greedy", tar_mode="temporal_cache",
                      tar_cache_dtype="bfloat16", oar_cache_dtype="int8",
                      fused_oar_kernel=True, tar_cache_window=20
                      ).scaled("tiny").replace(**changes)
    jmodel = JUMGen(cfg)
    jparams = jq.quantize_params_int8(
        jmodel.init_params(jax.random.PRNGKey(0)))
    jparams_fused = jq.pack_fused(jparams, cfg.oar_cache_dtype)
    params = tq.pack_fused(from_jax(jparams), cfg.oar_cache_dtype)
    cond = make_token_batch(jmodel.layout, T=2, B=2, seed=0, config=cfg)
    jin = {m: jnp.asarray(v) for m, v in cond.items()}
    tin = {m: torch.as_tensor(v, dtype=torch.long) for m, v in cond.items()}
    j_ego, jcache = jax.jit(jmodel.prefill_ego_cache)(jparams, jin, {})
    j_tok = jnp.argmax(j_ego, axis=-1).astype(jnp.int32)
    shifted = dict(jin, pose=jnp.concatenate([jin["pose"], j_tok[:, None]],
                                             axis=1)[:, 1:])
    j_pri = jax.jit(jmodel.prefill_tar_caches)(jparams, shifted,
                                               jcache)["prior_seq"]
    jro = jrollout.Rollout(jmodel)
    rec = _Recorder(jro)
    rec.add(j_ego)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jdk.pl, "pallas_call",
                   ft.partial(pl.pallas_call, interpret=True))
        jout = _exact_jit(jro._finish_frame)(
            jparams_fused, j_pri, j_tok, jin["bbox3d"][:, -1],
            jnp.zeros((2, 61), bool), jax.random.PRNGKey(0))
        jax.effects_barrier()
    lo = jro.layout
    ro = Rollout(UMGen(cfg))
    replay = _Replay(ro, rec.calls)
    hits = _count_steps(monkeypatch)
    tout, _ = ro.frame_step_prefill(params, tin, torch.Generator())
    steps = lo.seq_len - 5 - 2 * 3
    assert hits == ({"fused_decode_step_v2": steps}
                    if config == "slice-bf16kv" else
                    {"fused_decode_step_v7": steps,
                     "fused_decode_step_v5mq": 3}), hits
    seen = {"ego logits": _close(tout.ego_logits, j_ego, "ego logits"),
            "priors": _close(tout.prior_seq, j_pri, "priors"),
            "decision logits": _check_decisions(
                rec.calls, replay.seen, _decision_labels(lo), frame=1)}
    np.testing.assert_array_equal(tout.tokens.numpy(),
                                  np.asarray(jout.tokens))
    print(f"{config}, deviations from JAX in bf16 ulps: {seen}")
