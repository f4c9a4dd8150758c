"""The port's OAR decode on the nibble-packed int4 KV cache against the JAX
package: the quantizer and loader, the four fused steps (v5i4, w4i4, v5mqi4,
w4mqi4), `Rollout._oar_step_int4`'s eager body and the cache plumbing.

The fused steps run at d = 768 with two layers (JAX packs W4A8 weights only
there), JAX's kernels in Pallas interpret mode and compiled with XLA's
`xla_allow_excess_precision` off (tests/test_torch_w4.py says why); the
port's wrappers run their plain versions on the CPU.  The plain version is
held to JAX's *kernel*, which has the same arithmetic, not to the bf16-cache
XLA step, so the int8-cache bounds carry over: h within 4 bf16 ulps of its
scale.  A new row's nibbles sit on a grid of 1/7 of its (row, head) max |.|:
where h differs by an ulp between the two, a value on a rounding boundary
lands one step apart, and a head's scale (its largest bf16 value) one bf16
ulp apart; both are counted and bounded (`_compare_new_rows`).  Layer 0 sees identical inputs: its
new rows and scales must be equal.
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
from umgen_tpu.models import rollout as jrollout
from umgen_tpu.models.umgen import UMGen as JUMGen
from umgen_tpu.ops import decode_kernel as jdk
from umgen_tpu.runtime import quantize as jq
from umgen_tpu_torch.models.rollout import (OarState, PackedKV, Rollout,
                                            _kv_rows)
from umgen_tpu_torch.models.umgen import UMGen
from umgen_tpu_torch.ops import decode_kernel as tdk
from umgen_tpu_torch.params import from_jax
from umgen_tpu_torch.runtime import quantize as tq

L, S = 2, 512
EXACT = {"xla_allow_excess_precision": False}
I4_NAMES = ("fused_decode_step_v5i4", "fused_decode_step_v5mqi4",
            "fused_decode_step_w4i4", "fused_decode_step_w4mqi4")


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


def _bf16(a):
    return torch.tensor(_f32(a)).bfloat16()


def _nibbles(packed):
    """[..., HD/2] int8 → the two sign-extended nibble planes, int32."""
    w = np.asarray(packed).astype(np.int32)
    return (w << 28) >> 28, w >> 4


def _rows(rng, shape, H):
    """Random K/V rows with an all-zero row (scale 1e-12) and a head whose
    largest value is negative."""
    rows = rng.normal(0, 0.5, shape).astype(np.float32)
    rows[..., 0, :] = 0
    Dh = shape[-1] // H
    rows[..., 1, :Dh] = -np.abs(rows[..., 1, :Dh]) - 1.0
    return rows


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_quantize_kv_int4_matches_jax(dtype):
    """Packed bytes and scales bit for bit, and the loader's dequantized
    values, for float32 and bf16 rows."""
    H, HD = 16, 768
    rows = _rows(np.random.default_rng(0), (2, 3, 5, HD), H)
    jrows = jnp.asarray(rows, jnp.dtype(dtype))
    trows = torch.tensor(_f32(jrows)).to(getattr(torch, dtype))
    jp, js = jdk.quantize_kv_int4(jrows, H)
    tp, ts = tdk.quantize_kv_int4(trows, H)
    assert tp.dtype == torch.int8 and ts.dtype == torch.float32
    np.testing.assert_array_equal(tp.numpy(), np.asarray(jp))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    assert ts[0, 0, 0, 0].item() == np.float32(1e-12)      # the zero row
    lo, _ = _nibbles(tp.numpy())
    assert lo[0, 0, 1, :HD // H].min() == -7               # negative max
    assert min(x.min() for x in _nibbles(tp.numpy())) >= -7     # never -8
    jl = jrollout._kv_load_int4(jp[0], js[0], H, jnp.bfloat16)
    tl = tdk.kv_load_int4(tp[0], ts[0], H, torch.bfloat16)
    np.testing.assert_array_equal(_f32(tl), _f32(jl))


@pytest.fixture(scope="module")
def packs():
    """One raw bf16 OAR stack (2 layers, d 768, layer norms and biases off
    their init) packed for both weight formats on both sides:
    {kind: (JAX packing, the port's)}, and the int8-quantized stack."""
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
    jw4 = jdk.pack_fused_oar_w4(oar)
    return cfg, {"v5": (jdk.pack_fused_oar(qoar),
                        tq.pack_decode_weights(from_jax(qoar))),
                 "w4": (jw4, from_jax(jw4)), "qoar": qoar}


def _int4_cache(rng, B, H, d):
    """A random int4 cache (K and V), quantized by JAX: (kp, vp, ks, vs)."""
    kvf = rng.normal(0, 0.5, (2, L, B, S, d)).astype(np.float32)
    kp, ks = jdk.quantize_kv_int4(jnp.asarray(kvf[0]), H)
    vp, vs = jdk.quantize_kv_int4(jnp.asarray(kvf[1]), H)
    return kp, vp, ks, vs


def _compare_new_rows(ref, got, cl, Q, what):
    """(kp, vp, ks, vs) of JAX and of the port after a step: the rest of
    the cache untouched; layer 0's new rows and scales equal; elsewhere
    nibbles at most one grid step apart, in fewer than 1% of the new
    entries (measured: at most 0.42%), and scales at most one bf16 ulp
    (2^-7 relative) apart, in fewer than 20% (measured: at most 7 of the 64
    of a B = 1, Q = 2 step — once h differs at all after layer 0, the next
    layer's K/V differ by ~2^-10 relative and a head's largest value rounds
    to the neighbouring bf16 in about a tenth of the heads)."""
    new = slice(cl, cl + Q)
    for i, name in enumerate(("K nibbles", "V nibbles", "K scales",
                              "V scales")):
        r, g = np.asarray(ref[i]), got[i].numpy()
        np.testing.assert_array_equal(g[:, :, :cl], r[:, :, :cl])
        np.testing.assert_array_equal(g[:, :, cl + Q:], r[:, :, cl + Q:])
        np.testing.assert_array_equal(g[0, :, new], r[0, :, new],
                                      err_msg=f"{what}: layer 0 {name}")
        r, g = r[:, :, new], g[:, :, new]
        if i < 2:
            diff = np.stack([np.abs(a - b) for a, b in
                             zip(_nibbles(r), _nibbles(g))])
            assert diff.max() <= 1, (what, name, diff.max())
        else:
            diff = np.abs(r - g)
            assert (diff <= 2.0 ** -7 * np.abs(r)).all(), (what, name)
        frac = (diff != 0).mean()
        assert frac < (0.01 if i < 2 else 0.2), (what, name, frac)


@pytest.mark.parametrize("cache_len", [0, 300])
@pytest.mark.parametrize("Q", [1, 2, 6])
@pytest.mark.parametrize("B", [1, 2])
@pytest.mark.parametrize("kind", ["v5", "w4"])
def test_i4_plain_matches_jax(packs, interpret_kernels, kind, B, Q, cache_len):
    """The plain int4 steps against fused_decode_step_{v5,w4}[mq]i4 in
    interpret mode: h within 4 bf16 ulps of its scale, new rows and scales
    as `_compare_new_rows` bounds them; written in place; no kernel
    launched."""
    cfg, both = packs
    jpacked, tpacked = both[kind]
    H, d = cfg.n_head, cfg.n_embd
    rng = np.random.default_rng(100 * B + 10 * Q + cache_len)
    cache = _int4_cache(rng, B, H, d)
    x = jnp.asarray(rng.normal(0, 1, (B, Q, d)), jnp.bfloat16)
    name = f"fused_decode_step_{kind}{'mq' if Q > 1 else ''}i4"
    ref = exact(getattr(jdk, name), jpacked, x, *cache,
                jnp.int32(cache_len), n_head=H)
    tcache = [torch.tensor(np.asarray(a)) for a in cache]
    out = getattr(tdk, name)(tpacked, _bf16(x), *tcache, cache_len, n_head=H)
    assert all(o is t for o, t in zip(out[1:], tcache))    # written in place
    a, b = _f32(ref[0]), _f32(out[0])
    assert np.abs(a - b).max() <= 4 * 2.0 ** -8 * np.abs(a).max()
    _compare_new_rows(ref[1:], out[1:], cache_len, Q, name)
    assert not any(tdk.LAUNCHES[n] for n in I4_NAMES)


@pytest.mark.parametrize("Q,fused,kind", [
    (1, True, "v5"), (6, True, "v5"), (9, True, "v5"), (1, True, "w4"),
    (6, True, "w4"), (1, False, "v5"), (2, False, "v5")])
def test_oar_step_int4_matches_jax(packs, interpret_kernels, Q, fused, kind):
    """Rollout.oar_step on a PackedKV cache, both packages from the same
    int8-quantized stack.  Fused on: Q = 1 goes to v5i4 and 1 < Q·H <= 128
    to v5mqi4 on both sides — w4i4 and w4mqi4 under W4A8 packing —
    (rollout.py:347-376), Q·H > 128 to the eager body; fused off: the eager body (prefix dequantized per layer, new rows
    re-quantized per (row, head)).  ln_oar(h) within 4 bf16 ulps of its
    scale — the eager bodies are the same bf16 ops in float32 sums of
    another order — and the new rows as `_compare_new_rows` bounds them."""
    cfg, both = packs
    cfg = cfg.replace(oar_cache_dtype="int4", fused_oar_kernel=fused,
                      tar_mode="temporal_cache")
    H, d, B, cl = cfg.n_head, cfg.n_embd, 2, 200
    rng = np.random.default_rng(Q)
    ln = jnp.asarray(1 + 0.1 * rng.normal(size=d), jnp.bfloat16)
    jparams = {"oar": both["qoar"], "ln_oar": {"w": ln},
               "oar_packed": both[kind][0]}
    tparams = dict(from_jax({k: jparams[k] for k in ("oar", "ln_oar")}),
                   oar_packed=both[kind][1])
    kp, vp, ks, vs = _int4_cache(rng, B, H, d)
    x = jnp.asarray(rng.normal(0, 1, (B, Q, d)), jnp.bfloat16)
    jro = jrollout.Rollout(JUMGen(cfg))
    h_ref, jk, jv = exact(jax.jit(jro.oar_step), jparams, x,
                          jrollout.PackedKV(kp, ks),
                          jrollout.PackedKV(vp, vs), jnp.int32(cl))
    ro = Rollout(UMGen(cfg))
    hits = []
    real = {n: getattr(tdk, n) for n in I4_NAMES}
    try:
        for n in I4_NAMES:
            setattr(tdk, n, lambda *a, _n=n, **k: (hits.append(_n),
                                                   real[_n](*a, **k))[1])
        tk = PackedKV(torch.tensor(np.asarray(kp)), torch.tensor(np.asarray(ks)))
        tv = PackedKV(torch.tensor(np.asarray(vp)), torch.tensor(np.asarray(vs)))
        h, ok, ov = ro.oar_step(tparams, _bf16(x), tk, tv, cl)
    finally:
        for n in I4_NAMES:
            setattr(tdk, n, real[n])
    want = [] if not fused or Q * H > 128 else \
        [f"fused_decode_step_{kind}{'mq' if Q > 1 else ''}i4"]
    assert hits == want
    assert isinstance(ok, PackedKV) and ok.packed is tk.packed \
        and ov.scale is tv.scale                           # written in place
    a, b = _f32(h_ref), _f32(h)
    assert np.abs(a - b).max() <= 4 * 2.0 ** -8 * np.abs(a).max()
    _compare_new_rows((jk.packed, jv.packed, jk.scale, jv.scale),
                      (tk.packed, tv.packed, tk.scale, tv.scale), cl, Q,
                      f"oar_step Q={Q} fused={fused}")


def test_init_kv_and_segment_views_int4():
    """`init_kv` under oar_cache_dtype="int4" gives JAX's shapes and types;
    `_sliced` hands out prefix views whose writes land in the full cache,
    and `_unsliced` returns the full cache with the part's embedding."""
    cfg = ModelConfig(oar_cache_dtype="int4", fused_oar_kernel=True,
                      tar_mode="temporal_cache").scaled("tiny")
    jk, jv = jrollout.Rollout(JUMGen(cfg)).init_kv(3)
    ro = Rollout(UMGen(cfg))
    kv_k, kv_v = ro.init_kv(3)
    for j, t in ((jk, kv_k), (jv, kv_v)):
        assert isinstance(t, PackedKV)
        assert tuple(t.packed.shape) == j.packed.shape == (1, 3, 2208, 32)
        assert tuple(t.scale.shape) == j.scale.shape == (1, 3, 2208, 4)
        assert t.packed.dtype == torch.int8 and j.packed.dtype == jnp.int8
        assert t.scale.dtype == torch.float32 and j.scale.dtype == jnp.float32
        assert not t.packed.any() and not t.scale.any()
    assert kv_k.packed.data_ptr() != kv_v.packed.data_ptr()
    assert _kv_rows(kv_k) == 2208 and _kv_rows(kv_k.packed) == 2208
    state = OarState(kv_k, kv_v, torch.zeros(3, 1, cfg.n_embd))
    part = ro._sliced(state, 1032)
    assert _kv_rows(part.kv_k) == 1032 and part.kv_v.scale.shape[2] == 1032
    part.kv_k.packed[0, 1, 1000] = 5
    part.kv_v.scale[0, 2, 1031] = 0.25
    assert kv_k.packed[0, 1, 1000, 0] == 5 and kv_v.scale[0, 2, 1031, 3] == 0.25
    back = ro._unsliced(state, part._replace(prev_emb=torch.ones(3, 1, 64)))
    assert back.kv_k is kv_k and back.kv_v is kv_v
    assert back.prev_emb.min() == 1


def test_i4_wrappers_check_their_arguments(packs):
    """An int4 wrapper refuses the other weight format, a Q outside its
    range and a call without scale planes; its C entry takes the int8
    cache's arguments plus the scale planes, the S-block rows last (the
    flags exist on the int8 cache only)."""
    cfg, both = packs
    H, d = cfg.n_head, cfg.n_embd
    x = torch.zeros(2, 2, d, dtype=torch.bfloat16)
    kv = torch.zeros(L, 2, 64, d // 2, dtype=torch.int8)
    sc = torch.zeros(L, 2, 64, H)
    v5, w4 = both["v5"][1], both["w4"][1]
    with pytest.raises(ValueError, match="got int8"):
        tdk.fused_decode_step_w4mqi4(v5, x, kv, kv.clone(), sc, sc.clone(), 0,
                                     H)
    with pytest.raises(ValueError, match="got W4A8"):
        tdk.fused_decode_step_v5i4(w4, x[:, :1], kv, kv.clone(), sc,
                                   sc.clone(), 0, H)
    with pytest.raises(ValueError, match="one row per scene"):
        tdk.fused_decode_step_v5i4(v5, x, kv, kv.clone(), sc, sc.clone(), 0,
                                   H)
    with pytest.raises(ValueError, match="1 < Q"):
        tdk.fused_decode_step_v5mqi4(v5, x[:, :1], kv, kv.clone(), sc,
                                     sc.clone(), 0, H)
    with pytest.raises(ValueError, match="scale planes"):
        tdk._step("fused_decode_step_v5i4", v5, x[:, :1], kv, kv.clone(), 0,
                  H)
    for w4_ in (False, True):
        i8 = tdk._argtypes(w4_, False)
        cut = len(tdk._ARGS_HEAD) + (2 if w4_ else 4) + len(tdk._ARGS_KV)
        rest = i8[cut:] if w4_ else i8[cut:-2] + i8[-1:]      # no flags
        assert tdk._argtypes(w4_, True) == i8[:cut] + tdk._ARGS_KV + rest
