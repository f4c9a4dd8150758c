"""The JAX CLI's TAR-side options in the port, against the JAX package:
W4 TAR weights (`--tar_w4`), int2 TAR rings (`--kv_dtype int2`) and the
relative temporal PE (`--temporal_pe relative`).

W4: `quantize_params_w4`'s bytes and scales bit-equal to JAX's, from raw
and from int8 leaves, and `linear`'s `wq4` branch within 1 bf16 ulp of
JAX's (the same dequantized bf16 weight; the product's float32 sums in
another order).  int2: `q2_pack` / `q2_unpack` and both quantizers bit-equal
on the same inputs; the rings a prefill writes hold K/V a float32 summation
order apart from JAX's, so a level differs only where the value before
rounding lies within Q2_EDGE of a level edge — those are counted and
printed (Q2_TIES caps their share).

The cached cascade of each option at the tiny scale in bf16 (a 3-frame
window, B = 2, JAX's parameters through `params.from_jax`, int8 decode
weights, the JAX side compiled with `xla_allow_excess_precision` off): the
prefill's priors, and one cached frame's ego logits and priors read from
JAX's rings, within 4 bf16 ulps of their scale (tests/test_torch_recompute.py's
bound); recompute's ego logits and priors for the relative PE too.  The
relative PE's table `tpe_rel` is seeded nonzero (JAX initializes it to
zeros).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from umgen_tpu.config import ModelConfig
from umgen_tpu.data.synthetic import make_token_batch
from umgen_tpu.models import modules as jnn
from umgen_tpu.models.umgen import UMGen as JUMGen
from umgen_tpu.runtime.quantize import ALL_STACK_KEYS
from umgen_tpu.runtime.quantize import quantize_params_int8 as j_int8
from umgen_tpu.runtime.quantize import quantize_params_w4 as j_w4
from umgen_tpu_torch.models import modules as tnn
from umgen_tpu_torch.models.umgen import UMGen
from umgen_tpu_torch.params import from_jax
from umgen_tpu_torch.runtime import quantize as tq

from test_torch_slice import _close, _exact_jit, _f32

# an int2 level may differ from JAX's only where the value before rounding
# (x / (chan·s) - 0.5, in [-2, 1]) lies this close to a level edge: K/V one
# bf16 ulp apart (2^-8 relative, at most 1.5 levels) and the scale and the
# equalizer a bf16 ulp of their maxima apart move it by < 2^-6
Q2_EDGE = 2.0 ** -5
# ... and in at most this share of a ring's values (printed by the test)
Q2_TIES = 0.03
B, T = 2, 3


@pytest.fixture(autouse=True)
def two_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _cfg(**kw):
    base = dict(sample_method="greedy", tar_mode="temporal_cache",
                tar_cache_dtype="bfloat16", oar_cache_dtype="int8",
                tar_cache_window=20)
    return ModelConfig(**{**base, **kw}).scaled("tiny")


def _torch(tree):
    return {m: torch.tensor(np.asarray(v), dtype=torch.long)
            for m, v in tree.items()}


@pytest.fixture(scope="module")
def jparams():
    """JAX's tiny parameters, int8 over DECODE_KEYS, `tpe_rel` seeded."""
    p = j_int8(JUMGen(_cfg()).init_params(jax.random.PRNGKey(0)))
    rng = np.random.default_rng(3)
    p["tpe_rel"] = jnp.asarray(rng.normal(0, 0.5, p["tpe_rel"].shape),
                               jnp.float32)
    return p


# ---------------------------------------------------------------------------
# W4 TAR weights
# ---------------------------------------------------------------------------
def _w4_leaves(tree, path=""):
    if isinstance(tree, dict):
        if "wq4" in tree:
            yield path, tree
        for k, v in tree.items():
            yield from _w4_leaves(v, f"{path}/{k}")


@pytest.mark.parametrize("start", ["raw", "int8"])
def test_quantize_params_w4_matches_jax(start):
    """`quantize_params_w4` from raw bf16 leaves and from int8 ones (the
    serving order: int8 on every stack first): every TAR-family leaf's
    nibbles and group scales bit-equal to JAX's, biases kept, the other
    subtrees untouched."""
    jp = JUMGen(_cfg()).init_params(jax.random.PRNGKey(1))
    if start == "int8":
        jp = j_int8(jp, ALL_STACK_KEYS)
    ref = j_w4(jp)
    got = tq.quantize_params_w4(from_jax(jp))
    leaves = dict(_w4_leaves(ref))
    assert set(leaves) == set(dict(_w4_leaves(got))) and len(leaves) > 30
    for path, mine in _w4_leaves(got):
        want = leaves[path]
        assert set(mine) == set(want), path
        assert mine["wq4"].dtype == torch.int8, path
        np.testing.assert_array_equal(mine["wq4"].numpy(),
                                      np.asarray(want["wq4"]), err_msg=path)
        np.testing.assert_array_equal(mine["ws4"].numpy(),
                                      np.asarray(want["ws4"]), err_msg=path)
    np.testing.assert_array_equal(
        got["oar"]["attn"]["qkv"][("wq" if start == "int8" else "w")]
        .float().numpy(),
        np.asarray(jp["oar"]["attn"]["qkv"]["wq" if start == "int8"
                                            else "w"], np.float32))


@pytest.mark.parametrize("shape", [(64, 192), (256, 96)])
def test_linear_wq4_matches_jax(shape):
    """`linear` on a group-int4 leaf (G = in at in = 64, 128 at 256) over
    bf16 activations: within 1 bf16 ulp of JAX's output (2^-8 of |y|,
    elementwise), the dequantized weight the same bf16 values."""
    rng = np.random.default_rng(5)
    K, N = shape
    w = jnp.asarray(rng.normal(0, 0.05, (K, N)), jnp.bfloat16)
    p = j_w4({"tar": {"qkv": {"w": w, "b": jnp.asarray(
        rng.normal(0, 0.1, N), jnp.bfloat16)}}})["tar"]["qkv"]
    x = jnp.asarray(rng.normal(0, 1, (3, 7, K)), jnp.bfloat16)
    ref = _f32(_exact_jit(jnn.linear)(p, x))
    y = tnn.linear(from_jax(p), torch.tensor(_f32(x)).bfloat16())
    assert y.dtype == torch.bfloat16
    ulp = 2.0 ** (np.floor(np.log2(np.maximum(np.abs(ref), 2.0 ** -20)))
                  - 7)
    assert (np.abs(_f32(y) - ref) <= ulp).all()


# ---------------------------------------------------------------------------
# int2 rings: packers and quantizers
# ---------------------------------------------------------------------------
def test_q2_pack_round_trip():
    rng = np.random.default_rng(0)
    q = rng.integers(-2, 2, size=(5, 3, 48)).astype(np.int8)
    packed = tnn.q2_pack(torch.tensor(q))
    assert packed.dtype == torch.int8 and packed.shape == (5, 3, 12)
    np.testing.assert_array_equal(packed.numpy(),
                                  np.asarray(jnn.q2_pack(jnp.asarray(q))))
    for j in range(4):
        np.testing.assert_array_equal(tnn.q2_unpack(packed, j).numpy(),
                                      q[..., j::4])


def test_ring_q2_quantizers_match_jax():
    """The cached write (`_ring_q2_quantize_layer`, a frozen equalizer) and
    the prefill's (the window's equalizer, its last frames kept) on the
    same bf16 K/V: JAX's nibbles, scales and equalizers bit for bit; a zero
    (scene, head) takes the 1e-6 floor."""
    rng = np.random.default_rng(1)
    S, H, Dh = 5, 4, 16
    x = jnp.asarray(rng.normal(0, 2, (B * S, H, Dh)), jnp.bfloat16)
    x = x.at[:S, 1].set(0)
    chan = jnp.asarray(rng.uniform(0.5, 3, (B, H, Dh)), jnp.float32)
    got = UMGen._ring_q2_quantize_layer(torch.tensor(_f32(x)).bfloat16(), B,
                                        torch.tensor(np.asarray(chan)))
    ref = JUMGen._ring_q2_quantize_layer(x, B, chan)
    for a, b in zip(got, ref):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    a = jnp.asarray(rng.normal(0, 2, (B * S, 4, H, Dh)), jnp.bfloat16)
    keep = 3
    packed, s, c = UMGen._ring_q2_quantize_window(
        torch.tensor(_f32(a)).bfloat16(), B, keep)
    # JAX's prefill quantizer, as its ring() body computes it
    af = a.astype(jnp.float32).reshape(B, S, 4, H, Dh)
    jc = jnp.maximum(jnp.max(jnp.abs(af), axis=(1, 2)), 1e-6)
    ae = af / jc[:, None, None]
    js = jnp.maximum(jnp.max(jnp.abs(ae), axis=(1, 4)), 1e-6) * (1.0 / 1.5)
    jq = jnp.clip(jnp.round(ae / js[:, None, :, :, None] - 0.5), -2, 1)
    jpk = jnn.q2_pack(jq.astype(jnp.int8).reshape(B * S, 4, H, Dh))
    np.testing.assert_array_equal(packed.numpy(), np.asarray(jpk)[:, -keep:])
    np.testing.assert_array_equal(s.numpy(), np.asarray(js)[:, -keep:])
    np.testing.assert_array_equal(c.numpy(), np.asarray(jc))


@pytest.mark.parametrize("ring", ["int2", "bf16_bias"])
def test_block_tar_decode_deferred_matches_jax(ring):
    """The deferred ring read's int2 branch (equalized query, the +0.5
    offset's rank-1 terms, the equalizer on y) and the relative PE's
    ring and self biases on a bf16 ring: y, k_new, v_new within 4 bf16 ulps
    of JAX's scale, as the int4 branch is held (tests/test_torch_rings.py)."""
    D, H, S, Tm = 64, 4, 10, 5
    p = jnn.init_block_tar(jax.random.PRNGKey(0), D, False, jnp.bfloat16)
    rng = np.random.default_rng(4)
    p = jax.tree.map(lambda a: jnp.asarray(
        np.asarray(a, np.float32) + 0.05 * rng.normal(size=a.shape),
        a.dtype), p)
    x = jnp.asarray(rng.normal(0, 1, (B, S, D)), jnp.bfloat16)
    def uniform(lo, hi, shape):
        return jnp.asarray(rng.uniform(lo, hi, shape), jnp.float32)

    if ring == "int2":
        rk, rv = (jnp.asarray(rng.integers(-128, 128,
                                           (B * S, Tm, H, D // H // 4)),
                              jnp.int8) for _ in range(2))
        arrays = {"ring_scale_k": uniform(0.02, 0.2, (B, Tm, H)),
                  "ring_scale_v": uniform(0.02, 0.2, (B, Tm, H)),
                  "ring_chan_k": uniform(0.5, 3, (B, H, D // H)),
                  "ring_chan_v": uniform(0.5, 3, (B, H, D // H))}
        static = {"ring_bits": 2}
    else:
        rk, rv = (jnp.asarray(rng.normal(0, 1, (B * S, Tm, H, D // H)),
                              jnp.bfloat16) for _ in range(2))
        arrays = {"t_bias_ring": uniform(-1, 1, (H, Tm)),
                  "t_bias_self": uniform(-1, 1, (H,))}
        static = {}
    tp = from_jax(p)
    rk_t, rv_t = from_jax({"k": rk, "v": rv}).values()
    targs = from_jax(arrays)
    for slot, n_valid in ((2, 3), (0, 5)):
        def fn(p, x, a, b, e, slot=slot, n_valid=n_valid):
            return jnn.block_tar_decode_deferred(p, x, H, a, b, slot,
                                                 n_valid, **e, **static)
        ref = _exact_jit(fn)(p, x, rk, rv, arrays)
        got = tnn.block_tar_decode_deferred(
            tp, torch.tensor(_f32(x)).bfloat16(), H, rk_t, rv_t, slot,
            n_valid, **targs, **static)
        for a, b, what in zip(got, ref, ("y", "k", "v")):
            err = np.abs(_f32(a) - _f32(b)).max()
            assert err <= 4 * 2.0 ** -8 * np.abs(_f32(b)).max(), (what, slot)


# ---------------------------------------------------------------------------
# the cached cascade under each option
# ---------------------------------------------------------------------------
CASES = {"int2": dict(tar_cache_dtype="int2"),
         "w4": dict(),
         "relative": dict(temporal_pe_mode="relative")}


def _edge_dist(v):
    """Distance of pre-round values to the nearest rounding edge (k + 1/2)."""
    return np.abs(np.abs(v - np.floor(v)) - 0.5)


class _Q2Log:
    """Records the inputs of the port's int2 ring writes, in call order."""

    def __init__(self, monkeypatch):
        self.calls = []
        win, layer = UMGen._ring_q2_quantize_window, \
            UMGen._ring_q2_quantize_layer

        def window(a, B, keep):
            out = win(a, B, keep)
            af = a.float().reshape(B, -1, *a.shape[1:])
            self.calls.append(
                af[:, :, -keep:] / out[2][:, None, None]
                / out[1][:, None, :, :, None] - 0.5)
            return out

        def one(x, B, chan):
            out = layer(x, B, chan)
            xf = x.float().reshape(B, -1, *x.shape[1:]) / chan[:, None]
            self.calls.append(xf / out[1][:, None, :, None] - 0.5)
            return out

        monkeypatch.setattr(UMGen, "_ring_q2_quantize_window",
                            staticmethod(window))
        monkeypatch.setattr(UMGen, "_ring_q2_quantize_layer",
                            staticmethod(one))


def _unpack2(packed):
    return np.stack([tnn.q2_unpack(torch.tensor(np.asarray(packed)),
                                   j).numpy() for j in range(4)], axis=-1)


def _compare_q2_rings(jcache, cache, pre, slots, what):
    """Every stack's int2 rings, JAX's against the port's: scales and
    equalizers within 2^-7 of their own size (a bf16 ulp of the K/V values
    they are maxima of), levels equal except at most one step apart where
    the port's pre-round value (`pre`, the ring writes in call order: for
    each stack k then v) lies within Q2_EDGE of an edge, in at most Q2_TIES
    of the written values.  Returns the count of levels apart."""
    off = total = 0
    it = iter(pre)
    for name in ("ego_tar", "tar", "map_tar", "box_tar"):
        j = [np.asarray(a) for a in jcache[name]]
        t = [a.numpy() for a in cache[name]]
        for ref, got in zip(j[2:], t[2:]):          # scales, equalizers
            assert np.all(np.abs(got - ref) <= 2.0 ** -7 * np.abs(ref)), \
                (what, name)
        N, _, H, Dq = j[0].shape[1:]
        shape = (N, len(slots), H, 4 * Dq)
        for i in (0, 1):
            v = next(it).numpy().reshape(shape)
            lv_j = _unpack2(j[i][0])[:, slots].reshape(shape)
            lv_t = _unpack2(t[i][0])[:, slots].reshape(shape)
            d = np.abs(lv_j.astype(int) - lv_t.astype(int))
            assert d.max() <= 1, (what, name, i)
            assert (_edge_dist(v)[d != 0] <= Q2_EDGE).all(), \
                (what, name, i, _edge_dist(v)[d != 0].max())
            off += int((d != 0).sum())
            total += d.size
    assert off <= Q2_TIES * total, (what, off, total)
    print(f"{what}: {off} of {total} int2 ring levels ({off / total:.4%}) "
          "one step from JAX's, each within Q2_EDGE of a level edge")
    return off


def _close_rings(jcache, cache, what):
    """bf16 rings: within 4 bf16 ulps of each ring's max |.|."""
    for name in ("ego_tar", "tar", "map_tar", "box_tar"):
        for ja, ta in zip(jcache[name], cache[name]):
            _close(ta, ja, f"{what} {name}")


@pytest.mark.parametrize("case", list(CASES))
def test_cached_cascade_matches_jax(case, jparams, monkeypatch):
    """The full-window prefill (ego and TAR rings) and one cached frame
    read from JAX's rings, under int2 rings, W4 TAR weights or the
    relative PE: priors and ego logits within 4 bf16 ulps; the rings by
    the write rule (int2) or within 4 bf16 ulps (bf16 rings).  int2 by
    chunked ingest keeps the equalizers at ones on both sides."""
    cfg = _cfg(**CASES[case])
    jm, model = JUMGen(cfg), UMGen(cfg)
    jp = j_w4(jparams) if case == "w4" else jparams
    params = from_jax(jp)
    log = _Q2Log(monkeypatch) if case == "int2" else None
    cond = make_token_batch(jm.layout, T=T, B=B, seed=0, config=cfg)
    jin = {m: jnp.asarray(v) for m, v in cond.items()}
    nxt = jnp.asarray(np.roll(cond["pose"], -1, axis=1))
    shifted = dict(jin, pose=nxt)
    j_ego, jc = _exact_jit(jm.prefill_ego_cache)(jp, jin, {})
    jpri = _exact_jit(jm.prefill_tar_caches)(jp, shifted, jc)
    ego, tc = model.prefill_ego_cache(params, _torch(cond), {})
    pri = model.prefill_tar_caches(params, _torch(shifted), tc)
    _close(ego, j_ego, "prefill ego logits")
    _close(pri["prior_seq"], jpri["prior_seq"], "prefill priors")
    if case == "int2":
        _compare_q2_rings(jpri["cache"], pri["cache"], log.calls,
                          list(range(T)), "prefill")
        log.calls.clear()
    else:
        _close_rings(jpri["cache"], pri["cache"], "prefill")
    # one cached frame from JAX's rings (frame T, ring slot T)
    frame = {m: v[:, -1:] for m, v in jin.items()}
    cache = {k: (v if k == "frames" else
                 tuple(from_jax({"a": a})["a"] for a in v))
             for k, v in jpri["cache"].items()}
    af = jnp.asarray(T, jnp.int32)
    j_ego1, jc1 = _exact_jit(jm.ego_logits_cached)(jp, frame,
                                                  jpri["cache"], af)
    jstep = _exact_jit(jm.tar_priors_cached)(jp, dict(frame, pose=nxt[:, -1:]),
                                             jc1, af)
    ego1, c1 = model.ego_logits_cached(params, _torch(frame), cache, T)
    step = model.tar_priors_cached(params, _torch(dict(frame,
                                                       pose=nxt[:, -1:])),
                                   c1, T)
    _close(ego1, j_ego1, "cached ego logits")
    _close(step["prior_seq"], jstep["prior_seq"], "cached priors")
    if case == "int2":
        _compare_q2_rings(jstep["cache"], step["cache"], log.calls, [T],
                          "cached step")
        # chunked ingest starts from ones and keeps them
        ring = model.init_tar_cache(B)["tar"]
        assert len(ring) == 6 and torch.equal(ring[4], torch.ones_like(
            ring[4]))
        jring = jm.init_tar_cache(B)["tar"]
        assert all(tuple(a.shape) == b.shape for a, b in zip(ring, jring))


def test_relative_pe_recompute_matches_jax(jparams):
    """Recompute mode under the relative PE (the window's [H, T, T] bias on
    every temporal attention, the embeddings without the temporal table):
    ego logits and priors within 4 bf16 ulps of JAX's; with a nonzero
    `tpe_rel` they differ from the absolute mode's."""
    cfg = _cfg(tar_mode="recompute", temporal_pe_mode="relative")
    jm, model = JUMGen(cfg), UMGen(cfg)
    params = from_jax(jparams)
    cond = make_token_batch(jm.layout, T=T, B=B, seed=0, config=cfg)
    jin = {m: jnp.asarray(v) for m, v in cond.items()}
    _close(model.ego_logits(params, _torch(cond)),
           _exact_jit(jm.ego_logits)(jparams, jin), "ego logits")
    pri = model.tar_priors(params, _torch(cond))["prior_seq"]
    _close(pri, _exact_jit(jm.tar_priors)(jparams, jin)["prior_seq"],
           "priors")
    absolute = UMGen(cfg.replace(temporal_pe_mode="absolute")).tar_priors(
        params, _torch(cond))["prior_seq"]
    assert not torch.equal(pri, absolute)


def test_int2_rings_need_head_dim_a_multiple_of_4():
    cfg = _cfg(tar_cache_dtype="int2").replace(n_embd=72, n_head=4)
    assert cfg.head_dim == 18
    with pytest.raises(ValueError, match="int2.*multiple of 4"):
        UMGen(cfg).init_tar_cache(1)
