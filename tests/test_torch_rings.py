"""The port's int4 TAR rings against the JAX package's.

int4 rings (`tar_cache_dtype="int4"`) hold each frame's temporal K/V
nibble-packed (two head dims a byte, even dim in the low nibble) with one
float32 scale per (layer, scene, frame, head): max |.| / 7.  The packers
and quantizers are integer and elementwise float32 code, bit-equal to
JAX's.  Whole blocks and stacks are compared as tests/test_torch_modules.py
compares them, and the rings written by a prefill hold values quantized
from K/V that differ from JAX's by float32 summation order: a value on a
rounding boundary of the int4 grid lands one step apart, and those entries
are counted.

The JAX side is compiled with XLA's `xla_allow_excess_precision` off, so
that it rounds to bf16 where its code says (tests/test_torch_w4.py).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from umgen_tpu.config import ModelConfig
from umgen_tpu.data.synthetic import make_token_batch
from umgen_tpu.models import modules as jnn
from umgen_tpu.models.rollout import Rollout as JRollout
from umgen_tpu.models.umgen import UMGen as JUMGen
from umgen_tpu.runtime.quantize import ALL_STACK_KEYS
from umgen_tpu.runtime.quantize import quantize_params_int8 as j_quantize
from umgen_tpu_torch import params as tparams
from umgen_tpu_torch.models import modules as tnn
from umgen_tpu_torch.models.rollout import Rollout
from umgen_tpu_torch.models.umgen import UMGen
from umgen_tpu_torch.runtime.quantize import pack_fused

EXACT = {"xla_allow_excess_precision": False}
D, H = 64, 4


def exact(fn, *args):
    """Run the jitted JAX function `fn` compiled with EXACT."""
    return fn.lower(*args).compile(compiler_options=EXACT)(*args)


def _t(a, dtype=None):
    t = torch.tensor(np.asarray(jnp.asarray(a, jnp.float32)))
    return t.to(dtype) if dtype is not None else t


def _f32(a):
    if isinstance(a, torch.Tensor):
        return a.float().numpy()
    return np.asarray(jnp.asarray(a, jnp.float32))


def test_q4_pack_round_trip():
    rng = np.random.default_rng(0)
    q = rng.integers(-7, 8, size=(5, 3, 48)).astype(np.int8)
    packed = tnn.q4_pack(torch.tensor(q))
    assert packed.dtype == torch.int8 and packed.shape == (5, 3, 24)
    np.testing.assert_array_equal(packed.numpy(),
                                  np.asarray(jnn.q4_pack(jnp.asarray(q))))
    np.testing.assert_array_equal(tnn.q4_unpack_even(packed).numpy(),
                                  q[..., 0::2])
    np.testing.assert_array_equal(tnn.q4_unpack_odd(packed).numpy(),
                                  q[..., 1::2])


def test_ring_quantizers_match_jax():
    rng = np.random.default_rng(1)
    B, S, L, Dh = 3, 5, 2, 16
    x = jnp.asarray(rng.normal(0, 2, (L, B * S, H, Dh)), jnp.bfloat16)
    x = x.at[0, :S].set(0)               # a zero (scene, head): the 1e-6 floor
    for got, ref in (
            (UMGen._ring_q4_quantize(_t(x, torch.bfloat16), B),
             JUMGen._ring_q4_quantize(x, B)),
            (UMGen._ring_q4_quantize_layer(_t(x[1], torch.bfloat16), B),
             JUMGen._ring_q4_quantize_layer(x[1], B))):
        np.testing.assert_array_equal(got[0].numpy(), np.asarray(ref[0]))
        np.testing.assert_array_equal(got[1].numpy(), np.asarray(ref[1]))
        assert got[0].dtype == torch.int8 and got[1].dtype == torch.float32


@pytest.fixture(scope="module")
def block():
    p = jnn.init_block_tar(jax.random.PRNGKey(0), D, False, jnp.bfloat16)
    rng = np.random.default_rng(0)
    p = jax.tree.map(lambda a: jnp.asarray(
        np.asarray(a, np.float32) + 0.05 * rng.normal(size=a.shape),
        a.dtype), p)
    return p, tparams.from_jax(p)


def test_block_tar_decode_deferred_int4_matches_jax(block):
    """The int4 branch (scales folded into the logits and the bf16 softmax
    weights) within 4 bf16 ulps of the output's scale, as the bf16 branch
    is held in tests/test_torch_modules.py."""
    jp, tp = block
    rng = np.random.default_rng(4)
    B, S, T = 2, 10, 5
    x = jnp.asarray(rng.normal(0, 1, (B, S, D)), jnp.bfloat16)
    rk, rv = (jnp.asarray(rng.integers(-7, 8, (B * S, T, H, D // H // 2)),
                          jnp.int8) for _ in range(2))
    sk, sv = (jnp.asarray(rng.uniform(0.02, 0.2, (B, T, H)), jnp.float32)
              for _ in range(2))
    for slot, n_valid in ((2, 3), (4, 5), (0, 5)):
        def fn(p, x, a, b, c, d, slot=slot, n_valid=n_valid):
            return jnn.block_tar_decode_deferred(p, x, H, a, b, slot,
                                                 n_valid, ring_scale_k=c,
                                                 ring_scale_v=d)
        y_j, k_j, v_j = exact(jax.jit(fn), jp, x, rk, rv, sk, sv)
        y_t, k_t, v_t = tnn.block_tar_decode_deferred(
            tp, _t(x, torch.bfloat16), H, torch.tensor(np.asarray(rk)),
            torch.tensor(np.asarray(rv)), slot, n_valid,
            ring_scale_k=torch.tensor(np.asarray(sk)),
            ring_scale_v=torch.tensor(np.asarray(sv)))
        for port, ref, what in ((y_t, y_j, "y"), (k_t, k_j, "k"),
                                (v_t, v_j, "v")):
            a, b = _f32(ref), _f32(port)
            assert np.abs(a - b).max() <= 4 * 2.0 ** -8 * np.abs(a).max(), \
                (what, slot)


def _cfg():
    return ModelConfig(sample_method="greedy", tar_mode="temporal_cache",
                       tar_cache_dtype="int4", oar_cache_dtype="int8",
                       fused_oar_kernel=True, chunked_prefill=True,
                       tar_cache_window=2).scaled("tiny")


@pytest.fixture()
def two_threads():
    # the suite runs several workers on the same cores; torch's default of
    # one intra-op thread per core oversubscribes them
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def models():
    cfg = _cfg()
    jmodel = JUMGen(cfg)
    jparams = j_quantize(jmodel.init_params(jax.random.PRNGKey(0)),
                         ALL_STACK_KEYS)
    B, T = 2, 3
    cond = make_token_batch(jmodel.layout, T=T, B=B, seed=0, config=cfg)
    return cfg, jmodel, jparams, pack_fused(tparams.from_jax(jparams)), cond


def compare_q4_rings(jcache, tcache, what):
    """Every stack's int4 rings, JAX's against the port's: scales within a
    bf16 ulp of JAX's (2^-7 relative: the max |.| of K/V values that may
    differ by one ulp), values equal except one int4 step at rounding ties
    — a K/V value a bf16 ulp away from JAX's crosses a boundary of the grid
    (1/7 of its group's max) for ~1% of the values, so at most 3% of them.
    Returns the count of values one step apart."""
    off = total = 0
    for name in ("tar", "ego_tar", "map_tar", "box_tar"):
        jk, jv, jsk, jsv = (np.asarray(a) for a in jcache[name])
        tk, tv, tsk, tsv = (a.numpy() for a in tcache[name])
        for ref, got in ((jsk, tsk), (jsv, tsv)):
            assert np.all(np.abs(got - ref) <= 2.0 ** -7 * np.abs(ref)), \
                (what, name)
        for ref, got in ((jk, tk), (jv, tv)):
            assert got.shape == ref.shape and got.dtype == np.int8
            for unpack in (tnn.q4_unpack_even, tnn.q4_unpack_odd):
                d = np.abs(unpack(torch.tensor(ref)).numpy().astype(int)
                           - unpack(torch.tensor(got)).numpy().astype(int))
                assert d.max() <= 1, (what, name)
                off += int((d != 0).sum())
                total += d.size
    assert off <= 0.03 * total, (what, off, total)
    print(f"{what}: {off} of {total} int4 ring values one step apart")
    return off


def test_rings_after_prefill_and_chunked_ingest_match_jax(models,
                                                          two_threads):
    """A 3-frame window into 2-frame int4 rings (each ring slot written
    more than once), by the full-window prefill and by chunked ingest:
    the same ring bytes and scales as JAX's, up to rounding ties."""
    cfg, jmodel, jparams, params, cond = models
    model = UMGen(cfg)
    B, T = cond["pose"].shape[:2]
    jin = {m: jnp.asarray(v) for m, v in cond.items()}
    tin = {m: torch.as_tensor(v, dtype=torch.long) for m, v in cond.items()}
    nxt = jnp.asarray(np.roll(cond["pose"], -1, axis=1))   # shifted poses

    # full-window prefill
    _, jc = exact(jax.jit(jmodel.prefill_ego_cache), jparams, jin, {})
    shifted = dict(jin, pose=nxt)
    jc = exact(jax.jit(jmodel.prefill_tar_caches), jparams, shifted,
               jc)["cache"]
    _, tc = model.prefill_ego_cache(params, tin, {})
    tc = model.prefill_tar_caches(
        params, dict(tin, pose=torch.tensor(np.asarray(nxt))), tc)["cache"]
    compare_q4_rings(jc, tc, "prefill")

    # chunked: frames 0..T-2 ingested one by one
    jro, ro = JRollout(jmodel), Rollout(model)
    jc = jmodel.init_tar_cache(B)
    tc = model.init_tar_cache(B)
    frames = [{m: v[:, t:t + 1] for m, v in jin.items()} for t in range(T)]
    ingest = jax.jit(jro.ingest_frame).lower(
        jparams, frames[0], jin["pose"][:, 1], jc).compile(
            compiler_options=EXACT)
    for t in range(T - 1):
        jc = ingest(jparams, frames[t], jin["pose"][:, t + 1], jc)
        tc = ro.ingest_frame(params, {m: v[:, t:t + 1]
                                      for m, v in tin.items()},
                             tin["pose"][:, t + 1], tc)
    assert int(jc["frames"]) == tc["frames"] == T - 1
    compare_q4_rings(jc, tc, "chunked ingest")


def test_int4_rings_need_an_even_head_dim():
    """Two head dims share a byte: an odd head_dim is refused by name."""
    cfg = _cfg().replace(n_embd=60, n_head=4)          # head_dim 15
    assert cfg.head_dim == 15
    with pytest.raises(ValueError, match="tar_cache_dtype='int4'.*even"):
        UMGen(cfg).init_tar_cache(1)
    cache = UMGen(_cfg()).init_tar_cache(2)
    k, v, sk, sv = cache["tar"]
    assert k.dtype == v.dtype == torch.int8 and k.shape[-1] == 8
    assert sk.shape == sv.shape == (1, 2, 2, 4) and sk.dtype == torch.float32
