"""The reference's own window semantics in the port, against the JAX package.

Recompute mode (the whole conditioning window through every TAR stack each
frame), fp8 TAR rings, ring refresh, the unfused OAR decode on an fp8 cache
and `--int8 off`, at the tiny scale (config.py `scaled("tiny")`) on the CPU.
Both packages start from the JAX initializer's parameters (int8-quantized
over DECODE_KEYS by the JAX package unless `--int8 off`), handed to the
port through `params.from_jax`.  The JAX side is compiled with XLA's
`xla_allow_excess_precision` off (tests/test_torch_slice.py `_exact_jit`);
its fused decode kernels run in Pallas interpret mode, the port's their
plain versions.

Tolerances, as tests/test_torch_slice.py states them: bf16 outputs (ego
logits, TAR priors) within 4 bf16 ulps of their scale; bf16 greedy
decisions are compared by replaying JAX's decisions in the port, each
decision's logit within GAP_ULPS = 4 ulps of JAX's and the port's argmax
equal to JAX's token wherever JAX's top-2 gap is wider; the tokens equal.
fp8 ring bytes: the write rule is JAX's conversion, byte for byte, on the
same bf16 values; a prefill's rings hold K/V that differ from JAX's by
float32 summation order (a few bf16 ulps of their scale, as the priors), so
where those straddle an fp8 rounding boundary (16 bf16 ulps apart) the
bytes differ: at most FP8_TIES of a ring, each within one fp8 step plus 4
bf16 ulps of the ring's scale.  Ring refresh against recompute in float32
(the JAX package's own test, tests/test_tar_cache.py): >= 0.998 of the
tokens equal.
"""

import contextlib
import functools as ft
import os
import pickle
import re
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from umgen_tpu.config import ModelConfig
from umgen_tpu.data.synthetic import make_token_batch
from umgen_tpu.models import modules as jnn
from umgen_tpu.models.generate import Generator as JGenerator
from umgen_tpu.models.rollout import Rollout as JRollout
from umgen_tpu.models.umgen import UMGen as JUMGen
from umgen_tpu.ops import decode_kernel as jdk
from umgen_tpu.runtime.quantize import quantize_params_int8 as j_quantize
from umgen_tpu_torch import config as tconfig
from umgen_tpu_torch.data.pipeline import ScenePipeline
from umgen_tpu_torch.models import modules as tnn
from umgen_tpu_torch.models.generate import Generator
from umgen_tpu_torch.models.rollout import Rollout
from umgen_tpu_torch.models.umgen import UMGen
from umgen_tpu_torch.ops import decode_kernel as tdk
from umgen_tpu_torch.params import from_jax
from umgen_tpu_torch.runtime.quantize import pack_fused
from umgen_tpu_torch.tools import evaluate

from test_torch_slice import (_check_decisions, _close, _decision_labels,
                              _exact_jit, _f32, _Recorder, _Replay)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# fp8 ring entries apart from JAX's (K/V a float32 summation order apart
# that straddle an fp8 rounding boundary): at most this share of a ring
# (this file prints it: 0.78% of the bytes after the prefill, 0.17% after
# the cached step)
FP8_TIES = 0.03
# ring refresh against recompute, and against JAX's refresh stream, in
# float32: the share of equal tokens (tests/test_tar_cache.py's bound)
AGREE = 0.998


@pytest.fixture(autouse=True)
def two_threads():
    # the suite runs several workers on the same cores
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@contextlib.contextmanager
def _interpret():
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jdk.pl, "pallas_call",
                   ft.partial(pl.pallas_call, interpret=True))
        yield


def _cfg(**kw):
    """The reference CLI's default run at the tiny scale, greedy, in
    recompute mode unless `kw` says otherwise: fp8 rings, the unfused
    decode on an fp8 OAR cache."""
    base = dict(sample_method="greedy", tar_mode="recompute",
                tar_cache_dtype="float8_e4m3fn",
                oar_cache_dtype="float8_e4m3fn", fused_oar_kernel=False,
                tar_cache_window=20)
    return ModelConfig(**{**base, **kw}).scaled("tiny")


def _torch(tree):
    return {m: torch.tensor(np.asarray(v), dtype=torch.long)
            for m, v in tree.items()}


@pytest.fixture(scope="module")
def window():
    """JAX's parameters (int8 over DECODE_KEYS), a 3-frame window of two
    scenes, and JAX's recompute-mode ego logits and TAR priors of its last
    frame (the pose shifted by JAX's greedy ego action)."""
    cfg = _cfg()
    jmodel = JUMGen(cfg)
    jparams = j_quantize(jmodel.init_params(jax.random.PRNGKey(0)))
    cond = make_token_batch(jmodel.layout, T=3, B=2, seed=0, config=cfg)
    jin = {m: jnp.asarray(v) for m, v in cond.items()}
    j_ego = _exact_jit(jmodel.ego_logits)(jparams, jin)
    j_tok = jnp.argmax(j_ego, axis=-1).astype(jnp.int32)
    shifted = dict(jin, pose=jnp.concatenate([jin["pose"], j_tok[:, None]],
                                             axis=1)[:, 1:])
    j_pri = _exact_jit(jmodel.tar_priors)(jparams, shifted)
    return {"cfg": cfg, "jparams": jparams, "params": from_jax(jparams),
            "cond": cond, "j_ego": j_ego, "j_tok": j_tok,
            "shifted": shifted, "j_pri": j_pri}


# ---------------------------------------------------------------------------
# (a) the full-window block, (b) the window's ego logits and priors
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_block_tar_matches_jax(dtype):
    """`block_tar` against the JAX package's over [B, T, S, D] = [2, 3, 10,
    64]: float32 within 2^-18 of the output's scale (summation order only),
    bf16 within 4 bf16 ulps of it; with `collect_kv` the same y."""
    jdt = jnp.dtype(dtype)
    p = jnn.init_block_tar(jax.random.PRNGKey(0), 64, False, jdt)
    rng = np.random.default_rng(0)
    # non-trivial norms and biases
    p = jax.tree.map(lambda a: jnp.asarray(
        np.asarray(a, np.float32) + 0.05 * rng.normal(size=a.shape),
        a.dtype), p)
    x = jnp.asarray(rng.normal(0, 1, (2, 3, 10, 64)), jdt)
    ref = _exact_jit(lambda p, x: jnn.block_tar(p, x, 4))(p, x)
    tp = from_jax(p)
    xt = torch.tensor(_f32(x)).to(getattr(torch, dtype))
    y = tnn.block_tar(tp, xt, 4)
    assert y.dtype == xt.dtype and y.shape == xt.shape
    tol = 2.0 ** -18 if dtype == "float32" else 4 * 2.0 ** -8
    err = np.abs(_f32(y) - _f32(ref)).max()
    assert err <= tol * np.abs(_f32(ref)).max(), err
    y_kv, (k, v) = tnn.block_tar(tp, xt, 4, collect_kv=True)
    assert torch.equal(y_kv, y) and k.shape == v.shape == (20, 3, 4, 16)


def test_ego_logits_and_tar_priors_match_jax(window):
    """Recompute mode's `ego_logits` (the raw window through the ego stack,
    no warp, no grid PE) and `tar_priors` (the shifted window through the
    trunk, map and box stacks, the warped-map residual) over a 3-frame
    window, against the JAX package's: within 4 bf16 ulps of their scale."""
    w = window
    model = UMGen(w["cfg"])
    ego = model.ego_logits(w["params"], _torch(w["cond"]))
    assert ego.shape == (2, 3, 1024)
    _close(ego, w["j_ego"], "ego logits")
    pri = model.tar_priors(w["params"], _torch(w["shifted"]))
    assert set(pri) == {"prior_seq", "pose_diff"}
    _close(pri["prior_seq"], w["j_pri"]["prior_seq"], "priors")
    np.testing.assert_array_equal(_f32(pri["pose_diff"]),
                                  _f32(w["j_pri"]["pose_diff"]))


def test_default_config_constructs():
    """`UMGen(ModelConfig())`: the config's default is recompute mode.
    Every ring type of the JAX package constructs (int2 since the rings
    were ported); an unknown one is refused by name."""
    cfg = tconfig.ModelConfig()
    assert cfg.tar_mode == "recompute"
    model = UMGen(cfg)
    assert model.t_max == 20
    assert UMGen(cfg.replace(tar_cache_dtype="int2")).ring_q2
    with pytest.raises(ValueError, match="unknown TAR ring dtype 'int3'"):
        UMGen(cfg.replace(tar_cache_dtype="int3"))


# ---------------------------------------------------------------------------
# (c) one recompute frame, (d) the recompute rollout
# ---------------------------------------------------------------------------
def _count_steps(monkeypatch):
    """The port's calls of its decode-step wrappers, by name."""
    hits = {}
    for name in [n for n in dir(tdk) if n.startswith("fused_decode_step")]:
        real = getattr(tdk, name)

        def counted(*a, _real=real, _name=name, **k):
            hits[_name] = hits.get(_name, 0) + 1
            return _real(*a, **k)
        monkeypatch.setattr(tdk, name, counted)
    return hits


@pytest.mark.parametrize("fused", [True, False],
                         ids=["fused", "unfused-fp8kv"])
def test_frame_step_matches_jax(window, fused, monkeypatch):
    """One `Rollout.frame_step` frame (the ego action, the pose shift, the
    whole window through every TAR stack, the OAR decode) from the 3-frame
    window of two scenes, greedy, JAX's decisions replayed in the port.
    fused: `--fused_oar`, an int8 OAR cache, v5 / v5mq (their plain
    versions; 2196 steps and 3 pushes).  unfused-fp8kv: the reference
    CLI's default decode — the eager body on an fp8 OAR cache, its rows
    read through `kv_load` and written through `kv_store`, no decode
    kernel.  Ego logits and priors within 4 bf16 ulps, decisions within
    GAP_ULPS, the tokens equal."""
    w = window
    cfg = w["cfg"].replace(**({"fused_oar_kernel": True,
                               "oar_cache_dtype": "int8"} if fused else {}))
    jparams, params = w["jparams"], w["params"]
    if fused:
        jparams = dict(jparams, oar_packed=jdk.pack_fused_oar(
            jparams["oar"]))
        params = pack_fused(params)
    jro = JRollout(JUMGen(cfg))
    rec = _Recorder(jro)
    with _interpret():
        jout = _exact_jit(jro.frame_step)(
            jparams, {m: jnp.asarray(v) for m, v in w["cond"].items()},
            jax.random.PRNGKey(0))
        jax.effects_barrier()
    ro = Rollout(UMGen(cfg))
    replay = _Replay(ro, rec.calls)
    hits = _count_steps(monkeypatch)
    stored = []
    real_store = tdk.kv_store

    def store(x, dtype=torch.int8):
        stored.append(dtype)
        return real_store(x, dtype)

    monkeypatch.setattr(tdk, "kv_store", store)
    tout = ro.frame_step(params, _torch(w["cond"]), torch.Generator())
    lo = ro.layout
    if fused:
        assert hits == {"fused_decode_step_v5": lo.seq_len - 5 - 2 * 3,
                        "fused_decode_step_v5mq": 3}, hits
    else:
        # every step's K/V through the eager body's store, as fp8: 2196
        # single-token steps and 3 pushes, one layer
        assert hits == {}
        assert len(stored) == 2 * (lo.seq_len - 5 - 2 * 3 + 3)
        assert set(stored) == {torch.float8_e4m3fn}
    seen = {"ego logits": _close(tout.ego_logits, w["j_ego"], "ego logits"),
            "priors": _close(tout.prior_seq, w["j_pri"]["prior_seq"],
                             "priors"),
            "decision logits": _check_decisions(
                rec.calls, replay.seen, _decision_labels(lo), frame=1)}
    np.testing.assert_array_equal(tout.tokens.numpy(),
                                  np.asarray(jout.tokens))
    print(f"frame_step ({'fused' if fused else 'unfused, fp8 cache'}), "
          f"deviations from JAX in bf16 ulps: {seen}")


def test_recompute_generate_matches_jax():
    """`Generator.generate` in recompute mode: 3 new frames under a 2-frame
    window (the window slides from the second frame on), one scene, the
    reference CLI's default decode (unfused, fp8 OAR cache), greedy.  JAX's
    Generator runs first with its sampler decisions recorded; the port's
    replays them.  Every frame's decisions within GAP_ULPS of JAX's logits
    and the whole token stream equal to JAX's."""
    cfg = _cfg()
    jmodel = JUMGen(cfg)
    jparams = j_quantize(jmodel.init_params(jax.random.PRNGKey(1)))
    cond = make_token_batch(jmodel.layout, T=2, B=1, seed=1, config=cfg)
    jgen = JGenerator(jmodel, jparams, seed=0)
    rec = _Recorder(jgen.rollout)
    jgen._step_cache["plain"] = _exact_jit(
        lambda p, inp, rng, fd: jgen.rollout.frame_step(
            p, inp, rng, forced_tokens=fd))
    jout = jgen.generate(cond, new_frames=3, cond_frames=2,
                         input_cond_frames=2)
    jax.effects_barrier()

    gen = Generator(UMGen(cfg), from_jax(jparams), device="cpu")
    replay = _Replay(gen.rollout, rec.calls)
    out = gen.generate(cond, new_frames=3, cond_frames=2,
                       input_cond_frames=2)
    assert len(gen.frame_seconds) == 3 and gen.refreshes == 0
    worst = _check_decisions(rec.calls, replay.seen,
                             _decision_labels(gen.model.layout) * 3,
                             frame="1-3")
    for m in jout:
        assert out[m].shape == (1, 5, jout[m].shape[-1])
        np.testing.assert_array_equal(out[m], jout[m], err_msg=m)
    print(f"recompute rollout: decision logits within {worst:.3g} bf16 "
          "ulps of JAX's")


def test_generate_refuses_control():
    """Control and forced streams that do not fit the scenes are refused by
    name before any frame runs: a scene batch other than the window's, a
    row of another length, a stream without its frame axis.  (Trajectory
    replay, agent control and forced streams themselves are served since
    they were ported; tests/test_torch_generate_control*.py hold them
    against JAX.)"""
    gen = Generator(UMGen(_cfg()), {}, device="cpu")
    cond = {m: np.zeros((1, 2, n), np.int64) for m, n in
            (("pose", 3), ("map", 1024), ("bbox3d", 660), ("image", 512))}
    for kw, what in (
            ({"init_tokens": {"pose": np.zeros((2, 1, 3))}},
             "init_tokens['pose']"),
            ({"init_tokens": {"pose": np.zeros((1, 1, 3)),
                              "bbox3d": np.zeros((1, 660))},
              "control_test": True}, "init_tokens['bbox3d']"),
            ({"forced_streams": {"map": np.zeros((1, 1, 1000))}},
             "forced_streams['map']")):
        with pytest.raises(ValueError, match=re.escape(what)):
            gen.generate(cond, new_frames=1, input_cond_frames=2, **kw)


# ---------------------------------------------------------------------------
# (e) fp8 rings
# ---------------------------------------------------------------------------
def _fp8(a):
    """fp8 ring → (its bytes, its values in float32)."""
    if isinstance(a, torch.Tensor):
        return a.view(torch.uint8).numpy(), a.float().numpy()
    a = np.asarray(a)
    return a.view(np.uint8), a.astype(np.float32)


def _fp8_step(v):
    """One float8_e4m3fn step at |v| (2^-9 among the subnormals)."""
    e = np.floor(np.log2(np.maximum(np.abs(v), 2.0 ** -6)))
    return 2.0 ** (e - 3)


@pytest.fixture(scope="module")
def fp8_rings(window):
    """The window ingested into fp8 rings by both packages' prefill
    (JAX's greedy ego action), and JAX's compiled prefill and cached-step
    functions."""
    w = window
    cfg = w["cfg"].replace(tar_mode="temporal_cache")
    jmodel, model = JUMGen(cfg), UMGen(cfg)
    jin = {m: jnp.asarray(v) for m, v in w["cond"].items()}
    fns = {"ego": _exact_jit(jmodel.prefill_ego_cache),
           "tar": _exact_jit(jmodel.prefill_tar_caches),
           "step": _exact_jit(jmodel.tar_priors_cached)}
    _, jcache = fns["ego"](w["jparams"], jin, {})
    jpri = fns["tar"](w["jparams"], w["shifted"], jcache)
    _, cache = model.prefill_ego_cache(w["params"], _torch(w["cond"]), {})
    pri = model.prefill_tar_caches(w["params"], _torch(w["shifted"]), cache)
    return {"cfg": cfg, "jmodel": jmodel, "model": model, "fns": fns,
            "jin": jin, "jpri": jpri, "pri": pri}


def _compare_fp8_rings(jcache, cache, what):
    n_diff = n = 0
    for name, (jk, jv) in ((k, v) for k, v in jcache.items()
                           if k != "frames"):
        for i, ja in enumerate((jk, jv)):
            a = cache[name][i]
            assert a.dtype == torch.float8_e4m3fn, (what, name)
            jb, jf = _fp8(ja)
            tb, tf = _fp8(a)
            assert np.isfinite(jf).all() and np.isfinite(tf).all()
            bound = _fp8_step(np.maximum(np.abs(jf), np.abs(tf))) \
                + 4 * 2.0 ** -8 * np.abs(jf).max()
            assert (np.abs(jf - tf) <= bound).all(), (what, name, i)
            n_diff += int((jb != tb).sum())
            n += jb.size
    assert n_diff <= FP8_TIES * n, (what, n_diff, n)
    print(f"{what}: {n_diff} of {n} fp8 ring bytes differ from JAX's")


def test_fp8_rings_match_jax(window, fp8_rings):
    """fp8 rings (`tar_cache_dtype="float8_e4m3fn"`): the ring bytes after
    the full-window prefill equal JAX's but at fp8 rounding ties of K/V a
    summation order apart (at most FP8_TIES, each within one fp8 step plus
    4 bf16 ulps of the ring's scale); the prefill's priors and, from JAX's
    rings, one cached frame's priors (the generated frame read against the
    fp8 rings, its K/V written into slot 3) within 4 bf16 ulps, and the
    rings after it as the prefill's.  The write rule itself, on the same
    bf16 values, is JAX's byte for byte
    (test_fp8_rings_saturate_where_jax_overflows)."""
    w, r = window, fp8_rings
    _close(r["pri"]["prior_seq"], r["jpri"]["prior_seq"], "prefill priors")
    _compare_fp8_rings(r["jpri"]["cache"], r["pri"]["cache"], "prefill")
    T = 3
    frame = {m: v[:, -1:] for m, v in r["jin"].items()}
    frame["pose"] = w["j_tok"][:, None]
    af = jnp.asarray(T, jnp.int32)
    jstep = r["fns"]["step"](w["jparams"], frame, r["jpri"]["cache"], af)
    cache = {k: (v if k == "frames" else
                 tuple(from_jax({"a": a})["a"] for a in v))
             for k, v in r["jpri"]["cache"].items()}
    step = r["model"].tar_priors_cached(w["params"], _torch(frame), cache, T)
    _close(step["prior_seq"], jstep["prior_seq"], "cached priors")
    _compare_fp8_rings(jstep["cache"], step["cache"], "cached step")


def test_fp8_rings_saturate_where_jax_overflows(window, fp8_rings):
    """The port's fp8 ring writes saturate at ±448 (`saturate_cast`, the
    rule of `kv_store`); JAX's conversion gives NaN beyond it (ROADMAP.md
    Queue 3).  A K bias of 600 in the trunk's temporal attention: the
    port's prefill rings hold ±448 where JAX's hold NaN, and the next
    cached frame's priors stay finite in the port, NaN in JAX.  Within
    range the port writes JAX's bytes: 10^5 bf16 values spread over the
    whole fp8 range, the subnormals included."""
    w, r = window, fp8_rings
    rng = np.random.default_rng(0)
    vals = (rng.choice([-1.0, 1.0], 10 ** 5)
            * 2.0 ** rng.uniform(-12, np.log2(440.0), 10 ** 5))
    xb = jnp.asarray(vals, jnp.bfloat16)
    ring = torch.zeros(1, 1, 10 ** 5, dtype=torch.float8_e4m3fn)
    UMGen._ring_store(ring, 0, torch.tensor(_f32(xb)).bfloat16()[None])
    np.testing.assert_array_equal(
        ring.view(torch.uint8).numpy()[0, 0],
        np.asarray(xb.astype(jnp.float8_e4m3fn)).view(np.uint8))
    x = torch.tensor([500.0, -1000.0, 448.0, 460.0, 0.3, -1e-3])
    ring = torch.zeros(1, 1, 6, dtype=torch.float8_e4m3fn)
    UMGen._ring_store(ring, 0, x[None])
    np.testing.assert_array_equal(ring.float().numpy()[0, 0, :4],
                                  [448.0, -448.0, 448.0, 448.0])
    ref = np.asarray(jnp.asarray(x.numpy()).astype(jnp.float8_e4m3fn)
                     .astype(jnp.float32))
    assert np.isnan(ref[:2]).all()
    np.testing.assert_array_equal(ring.float().numpy()[0, 0, 2:], ref[2:])

    D = w["cfg"].n_embd
    jparams = jax.tree.map(lambda a: a, w["jparams"])
    b_dtype = jparams["tar"]["ta"]["qkv"]["b"].dtype
    b = np.asarray(jparams["tar"]["ta"]["qkv"]["b"], np.float32).copy()
    b[..., D:2 * D] += 600.0
    jparams["tar"] = dict(jparams["tar"], ta=dict(
        jparams["tar"]["ta"], qkv=dict(jparams["tar"]["ta"]["qkv"],
                                       b=jnp.asarray(b, b_dtype))))
    params = from_jax(jparams)
    _, jcache = r["fns"]["ego"](jparams, r["jin"], {})
    jpri = r["fns"]["tar"](jparams, w["shifted"], jcache)
    _, cache = r["model"].prefill_ego_cache(params, _torch(w["cond"]), {})
    pri = r["model"].prefill_tar_caches(params, _torch(w["shifted"]), cache)
    jk = _f32(jpri["cache"]["tar"][0])[:, :, :3]
    tk = pri["cache"]["tar"][0].float().numpy()[:, :, :3]
    big = np.abs(tk) == 448.0
    assert big.mean() > 0.5 and np.isnan(jk[big]).all()
    assert np.isfinite(tk).all()
    T = 3
    frame = {m: v[:, -1:] for m, v in r["jin"].items()}
    frame["pose"] = w["j_tok"][:, None]
    jstep = r["fns"]["step"](jparams, frame, jpri["cache"],
                             jnp.asarray(T, jnp.int32))
    step = r["model"].tar_priors_cached(params, _torch(frame), pri["cache"],
                                        T)
    assert np.isnan(_f32(jstep["prior_seq"])).any()
    assert torch.isfinite(step["prior_seq"]).all()


# ---------------------------------------------------------------------------
# (f) ring refresh
# ---------------------------------------------------------------------------
def _f32_cfg(**kw):
    """tests/test_tar_cache.py's float32 set-up: plain attention, no rule
    constraint, no pad→TAR merge, the unfused decode on a float32 OAR
    cache."""
    return ModelConfig(dtype="float32", param_dtype="float32",
                       sample_method="greedy", use_pallas_attention=False,
                       rule_constrain=False, merge_ar_tar=False,
                       tar_cache_dtype="float32", oar_cache_dtype="float32",
                       **kw).scaled("tiny")


def test_ring_refresh_matches_recompute_post_slide():
    """`tar_cache_refresh=1` rebuilds the rings every frame from the last
    `tar_cache_window` = 2 frames with window-relative indices, so its
    stream equals sliding-window recompute even after the window slides:
    4 new frames after a 2-frame window, one scene, float32 (the JAX
    package's own test of it, tests/test_tar_cache.py).  The port's refresh
    stream against the port's recompute stream and against JAX's refresh
    stream: >= AGREE of each modality's tokens equal.  The refresh fires at
    frames 1, 2, 3."""
    W = 2
    cfg_r = _f32_cfg(tar_mode="recompute")
    cfg_c = _f32_cfg(tar_mode="temporal_cache", tar_cache_window=W,
                     tar_cache_refresh=1)
    jmodel = JUMGen(cfg_c)
    jparams = jmodel.init_params(jax.random.PRNGKey(0))
    cond = make_token_batch(jmodel.layout, T=W, B=1, seed=0, config=cfg_c)
    kw = dict(new_frames=4, cond_frames=W, input_cond_frames=W)
    jout = JGenerator(jmodel, jparams, seed=7).generate(cond, **kw)
    params = from_jax(jparams)
    gen_c = Generator(UMGen(cfg_c), params, device="cpu")
    out_c = gen_c.generate(cond, **kw)
    assert gen_c.refreshes == 3
    out_r = Generator(UMGen(cfg_r), params, device="cpu").generate(cond,
                                                                  **kw)
    for m in out_c:
        assert out_c[m].shape == jout[m].shape == out_r[m].shape
        for other, what in ((out_r, "port recompute"), (jout, "JAX")):
            agree = (out_c[m] == other[m]).mean()
            assert agree >= AGREE, (m, what, agree)


class _Stop(Exception):
    pass


def test_refreshed_frame_uses_window_relative_indices(monkeypatch):
    """Why refresh equals recompute: the refreshed frame's cached TAR step
    runs from a fresh cache (frames counted from 0), so its temporal PE
    index is its place in the window (`t_offset` W - 1), where the rings
    left alone carry the absolute frame index (T0 + idx - 1).  A 2-frame
    window, 3 new frames: with `tar_cache_refresh=1` the decoding steps of
    frames 1 and 2 read t_offset 1, without it 2 and 3.  The OAR decode is
    stubbed out: only the TAR steps run."""
    seen = []
    real = UMGen.tar_priors_cached

    def record(self, params, frame_inputs, cache, abs_frame):
        seen.append(abs_frame)
        return real(self, params, frame_inputs, cache, abs_frame)

    def no_decode(self, params, prior_seq, ego_tokens, *a, **k):
        from umgen_tpu_torch.models.rollout import FrameOutputs
        B = prior_seq.shape[0]
        return FrameOutputs(tokens=torch.zeros(B, self.layout.seq_len,
                                               dtype=torch.long),
                            pose_tokens=ego_tokens)

    monkeypatch.setattr(UMGen, "tar_priors_cached", record)
    monkeypatch.setattr(Rollout, "_finish_frame", no_decode)
    offsets = {}
    for refresh in (1, 0):
        cfg = _cfg(tar_mode="temporal_cache", tar_cache_window=2,
                   tar_cache_refresh=refresh)
        model = UMGen(cfg)
        cond = make_token_batch(model.layout, T=2, B=1, seed=0, config=cfg)
        g = torch.Generator().manual_seed(0)
        from umgen_tpu_torch.params import init_params
        params = init_params(cfg, g, "cpu")
        seen.clear()
        gen = Generator(model, params, device="cpu")
        gen.generate(cond, new_frames=3, cond_frames=2, input_cond_frames=2)
        assert gen.refreshes == (2 if refresh else 0)
        offsets[refresh] = list(seen)
    # frame 0: the full-window prefill (no cached step); frames 1, 2: with
    # refresh one re-ingest of the window's first frame at t_offset 0, then
    # the decoding step at 1
    assert offsets[1] == [0, 1, 0, 1], offsets[1]
    assert offsets[0] == [2, 3], offsets[0]


# ---------------------------------------------------------------------------
# (g) --int8 off, satellite: build_params as the JAX CLI, (i) the CLI
# ---------------------------------------------------------------------------
def test_unquantized_unfused_frame_matches_jax(window):
    """`--int8 off`: bf16 OAR weights through the unfused body on an fp8
    OAR cache, fp8 rings — the prefill frame of the cached path
    (`frame_step_prefill`), JAX's decisions replayed: decisions within
    GAP_ULPS, the tokens equal."""
    w = window
    cfg = w["cfg"].replace(tar_mode="temporal_cache")
    jmodel = JUMGen(cfg)
    jparams = jmodel.init_params(jax.random.PRNGKey(0))
    assert "w" in jparams["oar"]["attn"]["qkv"]
    jro = JRollout(jmodel)
    rec = _Recorder(jro)
    jout, _ = _exact_jit(jro.frame_step_prefill)(
        jparams, {m: jnp.asarray(v) for m, v in w["cond"].items()},
        jax.random.PRNGKey(0))
    jax.effects_barrier()
    ro = Rollout(UMGen(cfg))
    replay = _Replay(ro, rec.calls)
    tout, _ = ro.frame_step_prefill(from_jax(jparams), _torch(w["cond"]),
                                    torch.Generator())
    worst = _check_decisions(rec.calls, replay.seen,
                             _decision_labels(ro.layout), frame=1)
    np.testing.assert_array_equal(tout.tokens.numpy(),
                                  np.asarray(jout.tokens))
    print(f"--int8 off: decision logits within {worst:.3g} bf16 ulps")


@pytest.mark.parametrize("flags,quantized,packed", [
    ([], True, False), (["--int8", "off"], False, False),
    (["--fused_oar", "--kv_dtype", "bfloat16"], True, True)],
    ids=["default", "int8-off", "fused"])
def test_build_params_follows_the_jax_cli(flags, quantized, packed):
    """`build_params` as umgen_tpu/tools/evaluate.py:231-239: int8 unless
    `--int8 off`, the decode kernels' packing only under `--fused_oar` —
    the unfused default run holds no `oar_packed`."""
    args = evaluate.build_parser().parse_args(
        ["--debug", "--model_scale", "tiny", "--device", "cpu"] + flags)
    evaluate.check_args(args)
    cfg = evaluate.config_from_args(args)
    params = evaluate.build_params(args, cfg, torch.device("cpu"),
                                   ScenePipeline())
    assert ("oar_packed" in params) == packed
    assert ("wq" in params["oar"]["attn"]["qkv"]) == quantized
    assert ("w" in params["oar"]["attn"]["qkv"]) == (not quantized)


def test_cli_default_run_writes_its_tokens(tmp_path):
    """`python -m umgen_tpu_torch.tools.evaluate --device cpu --debug
    --model_scale tiny --synthetic_data 1 --max_scenes 1
    --set_num_new_frames 1`, no other flag: the reference CLI's default
    run (fp8 rings, the unfused decode on an fp8 OAR cache, top-k) writes
    the scene's token pickle, tokens within their vocabularies."""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["OMP_NUM_THREADS"] = "2"
    res = subprocess.run(
        [sys.executable, "-m", "umgen_tpu_torch.tools.evaluate", "--device",
         "cpu", "--debug", "--model_scale", "tiny", "--synthetic_data", "1",
         "--max_scenes", "1", "--set_num_new_frames", "1", "--output_path",
         str(tmp_path), "--save_video", "false"], cwd=ROOT, env=env,
        capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-3000:]
    assert os.listdir(tmp_path / "video") == []
    [name] = os.listdir(tmp_path / "saved_token")
    with open(tmp_path / "saved_token" / name, "rb") as f:
        out = pickle.load(f)
    vocab = {"pose": 1024, "map": 8192, "bbox3d": 1028, "image": 8192}
    for m, v in out.items():
        assert v.shape[:2] == (1, 21), m
        assert 0 <= v.min() and v.max() < vocab[m], m
