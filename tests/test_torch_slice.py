"""The port's cached video rollout against the JAX package, end to end.

One `frame_step_prefill` plus one `frame_step_cached` at the tiny scale
(config.py `scaled("tiny")`), fused int8 OAR decode, bf16 TAR rings, greedy
sampling, B = 2, a 3-frame conditioning window.  And the JAX bench's
serving configuration at that scale (int4 rings, int8 on every stack,
chunked prefill, a 2-frame ring under the 3-frame window, B = 3), driven as
`Generator._generate_cached` drives it.  Both packages start from
the same parameters: the JAX initializer's tree, int8-quantized by the JAX
package and handed to the port through `params.from_jax`.  JAX runs its
fused decode kernels in Pallas interpret mode (as tests/test_decode_kernel.py
does); the port runs the kernels' plain PyTorch versions on the CPU.

Greedy decisions and bf16 logits.  The heads emit bf16 logits, so the top
two of a vocabulary are often EXACTLY tied or one ulp apart, and then
float32 summation-order noise (XLA's CPU reductions, exp and rsqrt differ
from torch's in the last bit) decides the argmax.  Each frame is therefore
decoded twice by the port from the same state as JAX:
  * free-running, greedy on the port's own logits: its decisions must equal
    JAX's up to the first one where they differ, and JAX's top-2 gap there
    must be within GAP_ULPS bf16 ulps of the logit (a near tie); that
    position and gap are reported.  A stream without such a tie must equal
    JAX's 2207 tokens exactly.
  * replaying JAX's recorded decisions (token and top-2 logits, via an
    ordered callback), so that the rest of the frame is compared too.  At
    every decision the port's own argmax must equal JAX's token wherever
    JAX's top-2 gap is larger than GAP_ULPS ulps; at closer calls the
    port's logit for JAX's token must be within that bound of its maximum.
    At the end both frames' 2207 tokens must be equal (the separators, the
    pad→TAR merge rule and the collision rewrite run on both sides from the
    same decisions), and the ego logits and TAR priors within the stated
    tolerances.
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
from umgen_tpu.models.rollout import Rollout as JRollout
from umgen_tpu.models.umgen import UMGen as JUMGen
from umgen_tpu.ops import decode_kernel as jdk
from umgen_tpu.runtime.quantize import ALL_STACK_KEYS
from umgen_tpu.runtime.quantize import quantize_params_int8 as j_quantize
from umgen_tpu_torch.models.generate import Generator
from umgen_tpu_torch.models.rollout import Rollout
from umgen_tpu_torch.models.umgen import UMGen
from umgen_tpu_torch.params import from_jax
from umgen_tpu_torch.runtime.quantize import pack_fused

from test_torch_rings import compare_q4_rings

# bf16 ulps of the logit scale a near tie may span; one quantization flip
# of an int8 activation moves the logits by ~2 ulps here (the largest drift
# of a replayed decision's logit measured on this set-up: 2 ulps)
GAP_ULPS = 4
# the serving slice with the port's own int4 rings carried across writes
# (test_serving_slice_chained_matches_jax): ring values one grid step apart
# at rounding ties (0.4% of them) carry into later frames.  Measured there:
# priors 8.5 and 10 bf16 ulps of their scale off JAX's (frames 1, 2), ego
# logits 1.7, a replayed decision's logit 5 ulps, and the free-running
# stream leaving JAX's at a top-2 gap of up to 5.5 ulps.  Limits: 16 ulps
# for ego logits and priors, 8 for decisions and near ties.
CHAINED_ULPS = 16
CHAINED_GAP_ULPS = 8
# ego logits and priors (_close) are held to 4 bf16 ulps (2^-8 relative)
# of their scale: the same ops in the same order on both sides, differing
# in float32 summation order; bf16 outputs then differ by a few ulps where
# a rounding boundary falls between them


def _cfg():
    return ModelConfig(sample_method="greedy", tar_mode="temporal_cache",
                       tar_cache_dtype="bfloat16", oar_cache_dtype="int8",
                       fused_oar_kernel=True,
                       tar_cache_window=20).scaled("tiny")


def _f32(a):
    if isinstance(a, torch.Tensor):
        return a.float().numpy()
    return np.asarray(jnp.asarray(a, jnp.float32))


def _close(port, ref, what, ulps=4):
    """Within `ulps` bf16 ulps (2^-8 relative) of the reference's max |.|;
    returns the error in those ulps."""
    port, ref = _f32(port), _f32(ref)
    scale = np.abs(ref).max()
    err = np.abs(port - ref).max()
    assert err <= ulps * 2.0 ** -8 * scale, (what, err, scale)
    return float(err / (2.0 ** -8 * scale))


def _decision_labels(layout, frame_ego: bool = True, forced=()):
    """(segment, position) of each sampler call of one frame, in order."""
    labels = [("pose", 0)] if frame_ego else []
    for seg in layout.segments:
        if seg.mod == "pose" or seg.mod in forced:
            continue
        for i in range(seg.content_len):
            p = seg.content_start + i
            if seg.mod == "bbox3d":
                labels += [("bbox3d/ar", p), ("bbox3d/ctrl", p),
                           ("bbox3d/tar", p)]
            else:
                labels.append((seg.mod, p))
    return labels


class _Recorder:
    """Wraps the JAX rollout's samplers: records (token, top-2 logits) of
    every call through an ordered host callback."""

    def __init__(self, jro):
        self.calls = []
        for mod, base in list(jro._samplers.items()):
            jro._samplers[mod] = self._wrap(base)

    def _wrap(self, base):
        def sampler(key, logits):
            tok = base(key, logits)
            top2 = jax.lax.top_k(logits.astype(jnp.float32), 2)[0]
            jax.debug.callback(self._record, tok, top2, ordered=True)
            return tok
        return sampler

    def _record(self, tok, top2):
        self.calls.append((np.asarray(tok), np.asarray(top2)))

    def add(self, logits):
        """A decision taken outside the rollout (the greedy ego action)."""
        lf = _f32(logits)
        self.calls.append((lf.argmax(-1), -np.sort(-lf, axis=-1)[..., :2]))


class _Replay:
    """Port samplers that return JAX's recorded decisions and keep the
    port's own logits for the check."""

    def __init__(self, ro, calls):
        self.calls, self.i, self.seen = calls, 0, []
        for mod in list(ro._samplers):
            ro._samplers[mod] = self.sample

    def sample(self, generator, logits):
        tok, _ = self.calls[self.i]
        self.i += 1
        self.seen.append(logits.float())
        return torch.tensor(tok, dtype=torch.long)


class _Parted(Exception):
    pass


class _Free:
    """Wraps the port's own samplers: records every decision, and ends the
    frame (raises _Parted) once every scene row has left JAX's stream —
    what follows is no longer comparable."""

    def __init__(self, ro, calls):
        self.calls, self.toks = calls, []
        self.parted = None
        for mod, base in list(ro._samplers.items()):
            ro._samplers[mod] = self._wrap(base)

    def _wrap(self, base):
        def sample(generator, logits):
            tok = base(generator, logits)
            mine = tok.numpy()
            self.toks.append(mine)
            jax_tok = np.asarray(self.calls[len(self.toks) - 1][0])
            differs = (mine != jax_tok).reshape(len(mine), -1).any(1)
            self.parted = differs if self.parted is None else \
                self.parted | differs
            if self.parted.all():
                raise _Parted
            return tok
        return sample

    def run(self, step, *args):
        """The frame's FrameOutputs, or None if every row parted."""
        try:
            return step(*args)[0]
        except _Parted:
            return None


def _tie_bound(top1, ulps=GAP_ULPS):
    return ulps * 2.0 ** -8 * np.maximum(np.abs(top1), 1e-3)


def _check_free_running(calls, toks, labels, frame, ulps=GAP_ULPS):
    """Per scene row: the port's free-running decisions equal JAX's up to
    the first difference, which must fall on a JAX near tie (top-2 gap
    within `ulps` bf16 ulps).  Returns the rows that never differed, and
    prints where the others left JAX."""
    assert len(toks) <= len(calls) == len(labels)
    B = np.asarray(toks[0]).shape[0]
    matched = []
    for b in range(B):
        for (tok, top2), mine, (what, pos) in zip(calls, toks, labels):
            tok = np.asarray(tok)[b].reshape(-1)
            mine = np.asarray(mine)[b].reshape(-1)
            if np.array_equal(tok, mine):
                continue
            e = int(np.argmax(tok != mine))
            t1, t2 = top2[b].reshape(-1, 2)[e]
            gap = t1 - t2
            assert gap <= _tie_bound(t1, ulps), (
                f"frame {frame}, row {b}: the free-running port left JAX's "
                f"stream at {what} position {pos}, where JAX's top-2 gap "
                f"{gap:.6g} is no near tie (JAX {tok[e]}, port {mine[e]})")
            print(f"frame {frame}, row {b}: free-running streams part at "
                  f"{what} position {pos}, JAX top-2 gap {gap:.6g} = "
                  f"{gap / _tie_bound(t1, 1):.3g} ulps (JAX {tok[e]}, port "
                  f"{mine[e]})")
            break
        else:
            matched.append(b)
    return matched


def _clone(tree):
    if isinstance(tree, dict):
        return {k: _clone(v) for k, v in tree.items()}
    if isinstance(tree, tuple):
        return tuple(_clone(v) for v in tree)
    return tree.clone() if isinstance(tree, torch.Tensor) else tree


def _check_decisions(calls, seen, labels, frame, ulps=GAP_ULPS):
    """Every replayed decision: the port's argmax is JAX's token where
    JAX's top-2 gap is above `ulps` bf16 ulps, and the port's logit for
    it within that bound of JAX's.  Returns the largest drift in ulps."""
    worst = 0.0
    assert len(calls) == len(seen) == len(labels), (len(calls), len(seen),
                                                    len(labels))
    for (tok, top2), port, (what, pos) in zip(calls, seen, labels):
        port = port.numpy()
        tok = np.asarray(tok)
        pmax = port.max(-1)
        ptok = np.take_along_axis(port, tok[..., None], -1)[..., 0]
        gap = top2[..., 0] - top2[..., 1]
        bound = _tie_bound(top2[..., 0], ulps)
        agree = port.argmax(-1) == tok
        ok = np.where(gap > bound, agree, pmax - ptok <= bound)
        # the logit itself: within `ulps` bf16 ulps of JAX's
        drift = np.abs(ptok - top2[..., 0])
        ulp = 2.0 ** (np.floor(np.log2(np.maximum(np.abs(top2[..., 0]),
                                                  2.0 ** -3))) - 7)
        worst = max(worst, float((drift / ulp).max()))
        if not (drift <= ulps * ulp).all():
            idx = tuple(np.argwhere(drift > ulps * ulp)[0])
            raise AssertionError(
                f"frame {frame}, {what} position {pos} (row {idx}): the "
                f"port's logit for token {tok[idx]} is {ptok[idx]:.6g}, "
                f"JAX's {top2[idx][0]:.6g}")
        if not ok.all():
            idx = tuple(np.argwhere(~ok)[0])
            raise AssertionError(
                f"frame {frame}, {what} position {pos} (row {idx}): JAX "
                f"chose {tok[idx]} with top-2 gap {gap[idx]:.6g}; the port's "
                f"argmax is {port.argmax(-1)[idx]}, its logit for JAX's "
                f"token is {pmax[idx] - ptok[idx]:.6g} below its max")
    return worst


@pytest.fixture()
def interpret_kernels(monkeypatch):
    monkeypatch.setattr(jdk.pl, "pallas_call",
                        ft.partial(pl.pallas_call, interpret=True))


@pytest.fixture()
def two_threads():
    # the suite runs several workers on the same cores; torch's default of
    # one intra-op thread per core oversubscribes them
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def test_cached_rollout_matches_jax(interpret_kernels, two_threads):
    cfg = _cfg()
    jmodel = JUMGen(cfg)
    jro = JRollout(jmodel)
    rec = _Recorder(jro)
    jparams = j_quantize(jmodel.init_params(jax.random.PRNGKey(0)))
    jparams_fused = dict(jparams, oar_packed=jdk.pack_fused_oar(
        jparams["oar"]))
    model = UMGen(cfg)
    params = pack_fused(from_jax(jparams))

    B, T = 2, 3
    cond = make_token_batch(jmodel.layout, T=T, B=B, seed=0, config=cfg)
    lo = jmodel.layout
    sl = lo.slices()
    labels = _decision_labels(lo)
    control_mask = jnp.zeros((B, 61), bool)
    key = jax.random.PRNGKey(0)
    finish = jax.jit(jro._finish_frame)

    # ---- JAX, prefill frame: the sub-steps of frame_step_prefill ----
    jin = {m: jnp.asarray(v) for m, v in cond.items()}
    j_ego, jcache = jax.jit(jmodel.prefill_ego_cache)(jparams, jin, {})
    rec.add(j_ego)
    j_ego_tok = jnp.argmax(j_ego, axis=-1).astype(jnp.int32)
    shifted = dict(jin, pose=jnp.concatenate(
        [jin["pose"], j_ego_tok[:, None]], axis=1)[:, 1:])
    jpri = jax.jit(jmodel.prefill_tar_caches)(jparams, shifted, jcache)
    jout = finish(jparams_fused, jpri["prior_seq"], j_ego_tok,
                  jin["bbox3d"][:, -1], control_mask, key)
    jax.effects_barrier()
    calls1 = list(rec.calls)

    # ---- JAX, cached frame: the sub-steps of frame_step_cached ----
    jtok = np.asarray(jout.tokens)
    jframe = {m: jnp.asarray(jtok[:, sl[m]][:, None]) for m in lo.mod_order}
    jcache = dict(jpri["cache"], frames=jnp.asarray(T, jnp.int32))
    j_ego2, jcache = jax.jit(jmodel.ego_logits_cached)(
        jparams, jframe, jcache, jnp.asarray(T, jnp.int32))
    rec.add(j_ego2)
    j_ego_tok2 = jnp.argmax(j_ego2, axis=-1).astype(jnp.int32)
    jpri2 = jax.jit(jmodel.tar_priors_cached)(
        jparams, dict(jframe, pose=j_ego_tok2[:, None]), jcache,
        jnp.asarray(T, jnp.int32))
    jout2 = finish(jparams_fused, jpri2["prior_seq"], j_ego_tok2,
                   jframe["bbox3d"][:, 0], control_mask, key)
    jax.effects_barrier()
    calls2 = rec.calls[len(calls1):]

    # ---- port, through its public frame steps: free-running, then
    # replaying JAX's decisions ----
    tin = {m: torch.as_tensor(v, dtype=torch.long) for m, v in cond.items()}
    ro = Rollout(model)
    free = _Free(ro, calls1)
    fout = free.run(ro.frame_step_prefill, params, tin, torch.Generator())
    rows = _check_free_running(calls1, free.toks, labels, frame=1)
    if rows:
        np.testing.assert_array_equal(fout.tokens.numpy()[rows], jtok[rows])

    ro = Rollout(model)
    replay = _Replay(ro, calls1)
    tout, tcache = ro.frame_step_prefill(params, tin, torch.Generator())
    _close(tout.ego_logits, j_ego, "prefill ego logits")
    _close(tout.prior_seq, jpri["prior_seq"], "prefill priors")
    _check_decisions(calls1, replay.seen, labels, frame=1)
    np.testing.assert_array_equal(tout.tokens.numpy(), jtok)

    ttok = tout.tokens.numpy()
    tframe = {m: torch.as_tensor(ttok[:, sl[m]][:, None])
              for m in lo.mod_order}
    ro = Rollout(model)
    free = _Free(ro, calls2)
    fout2 = free.run(ro.frame_step_cached, params, tframe, _clone(tcache),
                     torch.Generator())
    rows = _check_free_running(calls2, free.toks, labels, frame=2)
    if rows:
        np.testing.assert_array_equal(fout2.tokens.numpy()[rows],
                                      np.asarray(jout2.tokens)[rows])

    ro = Rollout(model)
    replay = _Replay(ro, calls2)
    tout2, _ = ro.frame_step_cached(params, tframe, tcache,
                                    torch.Generator())
    _close(tout2.ego_logits, j_ego2, "cached ego logits")
    _close(tout2.prior_seq, jpri2["prior_seq"], "cached priors")
    _check_decisions(calls2, replay.seen, labels, frame=2)
    np.testing.assert_array_equal(tout2.tokens.numpy(),
                                  np.asarray(jout2.tokens))


# XLA's CPU compiler may keep bf16 intermediates in float32 where the JAX
# code rounds them (tests/test_torch_w4.py); the serving slice compiles the
# JAX side with that off
EXACT = {"xla_allow_excess_precision": False}


def _exact_jit(fn):
    """jax.jit(fn) compiled with EXACT at its first call (every later call
    takes the same shapes)."""
    compiled = []

    def call(*args):
        if not compiled:
            compiled.append(jax.jit(fn).lower(*args).compile(
                compiler_options=EXACT))
        return compiled[0](*args)
    return call


def _ring_state(jcache):
    """JAX's ring cache as the port holds it."""
    return {k: (int(v) if k == "frames"
                else tuple(torch.tensor(np.asarray(a)) for a in v))
            for k, v in jcache.items()}


@pytest.fixture(scope="module")
def serving():
    """The serving configuration at the tiny scale — int4 rings, int8 on
    every stack, chunked prefill of a 3-frame window into 2-frame rings,
    B = 3, the fused v5 path, greedy — and JAX's run of it, as
    `_generate_cached` drives it: frames 0-1 ingested, then the sub-steps
    of `frame_step_cached` on frame 2 and on the generated frame.  Holds
    JAX's rings after every write and, per decoded frame, (ego logits,
    priors, tokens, recorded decisions)."""
    cfg = ModelConfig(sample_method="greedy", tar_mode="temporal_cache",
                      tar_cache_dtype="int4", oar_cache_dtype="int8",
                      fused_oar_kernel=True, chunked_prefill=True,
                      tar_cache_window=2).scaled("tiny")
    jmodel = JUMGen(cfg)
    jro = JRollout(jmodel)
    rec = _Recorder(jro)
    jparams = j_quantize(jmodel.init_params(jax.random.PRNGKey(0)),
                         ALL_STACK_KEYS)
    jparams_fused = dict(jparams, oar_packed=jdk.pack_fused_oar(
        jparams["oar"]))
    B, T = 3, 3
    cond = make_token_batch(jmodel.layout, T=T, B=B, seed=0, config=cfg)
    lo = jmodel.layout
    sl = lo.slices()
    control_mask = jnp.zeros((B, 61), bool)
    key = jax.random.PRNGKey(0)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jdk.pl, "pallas_call",
                   ft.partial(pl.pallas_call, interpret=True))
        ingest = _exact_jit(jro.ingest_frame)
        ego = _exact_jit(jmodel.ego_logits_cached)
        priors = _exact_jit(jmodel.tar_priors_cached)
        finish = _exact_jit(jro._finish_frame)
        jin = {m: jnp.asarray(v) for m, v in cond.items()}
        jcache = jmodel.init_tar_cache(B)
        jstates = [jcache]          # JAX's rings after every write
        for t in range(T - 1):
            jcache = ingest(jparams,
                            {m: v[:, t:t + 1] for m, v in jin.items()},
                            jin["pose"][:, t + 1], jcache)
            jstates.append(jcache)
        jframe = {m: v[:, T - 1:] for m, v in jin.items()}
        jres = []
        for abs_frame in (T - 1, T):
            n0 = len(rec.calls)
            af = jnp.asarray(abs_frame, jnp.int32)
            j_ego, jcache = ego(jparams, jframe, jcache, af)
            rec.add(j_ego)
            j_tok = jnp.argmax(j_ego, axis=-1).astype(jnp.int32)
            jpri = priors(jparams, dict(jframe, pose=j_tok[:, None]), jcache,
                          af)
            jout = finish(jparams_fused, jpri["prior_seq"], j_tok,
                          jframe["bbox3d"][:, 0], control_mask, key)
            jax.effects_barrier()
            jres.append((j_ego, jpri["prior_seq"], np.asarray(jout.tokens),
                         rec.calls[n0:]))
            jcache = dict(jpri["cache"], frames=jnp.asarray(abs_frame + 1,
                                                            jnp.int32))
            jstates.append(jcache)
            jframe = {m: jnp.asarray(jres[-1][2][:, sl[m]][:, None])
                      for m in lo.mod_order}
    return {"model": UMGen(cfg), "params": pack_fused(from_jax(jparams)),
            "cond": {m: torch.as_tensor(v, dtype=torch.long)
                     for m, v in cond.items()},
            "layout": lo, "labels": _decision_labels(lo), "T": T,
            "jstates": jstates, "jres": jres, "cfg": cfg,
            "jparams_fused": jparams_fused}


def _serving_frame(sv, run, frame, ulps, gap_ulps):
    """Decode one frame of the serving slice with the port twice —
    free-running, then replaying JAX's decisions; `run(ro, generator)` →
    (FrameOutputs, rings) starts from the same rings each time — and hold
    it against JAX's frame: ego logits and priors within `ulps` bf16 ulps,
    every replayed decision's logit and the free-running stream's first
    difference within `gap_ulps`.  Returns the replayed run's
    (FrameOutputs, rings) and prints the deviations in ulps."""
    j_ego, j_pri, jtok, calls = sv["jres"][frame - 1]
    ro = Rollout(sv["model"])
    free = _Free(ro, calls)
    fout = free.run(run, ro, torch.Generator())
    rows = _check_free_running(calls, free.toks, sv["labels"], frame=frame,
                               ulps=gap_ulps)
    if rows:
        np.testing.assert_array_equal(fout.tokens.numpy()[rows], jtok[rows])
    ro = Rollout(sv["model"])
    replay = _Replay(ro, calls)
    tout, rings = run(ro, torch.Generator())
    seen = {"ego logits": _close(tout.ego_logits, j_ego,
                                 f"frame {frame} ego logits", ulps),
            "priors": _close(tout.prior_seq, j_pri, f"frame {frame} priors",
                             ulps),
            "decision logits": _check_decisions(calls, replay.seen,
                                                sv["labels"], frame=frame,
                                                ulps=gap_ulps)}
    np.testing.assert_array_equal(tout.tokens.numpy(), jtok)
    print(f"frame {frame}, deviations from JAX in bf16 ulps: {seen}")
    return tout, rings


def _next_frame(sv, tout):
    ttok = tout.tokens.numpy()
    return {m: torch.as_tensor(ttok[:, s][:, None])
            for m, s in sv["layout"].slices().items()}


def test_serving_slice_matches_jax(serving, two_threads):
    """Every ring write compared on its own.  An int4 ring stores each K/V
    value on a grid of 1/7 of its (scene, frame, head) max |.|.  The two
    packages' bf16 K/V differ by an ulp in 20-60% of the values (float32
    summation order, compounded through the stacks), and those on a
    rounding boundary of the grid land one step (~36 bf16 ulps) apart: 0.2%
    of the ring.  So every ingest and every frame step here starts the port
    from JAX's rings, the port's rings after it must equal JAX's up to one
    step at ties (counted), and each frame is decoded from the same rings
    on both sides, within the cached-rollout bounds (GAP_ULPS).
    test_serving_slice_chained_matches_jax carries the port's own rings."""
    sv = serving
    model, params, tin, T = sv["model"], sv["params"], sv["cond"], sv["T"]
    jstates = sv["jstates"]
    ro = Rollout(model)
    for t in range(T - 1):
        tcache = ro.ingest_frame(params, {m: v[:, t:t + 1]
                                          for m, v in tin.items()},
                                 tin["pose"][:, t + 1],
                                 _ring_state(jstates[t]))
        assert tcache["frames"] == t + 1
        compare_q4_rings(jstates[t + 1], tcache, f"ingest of frame {t}")
    tframe = {m: v[:, T - 1:] for m, v in tin.items()}
    for frame in (1, 2):
        before = jstates[T - 2 + frame]
        tout, tcache = _serving_frame(
            sv, lambda ro, g: ro.frame_step_cached(
                params, tframe, _ring_state(before), g), frame, 4,
            GAP_ULPS)
        compare_q4_rings(jstates[T - 1 + frame], tcache,
                         f"frame {frame} step")
        tframe = _next_frame(sv, tout)


def test_serving_slice_chained_matches_jax(serving, two_threads):
    """The port's own rings carried end to end, as Generator drives them:
    `frame_step_chunked` on the window (the ingest of frames 0-1 and a
    cached step on frame 2), then `frame_step_cached` on the generated
    frame from the rings it left.  The ring grid steps at rounding ties
    (test_serving_slice_matches_jax) now carry into later writes and move
    priors and logits past the per-write bounds; the limits are
    CHAINED_ULPS and CHAINED_GAP_ULPS.  The rings after each frame must
    equal JAX's up to one step at ties."""
    sv = serving
    params, T = sv["params"], sv["T"]
    tout, tcache = _serving_frame(
        sv, lambda ro, g: ro.frame_step_chunked(params, sv["cond"], g), 1,
        CHAINED_ULPS, CHAINED_GAP_ULPS)
    compare_q4_rings(sv["jstates"][T], tcache, "chained, frame 1")
    tframe = _next_frame(sv, tout)
    tout, tcache = _serving_frame(
        sv, lambda ro, g: ro.frame_step_cached(params, tframe,
                                               _clone(tcache), g), 2,
        CHAINED_ULPS, CHAINED_GAP_ULPS)
    compare_q4_rings(sv["jstates"][T + 1], tcache, "chained, frame 2")


def _count_i4_steps(monkeypatch):
    """Counts the port's calls of its int4-cache decode wrappers."""
    from umgen_tpu_torch.ops import decode_kernel as tdk
    hits = {}
    for kind in ("v5i4", "v5mqi4", "w4i4", "w4mqi4"):
        real = getattr(tdk, f"fused_decode_step_{kind}")

        def counted(*a, _real=real, _kind=kind, **k):
            hits[_kind] = hits.get(_kind, 0) + 1
            return _real(*a, **k)
        monkeypatch.setattr(tdk, f"fused_decode_step_{kind}", counted)
    return hits


@pytest.mark.parametrize("config", ["slice-i4", "serving-i4"])
def test_int4_oar_slice_matches_jax(config, serving, two_threads,
                                    monkeypatch):
    """One frame of each configuration with the OAR cache int4
    (`oar_cache_dtype="int4"`, fused kernels on) at the tiny scale, int8
    (W8A8) OAR weights — JAX packs W4A8 only at d = 768, where
    tests/test_torch_i4.py holds w4i4 / w4mqi4.  slice-i4: the prefill
    frame on bf16 rings through `frame_step_prefill`.  serving-i4: int4
    rings, int8 on every stack, the cached step on the window's last frame
    from JAX's rings after the chunked ingest (the route of
    test_serving_slice_matches_jax).  JAX decodes through v5i4 / v5mqi4 in
    interpret mode, compiled with EXACT; the port replays JAX's decisions
    through the plain versions: 2196 single-token steps and 3 multi-row
    pushes, the tokens equal, ego logits and priors within 4 bf16 ulps of
    their scale and every decision's logit within GAP_ULPS — the bounds of
    the int8-cache slices: the two sides quantize the same rows on the same
    grid, so the coarser cache adds no error between them beyond a nibble
    at a rounding tie."""
    if config == "serving-i4":
        sv = serving
        cfg = sv["cfg"].replace(oar_cache_dtype="int4")
        jparams_fused, params = sv["jparams_fused"], sv["params"]
        tin, T = sv["cond"], sv["T"]
        j_ego, j_pri, _, _ = sv["jres"][0]
        last_bbox = jnp.asarray(tin["bbox3d"][:, T - 1].numpy())

        def run(ro):
            return ro.frame_step_cached(
                params, {m: v[:, T - 1:] for m, v in tin.items()},
                _ring_state(sv["jstates"][T - 1]), torch.Generator())
    else:
        cfg = _cfg().replace(oar_cache_dtype="int4")
        jmodel = JUMGen(cfg)
        jparams = j_quantize(jmodel.init_params(jax.random.PRNGKey(0)))
        jparams_fused = dict(jparams, oar_packed=jdk.pack_fused_oar(
            jparams["oar"]))
        params = pack_fused(from_jax(jparams))
        cond = make_token_batch(jmodel.layout, T=2, B=2, seed=0, config=cfg)
        jin = {m: jnp.asarray(v) for m, v in cond.items()}
        tin = {m: torch.as_tensor(v, dtype=torch.long)
               for m, v in cond.items()}
        j_ego, jcache = jax.jit(jmodel.prefill_ego_cache)(jparams, jin, {})
        shifted = dict(jin, pose=jnp.concatenate(
            [jin["pose"], jnp.argmax(j_ego, axis=-1).astype(jnp.int32)[
                :, None]], axis=1)[:, 1:])
        j_pri = jax.jit(jmodel.prefill_tar_caches)(jparams, shifted,
                                                   jcache)["prior_seq"]
        last_bbox = jin["bbox3d"][:, -1]

        def run(ro):
            return ro.frame_step_prefill(params, tin, torch.Generator())

    jro = JRollout(JUMGen(cfg))
    rec = _Recorder(jro)
    rec.add(j_ego)
    j_tok = jnp.argmax(j_ego, axis=-1).astype(jnp.int32)
    B = j_tok.shape[0]
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jdk.pl, "pallas_call",
                   ft.partial(pl.pallas_call, interpret=True))
        jout = _exact_jit(jro._finish_frame)(
            jparams_fused, j_pri, j_tok, last_bbox,
            jnp.zeros((B, 61), bool), jax.random.PRNGKey(0))
        jax.effects_barrier()
    lo = jro.layout
    labels = _decision_labels(lo)

    ro = Rollout(UMGen(cfg))
    replay = _Replay(ro, rec.calls)
    hits = _count_i4_steps(monkeypatch)
    tout, _ = run(ro)
    assert hits == {"v5i4": lo.seq_len - 5 - 2 * 3, "v5mqi4": 3}, hits
    seen = {"ego logits": _close(tout.ego_logits, j_ego, "ego logits"),
            "priors": _close(tout.prior_seq, j_pri, "priors"),
            "decision logits": _check_decisions(rec.calls, replay.seen,
                                                labels, frame=1)}
    np.testing.assert_array_equal(tout.tokens.numpy(),
                                  np.asarray(jout.tokens))
    print(f"{config}, deviations from JAX in bf16 ulps: {seen}")


class _Stop(Exception):
    pass


@pytest.mark.parametrize("chunked", [True, False])
def test_generator_takes_the_first_frame_step_of_its_config(chunked,
                                                            monkeypatch):
    """Generator decodes its first frame through `frame_step_chunked` (held
    against JAX above) under `chunked_prefill`, else `frame_step_prefill`,
    either given the whole conditioning window."""
    cfg = ModelConfig(tar_mode="temporal_cache", tar_cache_dtype="int4",
                      chunked_prefill=chunked,
                      tar_cache_window=2).scaled("tiny")
    model = UMGen(cfg)
    cond = make_token_batch(model.layout, T=3, B=2, seed=0, config=cfg)
    seen = []

    def step(name):
        def record(self, params, inputs, generator):
            seen.append((name, {m: v.numpy() for m, v in inputs.items()}))
            raise _Stop
        return record

    for name in ("frame_step_chunked", "frame_step_prefill"):
        monkeypatch.setattr(Rollout, name, step(name))
    with pytest.raises(_Stop):
        Generator(model, {}, device="cpu").generate(cond, new_frames=1)
    [(name, inputs)] = seen
    assert name == ("frame_step_chunked" if chunked else "frame_step_prefill")
    for m in model.layout.mod_order:
        np.testing.assert_array_equal(inputs[m], cond[m])
