"""The port's cached video rollout against the JAX package, end to end.

One `frame_step_prefill` plus one `frame_step_cached` at the tiny scale
(config.py `scaled("tiny")`), fused int8 OAR decode, bf16 TAR rings, greedy
sampling, B = 2, a 3-frame conditioning window.  Both packages start from
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
from umgen_tpu.runtime.quantize import quantize_params_int8 as j_quantize
from umgen_tpu_torch.models.rollout import Rollout
from umgen_tpu_torch.models.umgen import UMGen
from umgen_tpu_torch.params import from_jax
from umgen_tpu_torch.runtime.quantize import pack_fused

# bf16 ulps of the logit scale a near tie may span; one quantization flip
# of an int8 activation moves the logits by ~2 ulps here (the largest drift
# of a replayed decision's logit measured on this set-up: 2 ulps)
GAP_ULPS = 4
# ego logits and priors: the same ops in the same order on both sides,
# differing in float32 summation order; bf16 outputs then differ by a few
# ulps (2^-8 relative) where a rounding boundary falls between them
REL_TOL = 4 * 2.0 ** -8


def _cfg():
    return ModelConfig(sample_method="greedy", tar_mode="temporal_cache",
                       tar_cache_dtype="bfloat16", oar_cache_dtype="int8",
                       fused_oar_kernel=True,
                       tar_cache_window=20).scaled("tiny")


def _f32(a):
    if isinstance(a, torch.Tensor):
        return a.float().numpy()
    return np.asarray(jnp.asarray(a, jnp.float32))


def _close(port, ref, what):
    port, ref = _f32(port), _f32(ref)
    scale = np.abs(ref).max()
    err = np.abs(port - ref).max()
    assert err <= REL_TOL * scale, (what, err, scale)


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


def _tie_bound(top1):
    return GAP_ULPS * 2.0 ** -8 * np.maximum(np.abs(top1), 1e-3)


def _check_free_running(calls, toks, labels, frame):
    """Per scene row: the port's free-running decisions equal JAX's up to
    the first difference, which must fall on a JAX near tie.  Returns the
    rows that never differed, and prints where the others left JAX."""
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
            assert gap <= _tie_bound(t1), (
                f"frame {frame}, row {b}: the free-running port left JAX's "
                f"stream at {what} position {pos}, where JAX's top-2 gap "
                f"{gap:.6g} is no near tie (JAX {tok[e]}, port {mine[e]})")
            print(f"frame {frame}, row {b}: free-running streams part at "
                  f"{what} position {pos}, JAX top-2 gap {gap:.6g} (JAX "
                  f"{tok[e]}, port {mine[e]})")
            break
        else:
            matched.append(b)
    return matched


def _clone(tree):
    if isinstance(tree, dict):
        return {k: _clone(v) for k, v in tree.items()}
    return tree.clone() if isinstance(tree, torch.Tensor) else tree


def _check_decisions(calls, seen, labels, frame):
    assert len(calls) == len(seen) == len(labels), (len(calls), len(seen),
                                                    len(labels))
    for (tok, top2), port, (what, pos) in zip(calls, seen, labels):
        port = port.numpy()
        tok = np.asarray(tok)
        pmax = port.max(-1)
        ptok = np.take_along_axis(port, tok[..., None], -1)[..., 0]
        gap = top2[..., 0] - top2[..., 1]
        bound = _tie_bound(top2[..., 0])
        agree = port.argmax(-1) == tok
        ok = np.where(gap > bound, agree, pmax - ptok <= bound)
        # the logit itself: within GAP_ULPS bf16 ulps of JAX's
        drift = np.abs(ptok - top2[..., 0])
        ulp = 2.0 ** (np.floor(np.log2(np.maximum(np.abs(top2[..., 0]),
                                                  2.0 ** -3))) - 7)
        if not (drift <= GAP_ULPS * ulp).all():
            idx = tuple(np.argwhere(drift > GAP_ULPS * ulp)[0])
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
