"""Trajectory replay and agent control through the port's frame steps,
against the JAX package's.

The set-up of tests/test_torch_slice.py (tiny scale, fused int8 OAR decode,
bf16 TAR rings, greedy, B = 2, a 3-frame window, the same parameters on
both sides, JAX's decode kernels in Pallas interpret mode).  One
`frame_step_prefill` and one `frame_step_cached`, each given:
  * pose_override: the ego action forced to a later frame's pose tokens;
  * control_bbox: some agents forced to a later frame's box tokens, every
    other slot -1 (free).  The newest window frame is overwritten before it
    enters the rings, controlled slots sample the TAR head with <pad>
    masked out, and the pad→TAR merge rule reads the overwritten frame;
  * forced_tokens: the map and image segments teacher-forced (one causal
    multi-row push each, the eager body of `oar_step`).
So only the 660 box positions are decided (three sampler calls each).  JAX's
decisions are recorded and replayed in the port as in test_torch_slice, with
the same per-decision check; both frames' 2207 tokens must then be equal.
A forced segment's cache rows are also compared directly, since later
decisions see them only through the attention.
"""

import functools as ft

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from test_torch_slice import (_Recorder, _Replay, _cfg, _check_decisions,
                              _decision_labels)
from umgen_tpu.data.synthetic import make_token_batch
from umgen_tpu.models.rollout import OarState as JOarState
from umgen_tpu.models.rollout import Rollout as JRollout
from umgen_tpu.models.umgen import UMGen as JUMGen
from umgen_tpu.ops import decode_kernel as jdk
from umgen_tpu.runtime.quantize import quantize_params_int8 as j_quantize
from umgen_tpu_torch.models.rollout import OarState, Rollout
from umgen_tpu_torch.models.umgen import UMGen
from umgen_tpu_torch.params import from_jax
from umgen_tpu_torch.runtime.quantize import pack_fused

FORCED = ("map", "image")


@pytest.fixture()
def interpret_kernels(monkeypatch):
    monkeypatch.setattr(jdk.pl, "pallas_call",
                        ft.partial(pl.pallas_call, interpret=True))


@pytest.fixture()
def two_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def models():
    """The JAX model and parameters (int8, packed for the fused step) and
    the port's model and parameters bridged from them."""
    cfg = _cfg()
    jmodel = JUMGen(cfg)
    jparams = j_quantize(jmodel.init_params(jax.random.PRNGKey(0)))
    jparams = dict(jparams, oar_packed=jdk.pack_fused_oar(jparams["oar"]))
    return jmodel, jparams, UMGen(cfg), pack_fused(from_jax(jparams))


def _controls(data, t, B):
    """Frame t of `data` as the step's overrides: its pose, its map and
    image segments, and its boxes for agents 0-2 of scene 0 and agents 1
    and 4 of scene 1 (-1 elsewhere)."""
    ctrl = np.full((B, 60, 11), -1, np.int32)
    boxes = data["bbox3d"][:, t].reshape(B, 60, 11)
    for b, agents in ((0, [0, 1, 2]), (1, [1, 4])):
        ctrl[b, agents] = boxes[b, agents]
    return dict(pose_override=data["pose"][:, t],
                control_bbox=ctrl.reshape(B, 660),
                forced_tokens={m: data[m][:, t] for m in FORCED})


def _to_jax(kw):
    return jax.tree_util.tree_map(jnp.asarray, kw)


def _to_torch(kw):
    return jax.tree_util.tree_map(
        lambda a: torch.as_tensor(np.array(a), dtype=torch.long), kw)


def test_control_and_forced_frames_match_jax(models, interpret_kernels,
                                              two_threads):
    jmodel, jparams, model, params = models
    cfg = jmodel.config
    jro = JRollout(jmodel)
    rec = _Recorder(jro)

    B, T = 2, 3
    data = make_token_batch(jmodel.layout, T=T + 2, B=B, seed=1, config=cfg)
    cond = {m: v[:, :T] for m, v in data.items()}
    lo = jmodel.layout
    sl = lo.slices()
    labels = _decision_labels(lo, frame_ego=False, forced=FORCED)
    key = jax.random.PRNGKey(0)
    ctrl1, ctrl2 = _controls(data, T, B), _controls(data, T + 1, B)

    # ---- JAX ----
    jout, jcache = jax.jit(jro.frame_step_prefill)(
        jparams, _to_jax(cond), key, **_to_jax(ctrl1))
    jax.effects_barrier()
    calls1 = list(rec.calls)
    jtok = np.asarray(jout.tokens)
    jframe = {m: jnp.asarray(jtok[:, sl[m]][:, None]) for m in lo.mod_order}
    jout2, _ = jax.jit(jro.frame_step_cached)(
        jparams, jframe, jcache, key, **_to_jax(ctrl2))
    jax.effects_barrier()
    calls2 = rec.calls[len(calls1):]

    # the overrides took effect on the JAX side
    np.testing.assert_array_equal(jtok[:, sl["pose"]], ctrl1["pose_override"])
    for m in FORCED:
        np.testing.assert_array_equal(jtok[:, sl[m]],
                                      ctrl1["forced_tokens"][m])

    # ---- port, replaying JAX's decisions ----
    ro = Rollout(model)
    replay = _Replay(ro, calls1)
    tout, tcache = ro.frame_step_prefill(
        params, _to_torch(cond), torch.Generator(), **_to_torch(ctrl1))
    _check_decisions(calls1, replay.seen, labels, frame=1)
    np.testing.assert_array_equal(tout.tokens.numpy(), jtok)

    ro = Rollout(model)
    replay = _Replay(ro, calls2)
    tframe = {m: torch.tensor(jtok[:, sl[m]][:, None], dtype=torch.long)
              for m in lo.mod_order}
    tout2, _ = ro.frame_step_cached(params, tframe, tcache,
                                    torch.Generator(), **_to_torch(ctrl2))
    _check_decisions(calls2, replay.seen, labels, frame=2)
    np.testing.assert_array_equal(tout2.tokens.numpy(),
                                  np.asarray(jout2.tokens))


@pytest.mark.parametrize("mod", FORCED)
def test_forced_segment_matches_jax(models, mod):
    """`_decode_forced_segment` on the same state: one causal push of the
    segment's known inputs.  Both sides run the eager multi-row OAR body
    (same bf16 matmuls, float32 summation order), so the pushed int8 K/V
    rows agree exactly except at a rounding tie (+-1, in under 0.1% of
    them); no other row changes; the next input embedding is the forced
    last token's embedding plus its prior, equal to a bf16 ulp."""
    jmodel, jparams, model, params = models
    cfg = jmodel.config
    jro = JRollout(jmodel)
    ro = Rollout(model)
    seg = jmodel.layout.segment(mod)
    c0, n = seg.content_start, seg.content_len
    rng = np.random.default_rng(4)
    B, d = 2, cfg.n_embd
    kv = np.zeros((2, cfg.n_oar_layer, B, jmodel.layout.input_len, d),
                  np.int8)
    kv[:, :, :, :c0 - 1] = rng.integers(-60, 61, size=kv[:, :, :, :c0 - 1]
                                        .shape)
    prev = rng.normal(0, 1, (B, 1, d))
    prior = rng.normal(0, 0.5, (B, jmodel.layout.seq_len, d))
    vocab = {"map": cfg.map_vocab_size, "image": cfg.img_vocab_size}[mod]
    forced = rng.integers(0, vocab, size=(B, n))

    def jforce(p, state, pri, f):
        return jro._decode_forced_segment(p, mod, seg, state, pri, f)

    jstate, jtok = jax.jit(jforce)(
        jparams, JOarState(jnp.asarray(kv[0]), jnp.asarray(kv[1]),
                           jnp.asarray(prev, jnp.bfloat16),
                           jax.random.PRNGKey(0)),
        jnp.asarray(prior, jnp.bfloat16), jnp.asarray(forced, jnp.int32))
    kk, vv = torch.tensor(kv[0]), torch.tensor(kv[1])
    state, tok = ro._decode_forced_segment(
        params, mod, seg,
        OarState(kk, vv, torch.tensor(prev, dtype=torch.bfloat16)),
        torch.tensor(prior, dtype=torch.bfloat16), torch.tensor(forced))
    np.testing.assert_array_equal(tok.numpy(), forced)
    np.testing.assert_array_equal(np.asarray(jtok), forced)
    rows = slice(c0 - 1, c0 - 1 + n)
    for orig, ref, got in ((kv[0], jstate.kv_k, kk), (kv[1], jstate.kv_v,
                                                       vv)):
        ref = np.asarray(ref).astype(np.int32)
        got = got.numpy().astype(np.int32)
        diff = np.abs(ref[:, :, rows] - got[:, :, rows])
        assert diff.max() <= 1 and (diff == 0).mean() > 0.999
        np.testing.assert_array_equal(np.delete(got, rows, axis=2),
                                      np.delete(orig, rows, axis=2))
    a = np.asarray(jnp.asarray(jstate.prev_emb, jnp.float32))
    b = state.prev_emb.float().numpy()
    assert np.abs(a - b).max() <= 2.0 ** -8 * np.abs(a).max()
