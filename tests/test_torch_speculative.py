"""Speculative decoding in the port (`--speculative_k`), against the JAX
package's and against the port's own sequential decode.

Each case decodes one recompute-mode frame at the tiny scale in float32
with plain attention and the unfused OAR decode (as tests/
test_speculative.py runs the JAX package's own speculation), greedy, K = 4,
the same parameters on both sides (the JAX initializer's, through
`params.from_jax`).  To keep a case short the segments it does not speculate
are teacher-forced to a seeded continuation.  A case must show:

  * the port's speculative tokens and its telemetry (verify chunks,
    accepted drafts) equal to JAX's;
  * the port's speculative stream equal to its sequential one on >= 99% of
    the positions (AGREE: float32 ties may flip between the Q = 1 and Q = K
    sum orders, after which the streams legitimately part).

JAX's segment loop writes each chunk's tokens with `dynamic_update_slice`,
which clamps its start to fit: in a segment's last K - 1 positions the
chunk lands up to K - 1 columns early and those positions keep zeros (the
next segment's first input is then embed(0)).  The port writes where the
chunk starts (ROADMAP.md Queue 3); the JAX side here runs with a write
that does not clamp (`_unclamped_jax`), and
`test_jax_clamps_the_segment_tail` pins the fault itself.

The rejection step is held to losslessness by a chi-square test of the
emitted tokens against the target distribution.
"""

from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy import stats

from umgen_tpu.config import ModelConfig as JModelConfig
from umgen_tpu.data.synthetic import make_token_batch
from umgen_tpu.models import speculative as jspec
from umgen_tpu.models.rollout import Rollout as JRollout
from umgen_tpu.models.umgen import UMGen as JUMGen
from umgen_tpu_torch.config import ModelConfig
from umgen_tpu_torch.models import speculative as tspec
from umgen_tpu_torch.models.rollout import Rollout
from umgen_tpu_torch.models.umgen import UMGen
from umgen_tpu_torch.ops import decode_kernel as tdk
from umgen_tpu_torch.params import from_jax
from umgen_tpu_torch.runtime.quantize import pack_fused

from test_torch_slice import _exact_jit

K = 4
AGREE = 0.99
# K/V rows of the final (bf16) OAR cache, speculative against sequential:
# the same inputs through the same float32 layers in another sum order (a
# Q = K chunk's attention against Q = 1's), so at most one bf16 rounding
# apart, 2^-7 of the cache's max |.|; a stale row of a rejected draft is
# off by its whole scale
ROWS_RTOL = 2.0 ** -7
# chi-square: p-value floor, draws
P_MIN, DRAWS = 1e-3, 20000
CONTENT = {"map": 1024, "bbox3d": 660, "image": 512}
# the cases: sampling rules, scenes, which segments are forced
CASES = {
    # map and image speculated (bbox forced), no rules
    "map_image": dict(rules=False, B=2, forced=("bbox3d",)),
    # the bbox segment under the merge rule and the rule constraint
    "bbox_rules": dict(rules=True, B=2, forced=("map", "image")),
    # ... and agent control of three slots
    "bbox_control": dict(rules=True, B=1, forced=("map", "image"),
                         control=True),
    # --no_spec_bbox: map speculated, the bbox segment sequential
    "no_spec_bbox": dict(rules=True, B=1, forced=("image",),
                         speculative_bbox=False),
}


@pytest.fixture(autouse=True)
def two_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _kw(rules, **over):
    kw = dict(dtype="float32", sample_method="greedy",
              rule_constrain=rules, merge_ar_tar=rules)
    kw.update(over)
    return kw


def _jcfg(**kw):
    return JModelConfig(param_dtype="float32", use_pallas_attention=False,
                        **kw).scaled("tiny")


def _tcfg(**kw):
    return ModelConfig(**kw).scaled("tiny")


@pytest.fixture(scope="module")
def jparams():
    return JUMGen(_jcfg(**_kw(False))).init_params(jax.random.PRNGKey(0))


class _UnclampedLax:
    """jax.lax with a `dynamic_update_slice_in_dim` that writes at the
    start it is given (the operand padded by the update's length first)."""

    def __getattr__(self, name):
        return getattr(jax.lax, name)

    @staticmethod
    def dynamic_update_slice_in_dim(operand, update, start, axis):
        n = operand.shape[axis]
        widths = [(0, 0)] * operand.ndim
        widths[axis] = (0, update.shape[axis])
        out = jax.lax.dynamic_update_slice_in_dim(
            jnp.pad(operand, widths), update, start, axis)
        return jax.lax.slice_in_dim(out, 0, n, axis=axis)


class _UnclampedJax:
    lax = _UnclampedLax()

    def __getattr__(self, name):
        return getattr(jax, name)


def _inputs(layout, cfg, B, forced, control):
    cond = make_token_batch(layout, T=3, B=B, seed=3, config=cfg)
    nxt = make_token_batch(layout, T=1, B=B, seed=4, config=cfg)
    forced = {m: nxt[m][:, 0] for m in forced}
    ctrl = None
    if control:
        ctrl = np.full((B, 660), -1, np.int32)
        ctrl[:, :33] = nxt["bbox3d"][:, 0, :33]           # slots 0-2
    return cond, forced, ctrl


def _jax_frame(jparams, cfg, cond, forced, ctrl, monkeypatch,
               unclamped=True):
    jm = JUMGen(cfg)
    with monkeypatch.context() as mp:
        if unclamped:
            mp.setattr(jspec, "jax", _UnclampedJax())
        out = _exact_jit(JRollout(jm).frame_step)(
            jparams, {m: jnp.asarray(v) for m, v in cond.items()},
            jax.random.PRNGKey(5), None,
            None if ctrl is None else jnp.asarray(ctrl),
            {m: jnp.asarray(v) for m, v in forced.items()} or None)
    return (np.asarray(out.tokens), int(out.spec_chunks),
            int(out.spec_accepted))


def _torch(a):
    return None if a is None else torch.tensor(np.asarray(a),
                                               dtype=torch.long)


def _port_frame(params, cfg, cond, forced, ctrl, ro=None):
    ro = ro or Rollout(UMGen(cfg))
    out = ro.frame_step(params, {m: _torch(v) for m, v in cond.items()},
                        torch.Generator(), control_bbox=_torch(ctrl),
                        forced_tokens={m: _torch(v) for m, v in
                                       forced.items()} or None)
    return out.tokens.numpy(), out.spec_chunks, out.spec_accepted


@pytest.mark.parametrize("case", list(CASES))
def test_greedy_speculation_matches_jax_and_sequential(case, jparams,
                                                       monkeypatch):
    """Greedy speculation, K = 4: the port's tokens, chunks and accepted
    drafts equal JAX's; its stream equals its own sequential one on >= 99%
    of the positions.  Every segment not forced is decoded in chunks: with
    random weights the TAR drafts are almost always rejected, so a chunk
    emits the verify's own token and leaves K - 1 stale rows for the next
    one to overwrite."""
    c = CASES[case]
    over = {"speculative_bbox": c.get("speculative_bbox", True)}
    jcfg = _jcfg(**_kw(c["rules"], speculative_k=K, **over))
    cond, forced, ctrl = _inputs(JUMGen(jcfg).layout, jcfg, c["B"],
                                 c["forced"], c.get("control"))
    j_tok, j_chunks, j_acc = _jax_frame(jparams, jcfg, cond, forced, ctrl,
                                        monkeypatch)
    params = from_jax(jparams)
    tok, chunks, acc = _port_frame(
        params, _tcfg(**_kw(c["rules"], speculative_k=K, **over)), cond,
        forced, ctrl)
    seq, seq_chunks, _ = _port_frame(params, _tcfg(**_kw(c["rules"])), cond,
                                     forced, ctrl)
    np.testing.assert_array_equal(tok, j_tok)
    assert (chunks, acc) == (j_chunks, j_acc)
    spec_mods = [m for m in CONTENT if m not in c["forced"]
                 and (m != "bbox3d" or over["speculative_bbox"])]
    assert chunks >= sum(CONTENT[m] for m in spec_mods) // K > 0
    assert seq_chunks == 0
    agree = (tok == seq).mean()
    print(f"{case}: {chunks} chunks, {acc} drafts accepted, "
          f"{agree:.5f} of the tokens equal to the sequential stream")
    assert agree >= AGREE, agree


def test_jax_clamps_the_segment_tail(jparams, monkeypatch):
    """The JAX package's own speculation leaves zeros in a segment's last
    K - 1 positions (its chunk write clamps to fit the segment); the port
    and the unclamped JAX write there what they decode."""
    c = CASES["map_image"]
    jcfg = _jcfg(**_kw(False, speculative_k=K))
    cond, forced, _ = _inputs(JUMGen(jcfg).layout, jcfg, 1, c["forced"],
                              False)
    clamped, _, _ = _jax_frame(jparams, jcfg, cond, forced, None,
                               monkeypatch, unclamped=False)
    fixed, _, _ = _jax_frame(jparams, jcfg, cond, forced, None,
                             monkeypatch)
    seg = JUMGen(jcfg).layout.segment("map")
    tail = slice(seg.content_end - K + 1, seg.content_end)   # 0-indexed
    assert (clamped[:, tail] == 0).all()
    assert (fixed[:, tail] != 0).any()
    before = slice(seg.content_start - 1, tail.start)
    np.testing.assert_array_equal(clamped[:, before], fixed[:, before])


class _OneHotDrafts:
    """Stands in for a speculative module's `nn`: the draft table of a
    segment (a `linear` over its content_len positions) becomes one-hot
    logits of the given tokens, every other call the real one."""

    def __init__(self, real, drafts, xp):
        self.real, self.drafts, self.xp = real, drafts, xp

    def __getattr__(self, name):
        return getattr(self.real, name)

    def linear(self, p, x):
        n = x.shape[1]
        if n not in self.drafts:
            return self.real.linear(p, x)
        tok = self.drafts[n]
        if self.xp is torch:
            return 30.0 * torch.nn.functional.one_hot(
                torch.as_tensor(tok), 8192).to(x.dtype)
        return 30.0 * jax.nn.one_hot(jnp.asarray(tok), 8192, dtype=x.dtype)


@pytest.mark.parametrize("every", [0, 3], ids=["all", "every_third_wrong"])
def test_drafts_of_the_sequential_tokens(every, jparams, monkeypatch):
    """Drafts made to equal the sequential greedy tokens (the draft tables
    monkeypatched on both sides): every chunk accepts all K drafts and the
    tokens and chunk count equal JAX's and the sequential stream's.  With
    every third draft wrong, chunks accept partially and leave stale rows
    behind: the next chunk overwrites them before any read, so the final
    OAR cache holds the sequential decode's rows (float32, ROWS_RTOL)."""
    c = CASES["map_image"]
    jcfg = _jcfg(**_kw(False, speculative_k=K))
    cond, forced, _ = _inputs(JUMGen(jcfg).layout, jcfg, 1, c["forced"],
                              False)
    params = from_jax(jparams)
    caches = []
    real_init = Rollout.init_kv

    def kept(ro, B, device=None):
        kv = real_init(ro, B, device)
        caches.append(kv)
        return kv

    monkeypatch.setattr(Rollout, "init_kv", kept)
    seq, _, _ = _port_frame(params, _tcfg(**_kw(False)), cond, forced, None)
    drafts = {}
    lo = UMGen(_tcfg(**_kw(False))).layout
    for m in ("map", "image"):
        seg = lo.segment(m)
        d = seq[:, seg.content_start - 1:seg.content_end].copy()
        if every:
            d[:, every - 1::every] = (d[:, every - 1::every] + 1) % 8192
        drafts[seg.content_len] = d
    with monkeypatch.context() as mp:
        mp.setattr(tspec, "nn", _OneHotDrafts(tspec.nn, drafts, torch))
        tok, chunks, acc = _port_frame(
            params, _tcfg(**_kw(False, speculative_k=K)), cond, forced,
            None)
    with monkeypatch.context() as mp:
        mp.setattr(jspec, "nn", _OneHotDrafts(jspec.nn, drafts, jnp))
        j_tok, j_chunks, j_acc = _jax_frame(jparams, jcfg, cond, forced,
                                            None, monkeypatch)
    np.testing.assert_array_equal(tok, j_tok)
    np.testing.assert_array_equal(tok, seq)
    assert (chunks, acc) == (j_chunks, j_acc)
    n = CONTENT["map"] + CONTENT["image"]
    if not every:
        assert (chunks, acc) == (n // K, n)
        return
    # two of three drafts right: a chunk accepts 2 and emits 3
    assert 0 < acc < n and chunks > n // K
    # rows the sequential decode writes: up to the last segment's last
    # content input (its EOS input is never pushed; the chunks' rows past
    # it are never read)
    S = lo.segments[-1].content_end
    for a, b in zip(caches[1], caches[0]):       # speculative, sequential
        a, b = a[:, :, :S].float(), b[:, :, :S].float()
        err = (a - b).abs().max().item()
        assert err <= ROWS_RTOL * b.abs().max().item(), err


class _Seg(NamedTuple):
    content_len: int
    content_start: int
    mod: str


class _State(NamedTuple):
    kv_k: object
    kv_v: object
    prev_emb: torch.Tensor


class _StubRollout:
    """A rollout whose verify step returns fixed target logits: the OAR
    head is the identity on h, and h the target table's rows at the
    chunk's positions."""

    def __init__(self, target, pos0):
        self.target, self.pos0 = target, pos0

    def _embed_token(self, params, mod, tok):
        return torch.zeros(*tok.shape, self.target.shape[-1])

    def oar_step(self, params, x, kv_k, kv_v, cache_len):
        p = cache_len + 1 - self.pos0
        Q = x.shape[1]
        return self.target[:, p:p + Q], kv_k, kv_v


def test_rejection_step_is_lossless():
    """Top-k sampling through `decode_segment_speculative`: draft p (the
    TAR table), target q (the verify's logits), DRAWS scenes in lockstep.
    Each position's emitted tokens must follow q — accepted drafts and the
    residual (q − p)+ resamples together — by a chi-square test at p-value
    > P_MIN, from a seeded torch.Generator."""
    V, k, n, B = 12, 8, 3, DRAWS
    rng = np.random.default_rng(7)
    draft = torch.tensor(rng.normal(0, 1.5, (n, V)), dtype=torch.float32)
    target = torch.tensor(rng.normal(0, 1.5, (n + K, V)),
                          dtype=torch.float32)
    eye = {"w": torch.eye(V)}
    params = {"head_ar_map": eye, "head_tar_map": eye}
    prior = torch.zeros(B, 1 + n + 1, V)
    prior[:, :n] = draft                 # input index c0 - 1 + i, c0 = 1
    g = torch.Generator()
    g.manual_seed(11)
    _, tokens, tel = tspec.decode_segment_speculative(
        _StubRollout(target[None].expand(B, -1, -1), 1), params,
        _Seg(n, 1, "map"), _State(None, None, torch.zeros(B, 1, V)), prior,
        "head_ar_map", "head_tar_map", k=k, temp=1.0, K=K, greedy=False,
        generator=g)
    assert tel.chunks >= n
    for i in range(n):
        def dense(logits):
            p, idx = tspec.topk_dist(logits, k, 1.0)
            return tspec._scatter_dense(p[None], idx[None], V)[0].numpy()

        want, drafted = dense(target[i]), dense(draft[i])
        seen = np.bincount(tokens[:, i].numpy(), minlength=V)
        keep = want > 0
        assert seen[~keep].sum() == 0, i
        exp = want[keep].astype(np.float64)
        pv = stats.chisquare(seen[keep], B * exp / exp.sum()).pvalue
        tv = 0.5 * np.abs(want - drafted).sum()
        print(f"position {i}: chi-square p = {pv:.4g} against the target "
              f"(draft and target {tv:.3f} apart in total variation)")
        # the test has power only where the draft is well off the target
        assert tv > 0.2 and pv > P_MIN, (i, tv, pv)


@pytest.mark.parametrize("cache", ["int8", "int4"])
def test_verify_chunks_take_the_multi_query_steps(cache, monkeypatch):
    """With the fused kernels on, every verify chunk is one Q = K step of
    v5mq (the int8 OAR cache) or v5mqi4 (int4): the count of such calls is
    the chunk count (the pushes are Q = 6 and 2)."""
    from umgen_tpu_torch.params import init_params
    from umgen_tpu_torch.runtime.quantize import quantize_params_int8
    cfg = _tcfg(sample_method="greedy", rule_constrain=True,
                merge_ar_tar=True, speculative_k=K, fused_oar_kernel=True,
                oar_cache_dtype=cache)
    calls = []
    for name in ("fused_decode_step_v5mq", "fused_decode_step_v5mqi4"):
        real = getattr(tdk, name)

        def counted(packed, x, *a, _real=real, _name=name, **kw):
            calls.append((_name, x.shape[1]))
            return _real(packed, x, *a, **kw)
        monkeypatch.setattr(tdk, name, counted)
    g = torch.Generator()
    g.manual_seed(0)
    params = pack_fused(quantize_params_int8(init_params(cfg, g, "cpu")),
                        kv_dtype=cache)
    cond, forced, _ = _inputs(UMGen(cfg).layout, cfg, 1, ("map", "image"),
                              False)
    tok, chunks, _ = _port_frame(params, cfg, cond, forced, None)
    want = "fused_decode_step_v5mq" + ("i4" if cache == "int4" else "")
    assert {c for c in calls} <= {(want, K), (want, 6), (want, 2)}
    assert sum(q == K for _, q in calls) == chunks >= 660 // K
    seg = UMGen(cfg).layout.segment("bbox3d")
    assert tok[:, seg.content_start - 1:seg.content_end].max() < 1028


def test_int4_guards_and_slack_rows():
    """The JAX package's two guards of speculation on the int4 OAR cache
    (no fused kernels; K·H > 128), with its messages; `init_kv` adds K
    slack rows to the flat and the packed cache."""
    base = dict(sample_method="greedy", oar_cache_dtype="int4",
                speculative_k=K)
    for over, what in ((dict(fused_oar_kernel=False), "fused_oar_kernel"),
                       (dict(fused_oar_kernel=True, speculative_k=33),
                        "speculative_k \\* n_head")):
        kw = {**base, **over}
        with pytest.raises(ValueError, match=what) as mine:
            Rollout(UMGen(_tcfg(**kw)))
        with pytest.raises(ValueError, match=what) as ref:
            JRollout(JUMGen(_jcfg(**kw)))
        assert str(mine.value) .split(" (")[0] == str(ref.value).split(
            " (")[0]
    ro = Rollout(UMGen(_tcfg(**base, fused_oar_kernel=True)))
    S = ro.layout.input_len
    kk, vv = ro.init_kv(2)
    assert kk.packed.shape == (1, 2, S + K, 32)
    assert vv.scale.shape == (1, 2, S + K, 4)
    flat, _ = Rollout(UMGen(_tcfg(sample_method="greedy",
                                  oar_cache_dtype="int8",
                                  speculative_k=K))).init_kv(1)
    assert flat.shape == (1, 1, S + K, 64)
    assert Rollout(UMGen(_tcfg())).init_kv(1)[0].shape[2] == S


@pytest.mark.parametrize("mode", ["recompute", "cached", "refresh"])
def test_generator_sums_the_telemetry(mode, monkeypatch):
    """`Generator.spec_chunks` / `spec_accepted` sum every frame's
    telemetry in all three window modes (the JAX Generator's counters),
    the frames a refresh rebuilds from included."""
    from umgen_tpu_torch.models.generate import Generator
    from umgen_tpu_torch.models.rollout import FrameOutputs
    cfg = _tcfg(sample_method="greedy", speculative_k=K,
                tar_mode="recompute" if mode == "recompute"
                else "temporal_cache", tar_cache_window=2,
                tar_cache_refresh=1 if mode == "refresh" else 0)
    model = UMGen(cfg)
    seen = []

    def step(name):
        def fake(self, params, inputs, generator, *a, **kw):
            seen.append(name)
            B = inputs["pose"].shape[0]
            out = FrameOutputs(
                tokens=torch.zeros(B, model.layout.seq_len, dtype=torch.long),
                pose_tokens=torch.zeros(B, 3, dtype=torch.long),
                prior_seq=torch.zeros(B, 1), spec_chunks=5 + len(seen),
                spec_accepted=len(seen))
            return out if name == "frame_step" else (out, {"frames": 0})
        return fake

    for name in ("frame_step", "frame_step_prefill", "frame_step_cached",
                 "frame_step_chunked"):
        monkeypatch.setattr(Rollout, name, step(name))
    gen = Generator(model, {"axe": torch.zeros(1)}, device="cpu")
    cond = make_token_batch(model.layout, T=2, B=1, seed=0, config=cfg)
    gen.generate(cond, new_frames=3, cond_frames=2, input_cond_frames=2)
    assert len(seen) == 3
    if mode == "refresh":
        assert seen == ["frame_step_prefill", "frame_step_chunked",
                        "frame_step_chunked"] and gen.refreshes == 2
    assert (gen.spec_chunks, gen.spec_accepted) == (6 + 7 + 8, 1 + 2 + 3)
