"""The port's tracer (runtime/profiler.py `span`, `count`, `start`, `take`,
`stop`), its spans and counters in the frame step and decode loop, and the
public draws hook (`Rollout.draw_hook`) against what the benchmark's
`Recorder` reads, on the CPU at the tiny scale.

The frames run with the OAR's eager body stubbed (the input passed through
as the stack's output): the spans and counters sit around it, and the
decode loop, the sampler, the agent rules and the embedding run as they
are, so each frame costs the glue's time and not the OAR's."""

import itertools
import time
import tracemalloc

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from benchmark import harness
from umgen_tpu_torch.config import ModelConfig
from umgen_tpu_torch.data.synthetic import make_token_batch
from umgen_tpu_torch.models import modules as nn
from umgen_tpu_torch.models.rollout import Rollout
from umgen_tpu_torch.models.umgen import UMGen
from umgen_tpu_torch.params import init_params
from umgen_tpu_torch.runtime import profiler

B = 2
# the tiny scale at one head of 32: the S = 2207 attentions of the cascade
# cost a quarter of the tiny scale's
CFG = ModelConfig().scaled("tiny").replace(n_embd=32, n_head=1)
ROLES = {"pose": ("ego",), "map": ("ar",), "image": ("ar",),
         "bbox3d": ("ar", "control", "tar")}


@pytest.fixture(autouse=True)
def tracer_off():
    """Every test starts and ends with the tracer off."""
    profiler.stop()
    yield
    profiler.stop()


def _tokens(layout, T, cfg):
    return {k: torch.as_tensor(v, dtype=torch.long) for k, v in
            make_token_batch(layout, T=T, B=B, seed=3, config=cfg).items()}


@pytest.fixture(scope="module")
def params():
    return init_params(CFG, torch.Generator().manual_seed(0), "cpu")


@pytest.fixture(scope="module")
def frames(params):
    """One recompute frame and one chunked cached step (one ingested frame,
    then `frame_step_cached`), top-k with the rule constraint on, traced,
    with the draws hook set and the benchmark's `Recorder` on the samplers.
    {mode: (the tracer's records, the hook's draws, the Recorder's calls,
    the frame's tokens, the plain GELU's calls)}."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    cfg = CFG
    assert cfg.sample_method == "topk" and cfg.rule_constrain
    out = {}
    with pytest.MonkeyPatch.context() as mp, torch.no_grad():
        mp.setattr(Rollout, "_oar_step_eager",
                   lambda self, params, x, kv_k, kv_v, cache_len:
                   (x, kv_k, kv_v))
        gelus = []
        plain = nn._gelu_plain
        mp.setattr(nn, "_gelu_plain",
                   lambda x: gelus.append(1) or plain(x))
        for mode in ("recompute", "cached"):
            c = cfg if mode == "recompute" else cfg.replace(
                tar_mode="temporal_cache", tar_cache_window=2,
                chunked_prefill=True)
            ro = Rollout(UMGen(c))
            window = _tokens(ro.layout, 1 if mode == "recompute" else 2, c)
            rec = harness.Recorder(ro)
            hooked = []
            ro.draw_hook = lambda *a: hooked.append(a)
            g = torch.Generator().manual_seed(5)
            gelus.clear()
            profiler.start()
            if mode == "recompute":
                res = ro.frame_step(params, window, g)
            else:
                res, _ = ro.frame_step_chunked(params, window, g)
            out[mode] = (profiler.stop(), hooked, rec.take(), res.tokens,
                         len(gelus))
    torch.set_num_threads(n)
    return out


def test_tracer_off_records_nothing_and_allocates_nothing(monkeypatch):
    """Off (the default): no record_function even under a profiler, no CUDA
    event, no Python object a span or a count, nothing recorded."""
    def refuse(*a, **k):
        raise AssertionError("the tracer is off")
    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    monkeypatch.setattr(torch.cuda, "Event", refuse)
    attrs = ("w4", 10, 1, 1100)

    def spans(n):
        for _ in itertools.repeat(None, n):
            with profiler.span("umgen.oar_step", *attrs):
                with profiler.span("umgen.glue", "map"):
                    profiler.count("oar_steps.w4")

    with profile(activities=[ProfilerActivity.CPU]):
        spans(100)
    spans(100)
    # one shared null context: no span object
    assert profiler.span("umgen.glue", "map") is profiler.span("umgen.oar")
    tracemalloc.start()
    try:
        before = tracemalloc.get_traced_memory()[0]
        tracemalloc.reset_peak()
        spans(2000)
        current, peak = tracemalloc.get_traced_memory()
    finally:
        tracemalloc.stop()
    assert current - before <= 0 and peak - before < 512, (current, peak)
    assert profiler.take() == {"spans": [], "counters": {}}


@pytest.mark.parametrize("mode", ["recompute", "cached"])
def test_spans_and_counters_of_a_frame(frames, mode):
    """frame > ego / tar / oar > oar_step and glue > head / sample / rules /
    embed, one frame id across the frame step, the ingest outside it, the
    step counter equal to the layout's, and every GELU counted on its
    path: a frame step's = its cascade's + one a map or image step, an
    ingest's = the same cascade's (the draws are the hook's, in the test
    below)."""
    took, _, _, _, gelus = frames[mode]
    spans = took["spans"]
    by_id = {s["id"]: s for s in spans}

    def parent(s):
        return by_id[s["parent"]]["name"] if s["parent"] is not None \
            else None

    [frame] = [s for s in spans if s["name"] == "umgen.frame"]
    assert frame["attrs"]["mode"] == mode and frame["attrs"]["B"] == B
    assert frame["attrs"]["frame"] == (None if mode == "recompute" else 2)
    pairs = {(parent(s), s["name"]) for s in spans}
    want = {(None, "umgen.frame"), ("umgen.frame", "umgen.ego"),
            ("umgen.frame", "umgen.tar"), ("umgen.frame", "umgen.oar"),
            ("umgen.frame", "umgen.sample"), ("umgen.ego", "umgen.flash"),
            ("umgen.tar", "umgen.flash"), ("umgen.oar", "umgen.oar_step"),
            ("umgen.oar", "umgen.glue"), ("umgen.glue", "umgen.head"),
            ("umgen.glue", "umgen.sample"), ("umgen.glue", "umgen.rules"),
            ("umgen.rules", "umgen.sample"), ("umgen.glue", "umgen.embed")}
    if mode == "cached":
        want |= {(None, "umgen.ingest"), ("umgen.ingest", "umgen.ego"),
                 ("umgen.ingest", "umgen.tar")}
    assert pairs == want
    for s in spans:
        assert s["start_ns"] <= s["end_ns"] and s["device_ms"] is None
        assert s["profiled"] is False
        if s["parent"] is not None:
            p = by_id[s["parent"]]
            assert p["start_ns"] <= s["start_ns"] <= s["end_ns"] \
                <= p["end_ns"]
        inside = s is frame or any(a is frame for a in _ancestors(s, by_id))
        assert s["frame"] == (0 if inside else None)
    layout = Rollout(UMGen(CFG)).layout
    n = {seg.mod: seg.content_len for seg in layout.segments}
    steps = sum(v for m, v in n.items() if m != "pose")
    embeds = n["map"] + n["image"]
    cascade = _cascade_gelus(CFG)
    want = {0: {"oar_steps.eager": steps, "gelu.plain": cascade + embeds}}
    if mode == "cached":
        want[None] = {"gelu.plain": cascade}
    assert took["counters"] == want
    assert gelus == sum(c["gelu.plain"] for c in want.values())
    glue = [s for s in spans if s["name"] == "umgen.glue"]
    assert len(glue) == steps
    assert sum(s["attrs"]["kernel"] == "eager" and s["attrs"]["Q"] == 1
               for s in spans if s["name"] == "umgen.oar_step") == steps


def _cascade_gelus(cfg):
    """GELU calls of one frame's ego + TAR cascade, counted from the
    configuration: three MLPs a TAR-family block (ego, trunk, map, box),
    one an ego cross-attention block, and one a map or image embedding —
    the ego net's and the trunk's inputs embed both, the map and box
    stacks' the map alone."""
    assert cfg.task == "pose_map_bbox3d_image"
    assert cfg.split_map_tar and cfg.split_box_tar
    blocks = (cfg.n_ego_tar_layer + cfg.n_tar_layer + cfg.n_map_tar_layer
              + cfg.n_box_tar_layer)
    return 3 * blocks + cfg.n_ego_ca_layer + 2 + 2 + 1 + 1


def _ancestors(s, by_id):
    while s["parent"] is not None:
        s = by_id[s["parent"]]
        yield s


@pytest.mark.parametrize("mode", ["recompute", "cached"])
def test_draw_hook_gives_what_the_benchmark_reads(frames, mode):
    """The hook's draws, in call order, are the draws the benchmark's
    Recorder and `frame_draws` read for the same frame, one a role at each
    content position of the layout, and the served stream's positions."""
    _, hooked, calls, tokens, _ = frames[mode]
    layout = Rollout(UMGen(CFG)).layout
    rows = np.arange(B)
    bench = harness.frame_draws(
        calls, rows, [(s.mod, s.content_len, None, None)
                      for s in layout.segments])
    by = {}
    for mod, role, p, tok in hooked:
        by.setdefault((mod, role), []).append((p, tok))
    assert set(by) == {(m, r) for m, roles in ROLES.items() for r in roles}

    def st(key):
        return torch.stack([t for _, t in by[key]], 1).numpy()

    [(p_ego, ego)] = by[("pose", "ego")]
    np.testing.assert_array_equal(ego.numpy(), bench["pose"])
    assert p_ego == layout.segment("pose").content_start
    for name, key in (("map", ("map", "ar")), ("image", ("image", "ar")),
                      ("bbox_ar", ("bbox3d", "ar")),
                      ("bbox_tar", ("bbox3d", "tar"))):
        np.testing.assert_array_equal(st(key), bench[name])
    for mod in ("map", "image", "bbox3d"):
        seg = layout.segment(mod)
        for role in ROLES[mod]:
            assert [p for p, _ in by[(mod, role)]] == list(
                range(seg.content_start, seg.content_end + 1))
    # the hook is handed the sampler's own draws, in the sampler's order
    for mod in ROLES:
        mine = [t for m, _, _, t in hooked if m == mod]
        assert len(mine) == len(calls[mod])
        assert all(a is b for a, b in zip(mine, calls[mod]))
    for mod in ("map", "image"):
        seg = layout.segment(mod)
        np.testing.assert_array_equal(
            tokens[:, seg.content_start - 1:seg.content_end].numpy(),
            st((mod, "ar")))


def test_served_segments_call_the_hook_once(params, monkeypatch):
    """A forced ego action and each teacher-forced segment are one
    `served` call with their tokens, at the segment's first content
    position; nothing is sampled."""
    monkeypatch.setattr(Rollout, "_oar_step_eager",
                        lambda self, params, x, kv_k, kv_v, cache_len:
                        (x, kv_k, kv_v))
    ro = Rollout(UMGen(CFG))
    lo = ro.layout
    hooked = []
    ro.draw_hook = lambda *a: hooked.append(a)
    forced = {seg.mod: torch.zeros(B, seg.content_len, dtype=torch.long)
              for seg in lo.segments if seg.mod != "pose"}
    pose = torch.ones(B, 3, dtype=torch.long)
    prior = torch.zeros(B, lo.seq_len + 1, CFG.n_embd)
    with torch.no_grad():
        assert ro._ego(None, None, pose) is pose
        ro._finish_frame(params, prior, pose,
                         torch.zeros(B, 660, dtype=torch.long),
                         torch.zeros(B, 61, dtype=torch.bool), None,
                         forced_tokens=forced)
    assert [(m, r, p) for m, r, p, _ in hooked] == [
        ("pose", "served", lo.segment("pose").content_start)] + [
        (mod, "served", lo.segment(mod).content_start) for mod in forced]
    assert hooked[0][3] is pose
    assert all(torch.equal(t, forced[m]) for m, _, _, t in hooked[1:])


@pytest.mark.parametrize("keep", [True, False])
def test_counters_are_kept_a_frame_step(keep):
    """Counters go to the frame step open at the count (None outside one),
    whether or not span records are kept; `take` clears them."""
    profiler.start(keep=keep)
    profiler.count("oar_steps.w4")
    for _ in range(2):
        with profiler.span("umgen.frame", "cached", B, 3):
            profiler.count("oar_steps.w4", 5)
            profiler.count("oar_steps.w4mq")
    took = profiler.take()
    assert took["counters"] == {
        None: {"oar_steps.w4": 1},
        0: {"oar_steps.w4": 5, "oar_steps.w4mq": 1},
        1: {"oar_steps.w4": 5, "oar_steps.w4mq": 1}}
    assert [s["frame"] for s in took["spans"]] == ([0, 1] if keep else [])
    assert profiler.stop() == {"spans": [], "counters": {}}


def test_spans_contain_their_record_function_ranges():
    """Under a CPU torch.profiler session each span opens its
    record_function range, and its own interval, converted to the
    profiler's clock, contains that range within 0.5 ms; a span open across
    the session's end closes without a fault."""
    model = UMGen(CFG)
    params = init_params(CFG, torch.Generator().manual_seed(0), "cpu")
    window = _tokens(model.layout, 1, CFG)
    profiler.start()
    with torch.no_grad(), profile(activities=[ProfilerActivity.CPU]) as prof:
        with profiler.span("umgen.frame", "recompute", B):
            model.ego_logits(params, window)
            with profiler.span("umgen.glue", "map"):
                time.sleep(0.002)
        late = profiler.span("umgen.oar")
        late.__enter__()
    late.__exit__(None, None, None)
    with profiler.span("umgen.head"):      # after the session: no range
        pass
    took = profiler.stop()
    *took["spans"], after = took["spans"]
    assert after["name"] == "umgen.head" and not after["profiled"]
    assert all(s["profiled"] for s in took["spans"])
    t0 = prof.profiler.kineto_results.trace_start_ns()
    ranges = {}
    for e in prof.events():
        if e.name.startswith("umgen."):
            ranges.setdefault(e.name, []).append(
                (t0 + e.time_range.start * 1e3, t0 + e.time_range.end * 1e3))
    names = [s["name"] for s in took["spans"]]
    assert {"umgen.frame", "umgen.ego", "umgen.flash", "umgen.glue",
            "umgen.oar"} <= set(names)
    assert sorted(ranges) == sorted(set(names))
    for name, rs in ranges.items():
        mine = sorted((s["start_ns"], s["end_ns"]) for s in took["spans"]
                      if s["name"] == name)
        assert len(mine) == len(rs), name
        for (a, b), (ra, rb) in zip(mine, sorted(rs)):
            assert a - 5e5 <= ra <= rb <= b + 5e5, (name, a, ra, rb, b)
