"""The reduction of a profiled slice to the program's spans open at each
operation's launch, the three readers of the program's tracer by hand, and
on the card (marked `cuda`: the profiler sees device operations only
there) the launches of a decode step split among the step, its glue and
the rest."""

from types import SimpleNamespace

import pytest
import torch
from torch.autograd import DeviceType

from benchmark import harness
from benchmark import trace as tr


def test_open_at_nested_ranges():
    ranges = [(0, 10, "a"), (2, 5, "b"), (3, 4, "c"), (6, 9, "d"),
              (12, 14, "e")]
    got = tr.open_at(ranges, [1, 3.5, 4.5, 5.5, 7, 11, 13, 20, 3.5])
    assert got == [("a",), ("a", "b", "c"), ("a", "b"), ("a",), ("a", "d"),
                   (), ("e",), (), ("a", "b", "c")]


def _ev(name, dev, start, end, id=0, thread=1, annotation=False):
    return SimpleNamespace(name=name, device_type=dev, id=id, thread=thread,
                           time_range=SimpleNamespace(start=start, end=end),
                           is_user_annotation=annotation)


def test_reduce_session_tags_each_operation():
    """Each device operation carries the program's spans open at its
    launch; the device-side copies of the program's ranges are no
    operations."""
    C, G = DeviceType.CPU, DeviceType.CUDA
    evs = [_ev("bench.decode", C, 0, 100),
           _ev("bench.oar_step", C, 10, 30), _ev("umgen.oar_step", C, 11, 29),
           _ev("cudaLaunchKernel", C, 12, 13, id=1), _ev("k1", G, 14, 20, 1),
           _ev("umgen.glue", C, 31, 50), _ev("umgen.sample", C, 35, 40),
           _ev("cudaLaunchKernel", C, 36, 37, id=2), _ev("k2", G, 40, 45, 2),
           _ev("cudaLaunchKernel", C, 45, 46, id=3), _ev("k3", G, 46, 48, 3),
           _ev("cudaLaunchKernel", C, 60, 61, id=4), _ev("k4", G, 61, 62, 4),
           _ev("umgen.glue", G, 40, 45, id=2),
           _ev("umgen.glue", C, 70, 80, thread=2),
           _ev("cudaLaunchKernel", C, 75, 76, id=5), _ev("k5", G, 76, 77, 5)]
    s = tr.reduce_session(SimpleNamespace(events=lambda: evs),
                          "bench.decode")
    assert [o[0] for o in s["ops"]] == ["k1", "k2", "k3", "k4", "k5"]
    assert [o[2] for o in s["ops"]] == ["bench.oar_step", None, None, None,
                                        None]
    assert s["program"] == [("umgen.oar_step",), ("umgen.glue",
                                                  "umgen.sample"),
                            ("umgen.glue",), (), ()]


def traced_data():
    """A traced run's data as `harness.traced` hands it to the readers."""
    ops = [("k1", 10.0, "bench.oar_step"), ("k2", 30.0, "bench.oar_step"),
           ("g1", 5.0, None), ("g2", 5.0, None), ("e", 1.0, None)]
    s = {"busy_s": 0.0005, "window_s": 2.0, "ops": ops, "gaps": {},
         "program": [("umgen.oar_step",), ("umgen.oar_step",),
                     ("umgen.glue", "umgen.head"), ("umgen.glue",), ()]}

    def span(name, ms, profiled):
        return {"name": name, "start_ns": 1_000_000, "profiled": profiled,
                "end_ns": 1_000_000 + int(ms * 1e6), "device_ms": None}
    program = {"spans": [span("umgen.glue", 2.0, False),
                         span("umgen.glue", 4.0, False),
                         span("umgen.glue", 9.0, True),
                         span("umgen.head", 1.0, False)],
               "counters": {7: {"oar_steps.v5": 3, "gelu.kernel": 40}}}
    setup = {"spans": [dict(span("umgen.ingest", 0, True), device_ms=ms)
                       for ms in (900.0, 10.0, 12.0, 11.0)]
             + [dict(span("umgen.frame", 0, True), device_ms=5000.0)],
             "counters": {}}
    return {"decode": s, "decode_steps": 2, "oar_calls": [(1, 1, 100)],
            "program": program, "setup": setup}


def test_program_readers_by_hand():
    t = traced_data()
    r = {n: harness.reader(n)(t) for n in (
        "ingest_ms_per_frame", "glue_ms_per_step", "glue_launches_per_step")}
    # the median ingest, so the first (cold) one does not count
    assert r["ingest_ms_per_frame"] == 11.5
    # 6 ms of unprofiled glue over 3 counted steps less the 1 profiled
    assert r["glue_ms_per_step"] == pytest.approx(3.0)
    assert r["glue_launches_per_step"] == 1.0
    # with the step's and the rest, the glue's launches make up the
    # decode step's
    s = t["decode"]
    inside = sum("umgen.oar_step" in n for n in s["program"])
    rest = sum(not n for n in s["program"])
    assert (inside + rest) / t["decode_steps"] + r["glue_launches_per_step"] \
        == harness.reader("oar_launches_per_step")(t)
    empty = dict(t, decode=None, program=None, setup=None)
    assert all(harness.reader(n)(empty) is None for n in r)


@pytest.mark.cuda
def test_decode_launches_split_on_the_card(monkeypatch):
    """On a traced run of stander-cached-b1: every operation inside the
    benchmark's `bench.oar_step` is inside the program's `umgen.oar_step`
    and no other is; with the glue's and the rest, they make up
    `oar_launches_per_step`; the glue's host time is read over the steps
    the profiler did not see, as many as the unprofiled glue spans."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the profiler sees device "
                    "operations only there")
    seen = {}
    traced = harness.traced

    def keep(*a, **k):
        seen.update(traced(*a, **k))
        return seen
    monkeypatch.setattr(harness, "traced", keep)
    out = harness.run_cell("stander-cached-b1", 2 ** 31 + 41, 1.0, True,
                           device="cuda:0", log=lambda s: None)
    assert out["correct"] is True, out["checks"]
    s, steps = seen["decode"], seen["decode_steps"]
    inside = [("umgen.oar_step" in n) for n in s["program"]]
    assert inside == [span == "bench.oar_step" for _, _, span in s["ops"]]
    glue = sum("umgen.glue" in n for n in s["program"])
    rest = sum(not n for n in s["program"])
    assert sum(inside) + glue + rest == len(s["ops"])
    m = out["metrics"]
    assert m["glue_launches_per_step"]["value"] == glue / steps
    assert m["oar_launches_per_step"]["value"] == pytest.approx(
        (sum(inside) + glue + rest) / steps)
    unprofiled = sum(1 for x in seen["program"]["spans"]
                     if x["name"] == "umgen.glue" and not x["profiled"])
    counted = sum(n for c in seen["program"]["counters"].values()
                  for k, n in c.items() if k.startswith("oar_steps."))
    assert unprofiled == counted - sum(
        1 for _, Q, _ in seen["oar_calls"] if Q == 1) > 0
    assert m["glue_ms_per_step"]["value"] > 0
    assert "ingest_ms_per_frame" not in m
