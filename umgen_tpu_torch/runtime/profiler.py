"""Profiling and tracing of the port (port of umgen_tpu/runtime/profiler.py).

* `span(name, *attrs)` — a named region of the program.  The tracer is off
  by default; then `span` returns one shared null context after a single
  flag check (no allocation, no CUDA event, no `record_function`).  While it
  is on, a span records its name, attributes, id, its parent's id, the index
  of the frame step it belongs to, and host start / end stamped on
  `perf_counter_ns` and converted to unix ns, the clock `torch.profiler`
  stamps its CPU ops and CUDA activity with
  (`prof.profiler.kineto_results.trace_start_ns()` + an event's µs · 1000).
  The spans that `SPANS` marks device-timed also put a pair of CUDA events
  around their body when the tracer runs on a card.  While a
  `torch.profiler` session is active each span also opens
  `torch.profiler.record_function(name)`, so the program's spans and the
  card's kernels land in one trace; outside a session it never does.  A
  span's attributes are positional and named by `SPANS`, so that the off
  path builds no keyword dict.
* `count(name, n=1)` — a counter of the current frame step; returns at once
  while the tracer is off.
* `start(device, keep)`, `take()`, `stop()` — switch the tracer on for the
  process (`keep=False`: the spans open their `record_function` ranges and
  no span is recorded; the counters are kept), take its records and
  counters out (after the measured work: the one synchronization is
  there), switch it off.
* `trace(log_dir)` — a context manager around `torch.profiler`: CPU
  activity, and the card's kernels (CUDA activity) when the run's device is
  a card, with the tracer on, keeping no span records, for its body; at its
  end a Chrome / TensorBoard trace is written under `log_dir`
  (`tensorboard_trace_handler`: `<worker>.<ns>.pt.trace.json`, the worker
  named by the data-parallel rank where there is one, so each rank writes
  its own file), and beside it the counters of each frame step,
  `<worker>.<ns>.counters.json` ({frame: {counter: n}}, frame "null"
  outside a frame step: the decode steps by the kernel `Rollout.oar_step`
  chose).  Open the trace in Perfetto (ui.perfetto.dev), chrome://tracing,
  or TensorBoard's profiler plugin.  A no-op for None or "".

The tracer serves one thread: the rollout's.
"""

from __future__ import annotations

import contextlib
import json
import os
import socket
import time
from typing import Dict, List, Optional

import torch

# the program's spans: (attribute names, in the order `span` takes them;
# device-timed).  A frame step's "frame" is the absolute index of the frame
# it decodes (None in recompute mode); "kernel" is `Rollout.oar_step`'s
# choice (models/rollout.py KERNELS).
SPANS = {
    "umgen.frame": (("mode", "B", "frame"), True),
    "umgen.ingest": (("B", "abs_frame"), True),
    "umgen.ego": ((), True),
    "umgen.tar": ((), True),
    "umgen.oar": ((), True),
    "umgen.oar_step": (("kernel", "B", "Q", "cache_len"), False),
    "umgen.glue": (("mod",), False),
    "umgen.head": ((), False),
    "umgen.sample": (("role",), False),
    "umgen.rules": ((), False),
    "umgen.embed": ((), False),
    "umgen.flash": (("B", "Sq", "Sk", "causal", "H", "Dh"), False),
    "umgen.rollout": ((), False),
    "umgen.decode": ((), False),
}
FRAME = "umgen.frame"
_TIMED = frozenset(n for n, (_, timed) in SPANS.items() if timed)


class _Null:
    """The span of a tracer that is off."""
    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


_NULL = _Null()


class _Tracer:
    """The process's tracer: on / off, its clock pair, open spans, records
    and counters."""

    def __init__(self):
        self.on = self.keep = False
        self.events = False
        self.stream = None
        self._reset()

    def _reset(self):
        self.clock = (time.time_ns(), time.perf_counter_ns())
        self.stack: List["_Span"] = []
        self.records: List["_Span"] = []
        self.next_id = 0
        self.frames = 0            # frame steps begun since start
        self.frame: Optional[int] = None
        self.counters: Dict[Optional[int], Dict[str, int]] = {None: {}}
        self.counts = self.counters[None]


_T = _Tracer()
_now = time.perf_counter_ns
_profiling = torch._C._autograd._profiler_enabled


class _Span:
    __slots__ = ("name", "attrs", "id", "parent", "frame", "t0", "t1",
                 "ev", "rf", "profiled")

    def __init__(self, name, attrs):
        self.name, self.attrs = name, attrs

    def __enter__(self):
        T = _T
        self.id = T.next_id
        T.next_id += 1
        self.parent = T.stack[-1].id if T.stack else None
        if self.name == FRAME:
            T.frame, T.frames = T.frames, T.frames + 1
            T.counts = T.counters.setdefault(T.frame, {})
        self.frame = T.frame
        T.stack.append(self)
        self.t0 = _now()
        self.rf = None
        self.profiled = _profiling()
        if self.profiled:
            self.rf = torch.profiler.record_function(self.name)
            self.rf.__enter__()
        self.ev = None
        if T.events and self.name in _TIMED:
            self.ev = (torch.cuda.Event(enable_timing=True),
                       torch.cuda.Event(enable_timing=True))
            self.ev[0].record(T.stream)
        return self

    def __exit__(self, exc_type, exc, tb):
        T = _T
        if self.ev is not None:
            self.ev[1].record(T.stream)
        if self.rf is not None:
            self.rf.__exit__(exc_type, exc, tb)
        self.t1 = _now()
        T.stack.pop()
        if self.name == FRAME:
            T.frame = None
            T.counts = T.counters[None]
        if T.keep:
            T.records.append(self)
        return False


def span(name: str, a0=None, a1=None, a2=None, a3=None, a4=None, a5=None):
    """A region named `name` with the attributes `SPANS[name]` names, in
    that order; the shared null context while the tracer is off."""
    if not _T.on:
        return _NULL
    return _Span(name, (a0, a1, a2, a3, a4, a5))


def count(name: str, n: int = 1) -> None:
    """Add `n` to the current frame step's counter `name` (outside a frame
    step, to the counters of frame None)."""
    if not _T.on:
        return
    c = _T.counts
    c[name] = c.get(name, 0) + n


def start(device=None, keep: bool = True) -> None:
    """Switch the tracer on for the process, with nothing recorded; the
    device-timed spans take CUDA events when `device` is a card, recorded
    on the stream current there now (the program's one stream: looking it
    up a span would cost more than the events).  `keep=False`: no span
    record is kept, and no CUDA event taken; the spans only open their
    `record_function` ranges under a profiler; the counters are kept."""
    _T._reset()
    _T.events = keep and device is not None \
        and torch.device(device).type == "cuda"
    _T.stream = torch.cuda.current_stream(device) if _T.events else None
    _T.on, _T.keep = True, keep


def take() -> Dict:
    """The records and counters since `start` or the last `take`, and clear
    them: {"spans": [{name, attrs, id, parent, frame, start_ns, end_ns (unix
    ns), device_ms (None where not device-timed), profiled (it opened its
    `record_function` range: a profiler was on)}] in the order they
    closed, "counters": {frame: {name: n}} (frame None: outside a frame
    step)}.  Waits for the card where a span holds CUDA events."""
    T = _T
    done, T.records = T.records, []
    counters = {f: c for f, c in T.counters.items() if c}
    T.counters = {f: {} for f in (None, T.frame)}
    T.counts = T.counters[T.frame]
    if any(s.ev is not None for s in done):
        torch.cuda.synchronize()
    unix0, perf0 = T.clock
    return {"spans": [{"name": s.name, "id": s.id,
                       "attrs": dict(zip(SPANS.get(s.name, ((),))[0],
                                         s.attrs)),
                       "parent": s.parent, "frame": s.frame,
                       "start_ns": s.t0 - perf0 + unix0,
                       "end_ns": s.t1 - perf0 + unix0,
                       "device_ms": (None if s.ev is None else
                                     s.ev[0].elapsed_time(s.ev[1])),
                       "profiled": s.profiled}
                      for s in done],
            "counters": counters}


def stop() -> Dict:
    """Switch the tracer off; what `take` would give."""
    out = take()
    _T.on = _T.keep = False
    _T._reset()
    return out


@contextlib.contextmanager
def trace(log_dir: Optional[str], device=None, rank: Optional[int] = None):
    """Profile the body with the tracer on; write its trace under `log_dir`
    at the end.  `device`: the run's device (its CUDA kernels are traced
    when it is a card); `rank`: the data-parallel rank, which names the
    trace file."""
    if not log_dir:
        yield None
        return
    from torch.profiler import (ProfilerActivity, profile,
                                tensorboard_trace_handler)
    activities = [ProfilerActivity.CPU]
    if device is not None and torch.device(device).type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    worker = socket.gethostname() + ("" if rank is None else f"_rank{rank}")
    start(keep=False)          # the trace shows the spans; no record kept
    try:
        with profile(activities=activities,
                     on_trace_ready=tensorboard_trace_handler(
                         log_dir, worker_name=worker)) as prof:
            yield prof
    finally:
        counters = stop()["counters"]
        os.makedirs(log_dir, exist_ok=True)
        path = os.path.join(log_dir,
                            f"{worker}.{time.time_ns()}.counters.json")
        with open(path, "w") as f:
            json.dump(counters, f, indent=1)
