"""The benchmark's own instrumentation: spans recorded around calls into the
program's layers, and the reduction of a `torch.profiler` slice to tables.

Spans (`Spans.wrap`) put a pair of CUDA events around each call of a bound
method while they are on: no synchronization inside the window, the
elapsed device time read once the window has closed.  The profiler slice
is kept in memory and reduced here to what the per-layer readers and the
result's breakdown read: every device operation with its duration, the
benchmark span its launch fell in and the program's spans open at its
launch (`umgen.*`, umgen_tpu_torch/runtime/profiler.py: each opens a
`record_function` range while a profiler runs), the busy and wall seconds
of the slice, and the longest idle gaps by what the host was doing
meanwhile.
"""

from __future__ import annotations

import bisect
from collections import defaultdict
from typing import Dict, List, Optional, Tuple

import torch

SPAN_PREFIX = "bench."
PROGRAM_PREFIX = "umgen."


class Spans:
    """Named device-time spans around method calls, on while `on`."""

    def __init__(self):
        self.on = False
        self.events: Dict[str, List[Tuple]] = defaultdict(list)

    def wrap(self, obj, attr: str, name: str) -> None:
        fn = getattr(obj, attr)

        def timed(*a, **k):
            if not self.on:
                return fn(*a, **k)
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            out = fn(*a, **k)
            end.record()
            self.events[name].append((start, end))
            return out
        setattr(obj, attr, timed)

    def ms(self) -> Dict[str, List[float]]:
        """Each span's device milliseconds, call by call (synchronizes)."""
        torch.cuda.synchronize()
        return {n: [s.elapsed_time(e) for s, e in ev]
                for n, ev in self.events.items()}


def _union(intervals: List[Tuple[float, float]]):
    """Sorted disjoint union of (start, end) intervals."""
    out: List[List[float]] = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def open_at(ranges: List[Tuple[float, float, str]], times: List[float]
            ) -> List[Tuple[str, ...]]:
    """For each of `times`, the names of the `ranges` (start, end, name;
    nested as one thread's ranges are) that hold it, outermost first."""
    ranges = sorted(ranges, key=lambda r: (r[0], -r[1]))
    out: List[Tuple[str, ...]] = [()] * len(times)
    stack, j = [], 0
    for i in sorted(range(len(times)), key=times.__getitem__):
        t = times[i]
        while j < len(ranges) and ranges[j][0] <= t:
            while stack and stack[-1][1] < ranges[j][0]:
                stack.pop()
            stack.append(ranges[j])
            j += 1
        while stack and stack[-1][1] < t:
            stack.pop()
        out[i] = tuple(r[2] for r in stack)
    return out


def reduce_session(prof, session: str) -> Optional[Dict]:
    """One profiled session (its CPU range named `session`) → {"busy_s",
    "window_s", "ops": [(device op name, µs, benchmark span of its launch
    or None)], "program": [the program's spans open at each op's launch,
    outermost first, in the order of "ops"], "gaps": {host op: idle µs}};
    None when the trace holds no device operation (a profiler that cannot
    see the card)."""
    from torch.autograd import DeviceType
    evs = prof.events()
    # device operations: kernels, copies and sets, not the device-side
    # copies of the benchmark's or the program's annotations
    dev = [e for e in evs if e.device_type == DeviceType.CUDA
           and not getattr(e, "is_user_annotation", False)
           and not e.name.startswith((SPAN_PREFIX, PROGRAM_PREFIX))]
    cpu = [e for e in evs if e.device_type == DeviceType.CPU]
    rng = [e for e in cpu if e.name == session]
    if not dev or not rng:
        return None
    s0 = min(e.time_range.start for e in rng)
    s1 = max(e.time_range.end for e in rng)
    launches = {e.id: e for e in cpu if e.name.startswith("cu")}
    spans = sorted((e.time_range.start, e.time_range.end, e.name)
                   for e in cpu if e.name.startswith(SPAN_PREFIX)
                   and e.name != session)
    starts = [s[0] for s in spans]
    ops, iv, at = [], [], []
    for k in dev:
        launch = launches.get(k.id)
        t = launch.time_range.start if launch is not None else \
            k.time_range.start
        if not s0 <= t <= s1:
            continue
        i = bisect.bisect_right(starts, t) - 1
        span = spans[i][2] if i >= 0 and spans[i][1] >= t else None
        ops.append((k.name, k.time_range.end - k.time_range.start, span))
        iv.append((k.time_range.start, k.time_range.end))
        at.append(t)
    if not ops:
        return None
    thread = rng[0].thread
    program = open_at([(e.time_range.start, e.time_range.end, e.name)
                       for e in cpu if e.thread == thread
                       and e.name.startswith(PROGRAM_PREFIX)], at)
    end = max(s1, max(e for _, e in iv))
    busy = _union(iv)
    # idle gaps inside the session, each named by the innermost host op
    # running at its middle (the thread that ran the session)
    host = sorted(((e.time_range.start, e.time_range.end, e.name)
                   for e in cpu if e.thread == thread and e.name != session),
                  key=lambda h: (h[0], -h[1]))
    edges = [s0] + [x for b in busy for x in b] + [end]
    gaps = [(edges[i], edges[i + 1]) for i in range(0, len(edges), 2)
            if edges[i + 1] > edges[i]]
    named: Dict[str, float] = defaultdict(float)
    stack: List[Tuple] = []
    j = 0
    for a, b in sorted(gaps, key=lambda g: g[0] + g[1]):
        mid = (a + b) / 2
        while j < len(host) and host[j][0] <= mid:
            while stack and stack[-1][1] <= host[j][0]:
                stack.pop()
            stack.append(host[j])
            j += 1
        while stack and stack[-1][1] < mid:
            stack.pop()
        named[stack[-1][2] if stack else "(no host op)"] += b - a
    return {"busy_s": sum(e - s for s, e in busy) / 1e6,
            "window_s": (end - s0) / 1e6, "ops": ops, "program": program,
            "gaps": dict(named)}


def breakdown(sessions: List[Dict], top: int = 10) -> Dict:
    """The device operations that took most time and the longest idle gaps
    by host op, over the sessions, in seconds."""
    by_op: Dict[str, float] = defaultdict(float)
    by_gap: Dict[str, float] = defaultdict(float)
    for s in sessions:
        for name, us, _ in s["ops"]:
            by_op[name[:120]] += us / 1e6
        for name, us in s["gaps"].items():
            by_gap[name[:120]] += us / 1e6

    def first(d):
        return [[k, v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])
                [:top]]
    return {"device_ops": first(by_op), "idle_gaps": first(by_gap)}
