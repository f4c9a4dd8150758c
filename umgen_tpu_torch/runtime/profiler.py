"""Profiling and tracing hooks (port of umgen_tpu/runtime/profiler.py).

* `trace(log_dir)` — a context manager around `torch.profiler`: CPU
  activity, and the card's kernels (CUDA activity) when the run's device is
  a card; at its end a Chrome / TensorBoard trace is written under
  `log_dir` (`tensorboard_trace_handler`: `<worker>.<ns>.pt.trace.json`,
  the worker named by the data-parallel rank where there is one, so each
  rank writes its own file).  Open it in Perfetto (ui.perfetto.dev),
  chrome://tracing, or TensorBoard's profiler plugin.  A no-op for None or
  "".
* `annotate(name)` — a named region in the trace
  (`torch.profiler.record_function`).
* `FrameTimer` — per-name wall-clock samples with p50 / p90 summaries
  (numpy and the host clock, as the JAX package's).
"""

from __future__ import annotations

import contextlib
import socket
import time
from typing import Dict, List, Optional

import numpy as np
import torch


@contextlib.contextmanager
def trace(log_dir: Optional[str], device=None, rank: Optional[int] = None):
    """Profile the body; write its trace under `log_dir` at the end.
    `device`: the run's device (its CUDA kernels are traced when it is a
    card); `rank`: the data-parallel rank, which names the trace file."""
    if not log_dir:
        yield None
        return
    from torch.profiler import (ProfilerActivity, profile,
                                tensorboard_trace_handler)
    activities = [ProfilerActivity.CPU]
    if device is not None and torch.device(device).type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    worker = socket.gethostname() + ("" if rank is None else f"_rank{rank}")
    with profile(activities=activities,
                 on_trace_ready=tensorboard_trace_handler(
                     log_dir, worker_name=worker)) as prof:
        yield prof


def annotate(name: str):
    return torch.profiler.record_function(name)


class FrameTimer:
    def __init__(self):
        self.samples: Dict[str, List[float]] = {}

    @contextlib.contextmanager
    def measure(self, name: str):
        t0 = time.perf_counter()
        yield
        self.samples.setdefault(name, []).append(time.perf_counter() - t0)

    def summary(self) -> Dict[str, Dict[str, float]]:
        out = {}
        for name, xs in self.samples.items():
            a = np.asarray(xs)
            out[name] = {
                "n": int(a.size),
                "mean_s": float(a.mean()),
                "p50_s": float(np.percentile(a, 50)),
                "p90_s": float(np.percentile(a, 90)),
                "total_s": float(a.sum()),
            }
        return out

    def report(self) -> str:
        lines = []
        for name, s in self.summary().items():
            lines.append(f"{name}: n={s['n']} p50={s['p50_s']*1e3:.1f}ms "
                         f"p90={s['p90_s']*1e3:.1f}ms "
                         f"total={s['total_s']:.2f}s")
        return "\n".join(lines)
