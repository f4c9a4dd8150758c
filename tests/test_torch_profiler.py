"""The port's profiler (runtime/profiler.py) against the JAX package's, on
the CPU: `FrameTimer` gives JAX's summary and report on the same samples;
`trace(None)` is a no-op; `trace(dir)` writes a Chrome / TensorBoard trace
that holds an `annotate` region, one file a data-parallel rank; and the
CLI's `--profile_dir` traces the scene loop (`evaluate.run_dataset`, here
through SceneRunner on a stand-in Generator, so that no model runs).  The
card's kernels in a trace are chip_smoke.py's phase z (z3)."""

import glob
import json
import os
import time

import numpy as np
import pytest
import torch

from umgen_tpu.runtime import profiler as jprofiler
from umgen_tpu_torch.config import InferConfig
from umgen_tpu_torch.layout import SequenceLayout
from umgen_tpu_torch.runtime import profiler
from umgen_tpu_torch.tools import evaluate
from umgen_tpu_torch.tools.harness import SceneRunner


def _events(log_dir):
    [path] = glob.glob(os.path.join(str(log_dir), "*.pt.trace.json"))
    with open(path) as f:
        return path, {e.get("name") for e in json.load(f)["traceEvents"]}


def test_frame_timer_matches_jax():
    rng = np.random.default_rng(0)
    samples = {"frame": list(rng.uniform(0.1, 2.0, 7)),
               "oar": list(rng.uniform(1e-3, 5e-3, 12))}
    port, jax_ = profiler.FrameTimer(), jprofiler.FrameTimer()
    port.samples = {k: list(v) for k, v in samples.items()}
    jax_.samples = {k: list(v) for k, v in samples.items()}
    assert port.summary() == jax_.summary()
    assert port.report() == jax_.report()
    with port.measure("sleep"):
        time.sleep(0.01)
    assert port.summary()["sleep"]["n"] == 1
    assert port.summary()["sleep"]["total_s"] >= 0.01


@pytest.mark.parametrize("log_dir", [None, ""])
def test_trace_without_a_directory_is_a_no_op(tmp_path, monkeypatch,
                                             log_dir):
    monkeypatch.chdir(tmp_path)
    with profiler.trace(log_dir) as prof:
        with profiler.annotate("umgen.nothing"):
            torch.ones(3).sum()
    assert prof is None
    assert os.listdir(tmp_path) == []


def test_trace_writes_an_annotated_trace_per_rank(tmp_path):
    with profiler.trace(str(tmp_path), device="cpu", rank=1):
        with profiler.annotate("umgen.test_region"):
            (torch.ones(64, 64) @ torch.ones(64, 64)).sum()
    path, names = _events(tmp_path)
    assert "_rank1." in os.path.basename(path)
    assert "umgen.test_region" in names
    assert any(n and n.startswith("aten::") for n in names)


class _StandIn:
    """Generator's surface for SceneRunner: the window, then frames of
    zeros; no model."""

    def __init__(self):
        self.model = type("M", (), {"layout": SequenceLayout(
            "pose_map_bbox3d_image")})()
        self.mesh, self.device, self.frame_seconds = None, "cpu", []

    def generate(self, cond, new_frames, cond_frames, input_cond_frames,
                 **kw):
        self.frame_seconds += [0.0] * new_frames
        return {m: np.concatenate([v[:, :input_cond_frames], np.zeros(
            (v.shape[0], new_frames, v.shape[2]), v.dtype)], axis=1)
            for m, v in cond.items()}


def test_cli_profile_dir_traces_the_scene_loop(tmp_path):
    """`--profile_dir` wraps the scene loop in a trace (the JAX CLI's
    start/stop_trace around it): the harness's rollout region is in it;
    without the flag nothing is traced."""
    args = evaluate.build_parser().parse_args(
        ["--device", "cpu", "--synthetic_data", "1", "--save_video", "false",
         "--set_num_new_frames", "1", "--data_root", str(tmp_path / "none"),
         "--output_path", str(tmp_path / "out"), "--profile_dir",
         str(tmp_path / "prof")])
    evaluate.check_args(args)
    infer = InferConfig.for_task("video", 1)
    runner = SceneRunner(_StandIn(), infer, output_path=args.output_path,
                         save_video=False)
    evaluate.run_dataset(args, runner, infer, runner.pipeline)
    _, names = _events(tmp_path / "prof")
    assert {"umgen.rollout", "umgen.decode"} <= names
    assert len(os.listdir(tmp_path / "out" / "saved_token")) == 1
