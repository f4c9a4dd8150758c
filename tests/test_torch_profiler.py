"""The port's profiler (runtime/profiler.py) on the CPU: `trace(None)` is a
no-op; `trace(dir)` writes a Chrome / TensorBoard trace that holds a `span`
region (the tracer is on for its body, keeping no span records) and the
counters of each frame step beside it, one file each a data-parallel rank;
and the CLI's `--profile_dir` traces the scene loop (`evaluate.run_dataset`,
here through SceneRunner on a stand-in Generator, so that no model runs).
The card's kernels in a trace are chip_smoke.py's phase z (z3); the tracer
itself is tests/test_torch_tracer.py's."""

import glob
import json
import os

import numpy as np
import pytest
import torch

from umgen_tpu_torch.config import InferConfig
from umgen_tpu_torch.layout import SequenceLayout
from umgen_tpu_torch.runtime import profiler
from umgen_tpu_torch.tools import evaluate
from umgen_tpu_torch.tools.harness import SceneRunner


def _events(log_dir):
    [path] = glob.glob(os.path.join(str(log_dir), "*.pt.trace.json"))
    with open(path) as f:
        return path, {e.get("name") for e in json.load(f)["traceEvents"]}


@pytest.mark.parametrize("log_dir", [None, ""])
def test_trace_without_a_directory_is_a_no_op(tmp_path, monkeypatch,
                                             log_dir):
    monkeypatch.chdir(tmp_path)
    with profiler.trace(log_dir) as prof:
        with profiler.span("umgen.nothing"):
            torch.ones(3).sum()
    assert prof is None
    assert os.listdir(tmp_path) == []


def test_trace_writes_an_annotated_trace_per_rank(tmp_path):
    with profiler.trace(str(tmp_path), device="cpu", rank=1):
        with profiler.span("umgen.test_region"):
            (torch.ones(64, 64) @ torch.ones(64, 64)).sum()
        # the trace holds the spans; the tracer keeps no record of them
        assert profiler.take() == {"spans": [], "counters": {}}
        with profiler.span("umgen.frame", "cached", 1, 4):
            profiler.count("oar_steps.eager", 3)
    path, names = _events(tmp_path)
    assert "_rank1." in os.path.basename(path)
    assert "umgen.test_region" in names
    assert any(n and n.startswith("aten::") for n in names)
    # beside it, the counters of each frame step
    [counters] = glob.glob(os.path.join(str(tmp_path), "*.counters.json"))
    assert "_rank1." in os.path.basename(counters)
    with open(counters) as f:
        assert json.load(f) == {"0": {"oar_steps.eager": 3}}


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
