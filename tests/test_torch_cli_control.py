"""The port's CLI end to end on the CPU, at the tiny scale, for what the
reference CLI does beyond the video task on random weights: `--infer_task
control` (control pkls read from `data/controlled_scenes` under the working
directory, a temporary one here), `--init_token_mod map,image`, and
`--ckpt_dir` on a reference-format state dict the test writes.  Each run is
the CLI's code path (`evaluate.run`) cut to one generated frame (the
control task's count is fixed at 30 by `InferConfig.for_task`, as the
reference's, so the control runs patch that) and must write its token
pickle, replay or force what it was given, and print the agent metrics the
JAX CLI prints.
"""

import dataclasses
import os
import pickle

import numpy as np
import pytest
import torch

from test_torch_checkpoint import reference_state_dict
from umgen_tpu_torch.config import InferConfig, ModelConfig
from umgen_tpu_torch.data.synthetic import make_control_scene, make_token_batch
from umgen_tpu_torch.layout import SequenceLayout
from umgen_tpu_torch.tools import evaluate

VOCAB = {"pose": 1024, "map": 8192, "bbox3d": 1028, "image": 8192}
ROW = {"pose": 3, "map": 1024, "bbox3d": 660, "image": 512}
BASE = ["--model_scale", "tiny", "--device", "cpu", "--fused_oar",
        "--kv_dtype", "bfloat16", "--sample_method", "greedy"]


@pytest.fixture(autouse=True)
def two_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def one_frame(monkeypatch):
    """`InferConfig.for_task` cut to one generated frame."""
    for_task = InferConfig.for_task
    monkeypatch.setattr(InferConfig, "for_task", staticmethod(
        lambda *a, **k: dataclasses.replace(for_task(*a, **k),
                                            num_new_frames=1)))


def write_control_scene(root, cond_frames=13, gt_frames=1, seed=0):
    """A synthetic control pkl (data.synthetic.make_control_scene: the ego
    trajectory and one controlled agent) under `root`/data/controlled_scenes,
    its dataset tokens extended by a GT continuation of `gt_frames` frames
    (so that MMD has something to score).  Returns the scene."""
    layout = SequenceLayout(ModelConfig().task)
    scene = make_control_scene(layout, cond_frames=cond_frames, seed=seed)
    more = make_token_batch(layout, T=gt_frames, B=1, seed=seed + 100)
    scene["dataset_token"] = {
        m: np.concatenate([v, more[m][0].astype(v.dtype)])
        for m, v in scene["dataset_token"].items()}
    d = os.path.join(root, evaluate.CONTROL_ROOT)
    os.makedirs(d, exist_ok=True)
    with open(os.path.join(d, "control_scene_000.pkl"), "wb") as f:
        pickle.dump(scene, f)
    return scene


def _tokens(out_dir):
    [name] = os.listdir(os.path.join(out_dir, "saved_token"))
    with open(os.path.join(out_dir, "saved_token", name), "rb") as f:
        return name, pickle.load(f)


def _check_stream(out, frames):
    assert sorted(out) == sorted(VOCAB)
    for m, v in out.items():
        assert v.shape == (1, frames, ROW[m]), (m, v.shape)
        assert 0 <= v.min() and v.max() < VOCAB[m], m


def _metric_lines(text, mmd=True):
    lines = [ln for ln in text.splitlines()
             if ln.startswith(("collision rate:", "MMD "))]
    assert lines[0].startswith("collision rate: per-frame "), text[-2000:]
    if mmd:
        assert lines[1].startswith("MMD (generated vs GT continuation): "
                                   "posi="), text[-2000:]
        assert all(np.isfinite(float(kv.split("=")[1]))
                   for kv in lines[1].split(": ")[1].split(", "))
    return lines


def test_cli_control_task(tmp_path, monkeypatch, capsys):
    """`--infer_task control`: the scene's 13 conditioning frames, then one
    frame whose ego action is the pkl's first trajectory step and whose
    newest window frame carries the controlled agent; the pickle is named
    after the scene, and the collision rate and MMD lines are printed."""
    monkeypatch.chdir(tmp_path)
    one_frame(monkeypatch)
    scene = write_control_scene(str(tmp_path))
    args = evaluate.build_parser().parse_args(
        BASE + ["--infer_task", "control", "--debug", "--output_path",
                "out"])
    runner, gen = evaluate.run(args)
    name, out = _tokens("out")
    assert name == f"{scene['scene_name']}_tokens.pkl"
    _check_stream(out, 14)
    np.testing.assert_array_equal(out["pose"][0, 13],
                                  scene["control_dict"]["pose"][0])
    for m in VOCAB:
        np.testing.assert_array_equal(out[m][0, :13],
                                      scene["dataset_token"][m][:13])
    _metric_lines(capsys.readouterr().out)
    assert len(gen.frame_seconds) == 1 and runner.mmd.scores["posi"]


def test_cli_control_reads_no_video_scene(tmp_path, monkeypatch):
    """`--infer_task control --synthetic_data 1` writes video scenes, as the
    JAX CLI does, and cannot run them: the JAX CLI fails on a KeyError
    ('dataset_token'), the port with a SystemExit that says why."""
    monkeypatch.chdir(tmp_path)
    one_frame(monkeypatch)
    args = evaluate.build_parser().parse_args(
        BASE + ["--infer_task", "control", "--debug", "--synthetic_data",
                "1", "--output_path", "out"])
    with pytest.raises(SystemExit, match="not a control scene"):
        evaluate.run(args)


def test_cli_init_token_mod_on_an_imported_checkpoint(tmp_path, capsys):
    """`--init_token_mod map,image --ckpt_dir <state dict>`: the weights come
    from the reference-format state dict (DeepSpeed's {"module": ...}
    wrapper, no --debug), int8-quantized and packed for the fused decode
    as random ones are; the generated frame's map and image are the GT
    continuation's; the metric lines are printed."""
    cfg = ModelConfig().scaled("tiny")
    sd = reference_state_dict(cfg, seed=4)
    ckpt = str(tmp_path / "UMGen_Large.pt")
    torch.save({"module": sd}, ckpt)
    out_dir = str(tmp_path / "out")
    args = evaluate.build_parser().parse_args(
        BASE + ["--ckpt_dir", ckpt, "--init_token_mod", "map,image",
                "--synthetic_data", "1", "--max_scenes", "1",
                "--set_num_new_frames", "1", "--output_path", out_dir])
    runner, gen = evaluate.run(args)
    text = capsys.readouterr().out
    assert f"loading model from {ckpt}" in text
    torch.testing.assert_close(
        gen.params["egoe"], sd["transformer.egoe.weight"].to(torch.bfloat16),
        rtol=0, atol=0)
    assert "wq" in gen.params["oar"]["attn"]["qkv"] and \
        "oar_packed" in gen.params
    _, out = _tokens(out_dir)
    _check_stream(out, 21)
    from umgen_tpu_torch.config import DataConfig
    from umgen_tpu_torch.data.dataset import NuPlanTokenDataset
    [gt] = [NuPlanTokenDataset(DataConfig(
        data_root=(os.path.join(out_dir, "synthetic_scenes"),),
        block_size=21))[0]]
    for m in ("map", "image"):
        np.testing.assert_array_equal(out[m][0, 20], gt[m][20], err_msg=m)
    assert (out["bbox3d"][0, 20] != gt["bbox3d"][20]).any()
    _metric_lines(text)
