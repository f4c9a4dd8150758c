"""The port's scene videos on the CPU: tools/visualize.py (the copy),
SceneRunner's picture decode and its three video branches, the CLI's
`--save_video`, and tools/decode_tokens.py, against the JAX package's where
it has a counterpart.

The VQ decoders are the tiny configs of tests/test_torch_vq.py, patched into
both packages' MAP_VQ / IMAGE_VQ (which the decoder classes read when they
are built); no test here decodes at full VQ width.  Tolerances: the
copied visualizer renders JAX's uint8 frames exactly; decoded pictures agree
within test_torch_vq's 2e-4; decode_tokens' uint8 frames, whose pictures
differ by that much, within one level on at most 0.1% of the values.
"""

import os
import pickle
import sys

import numpy as np
import pytest
import torch

from test_torch_vq import ATOL, jax_params, patch_tiny, reference_state_dict
from umgen_tpu.tools import decode_tokens as jdt
from umgen_tpu.tools import harness as jharness
from umgen_tpu.tools import visualize as jvz
from umgen_tpu_torch.config import InferConfig, ModelConfig
from umgen_tpu_torch.data.synthetic import make_token_batch
from umgen_tpu_torch.layout import SequenceLayout
from umgen_tpu_torch.models import vq as tvq
from umgen_tpu_torch.params import from_jax
from umgen_tpu_torch.tools import decode_tokens as tdt
from umgen_tpu_torch.tools import evaluate
from umgen_tpu_torch.tools import harness as tharness
from umgen_tpu_torch.tools import visualize as tvz

cv2 = pytest.importorskip("cv2")

T = 21


@pytest.fixture(autouse=True)
def two_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _boxes(T=3, N=6, seed=0):
    rng = np.random.default_rng(seed)
    boxes = np.zeros((T, N, 10), np.float32)
    boxes[..., 0:2] = rng.uniform(-20, 20, (T, N, 2))
    boxes[..., 3] = rng.uniform(0.5, 6, (T, N))
    boxes[..., 4] = rng.uniform(0.5, 3, (T, N))
    boxes[..., 6] = rng.uniform(-np.pi, np.pi, (T, N))
    boxes[..., 7:9] = rng.uniform(-3, 3, (T, N, 2))
    return boxes, rng.integers(0, 3, (T, N)), rng.random((T, N)) < 0.8


def _frames_of(module, monkeypatch, fn, *a, **k):
    """The frames `fn` hands to `module.write_video`."""
    got = []
    monkeypatch.setattr(module, "write_video",
                        lambda frames, path, fps=10: got.extend(frames))
    fn(*a, **k)
    return got


def _mp4(path):
    cap = cv2.VideoCapture(str(path))
    n = int(cap.get(cv2.CAP_PROP_FRAME_COUNT))
    size = (int(cap.get(cv2.CAP_PROP_FRAME_WIDTH)),
            int(cap.get(cv2.CAP_PROP_FRAME_HEIGHT)))
    cap.release()
    return n, size


def test_visualize_renders_jaxs_frames(monkeypatch):
    """Frame for frame, the same uint8 pictures from the same inputs: the
    pred | GT panel with its collision marks (the port's native helper
    against JAX's collision matrix), and the scene video with a map
    underlay, a camera panel and the GT pose."""
    boxes, cats, valid = _boxes(T=3)
    gb, gc, gv = _boxes(T=3, seed=1)
    rng = np.random.default_rng(2)
    maps = rng.uniform(-1, 1, (3, 64, 64, 3)).astype(np.float32)
    images = rng.uniform(-1, 1, (3, 32, 64, 3)).astype(np.float32)
    pose = rng.normal(size=(3, 3)).astype(np.float32)
    kw = dict(gt_boxes=gb, gt_cats=gc, gt_valid=gv, pred_maps=maps,
              gt_maps=maps[::-1], pose=pose, cond_frames=2)
    a = _frames_of(tvz, monkeypatch, tvz.render_pred_gt_video, "x.mp4",
                   boxes, cats, valid, **kw)
    b = _frames_of(jvz, monkeypatch, jvz.render_pred_gt_video, "x.mp4",
                   boxes, cats, valid, **kw)
    kw = dict(pose=pose, maps_rgb=maps, images=images, cond_frames=2,
              scene_name="s", gt_pose=pose[:2])
    a += _frames_of(tvz, monkeypatch, tvz.render_scene_video, "x.mp4",
                    boxes, cats, valid, **kw)
    b += _frames_of(jvz, monkeypatch, jvz.render_scene_video, "x.mp4",
                    boxes, cats, valid, **kw)
    assert len(a) == len(b) == 6
    for x, y in zip(a, b):
        assert x.dtype == np.uint8
        np.testing.assert_array_equal(x, y)


def _scene(task="pose_map_bbox3d_image", seed=0):
    cfg = ModelConfig().scaled("tiny")
    return make_token_batch(SequenceLayout(task), T=T, B=1, seed=seed,
                            config=cfg)


def _runners(tmp_path, monkeypatch, **kw):
    """The port's SceneRunner and JAX's, each with tiny decoders on the
    same weights (no generator: `_postprocess` and `decode_tokens` do not
    roll out)."""
    patch_tiny(monkeypatch)
    from umgen_tpu.models import vq as jvq
    pm, pi = jax_params("map", seed=3), jax_params("image", seed=4)
    port = tharness.SceneRunner(
        None, InferConfig(), output_path=str(tmp_path / "port"),
        map_decoder=tvq.MapDecoder(from_jax(pm), device="cpu"),
        image_decoder=tvq.ImageDecoder(from_jax(pi), device="cpu"), **kw)
    ref = jharness.SceneRunner(
        None, None, output_path=str(tmp_path / "jax"),
        map_decoder=jvq.MapDecoder(pm), image_decoder=jvq.ImageDecoder(pi),
        **kw)
    return port, ref


def test_scene_runner_decodes_as_jaxs(tmp_path, monkeypatch):
    port, ref = _runners(tmp_path, monkeypatch, save_video=False)
    out = {m: v[:, :3] for m, v in _scene().items()}
    a, b = port.decode_tokens(out), ref.decode_tokens(out)
    assert sorted(a) == sorted(b) == ["boxes", "cat_ids", "images",
                                      "maps_rgb", "pose", "valid"]
    for k in ("boxes", "cat_ids", "valid", "pose"):
        np.testing.assert_array_equal(a[k], b[k], k)
    assert a["maps_rgb"].shape == (3, 64, 64, 3)
    assert a["images"].shape == (3, 32, 64, 3)
    for k in ("maps_rgb", "images"):
        np.testing.assert_allclose(a[k], b[k], rtol=0, atol=ATOL, err_msg=k)
    assert port.box_overlap.average() == pytest.approx(
        ref.box_overlap.average(), abs=1e-12)


@pytest.mark.parametrize("branch", ["pred_gt", "single", "agent_free"])
def test_scene_runner_writes_a_video_of_every_frame(tmp_path, monkeypatch,
                                                    branch):
    """`_postprocess` (the scene as its own GT) writes video/<scene>.mp4
    with T frames: the pred | GT panel (two 512-wide BEV panels, the GT
    maps decoded), the single panel (`gt_video=False`: the camera image
    over the BEV canvas), the agent-free task's single panel (pose_map: no
    boxes, no image); no decode journal."""
    port, _ = _runners(tmp_path, monkeypatch, save_video=True,
                       gt_video=branch != "single")
    out = _scene("pose_map" if branch == "agent_free" else
                 "pose_map_bbox3d_image")
    decoded = []
    decode = port.decode_tokens
    monkeypatch.setattr(port, "decode_tokens",
                        lambda o: decoded.append(decode(o)) or decoded[-1])
    gt_maps = []
    map_decode = port.map_decoder.decode
    monkeypatch.setattr(port.map_decoder, "decode",
                        lambda t: gt_maps.append(t) or map_decode(t))
    port._postprocess(out, out, "scene", input_cond=20)
    assert not os.path.exists(os.path.join(port.token_save_path,
                                           "undecoded_token.txt"))
    size = {"pred_gt": (1024, 512), "single": (512, 768),
            "agent_free": (512, 512)}[branch]
    assert _mp4(tmp_path / "port" / "video" / "scene.mp4") == (T, size)
    # the pred | GT branch decodes the GT maps too
    assert len(gt_maps) == (2 if branch == "pred_gt" else 1)
    assert ("images" in decoded[0]) == (branch != "agent_free")


def test_render_video_needs_cv2(tmp_path, monkeypatch):
    port, _ = _runners(tmp_path, monkeypatch, save_video=True)
    out = _scene()
    monkeypatch.setattr(tvz, "HAS_CV2", False)
    with pytest.raises(RuntimeError, match="save_video=False"):
        port._postprocess(out, out, "scene", input_cond=20)


CLI = ["--model_scale", "tiny", "--debug", "--synthetic_data", "1",
       "--max_scenes", "1", "--set_num_new_frames", "1", "--device", "cpu"]


def test_cli_writes_the_scene_video_by_default(tmp_path, monkeypatch,
                                               capsys):
    """The CLI at the tiny scale with `--save_video` left at its default
    (on) builds the two decoders and writes video/<scene>.mp4 with 21
    frames beside the token pickle; no decode journal.  The agent-free task
    (`--pred_task pose_map`, half the positions of a frame): its single
    panel; the default task's pred | GT video from the CLI is
    tests/test_torch_import.py::test_cli_writes_videos_stands_alone."""
    patch_tiny(monkeypatch)
    args = evaluate.build_parser().parse_args(
        CLI + ["--pred_task", "pose_map", "--output_path", str(tmp_path)])
    assert args.save_video and not args.no_gt_video
    runner, _ = evaluate.run(args)
    assert isinstance(runner.map_decoder, tvq.MapDecoder)
    assert isinstance(runner.image_decoder, tvq.ImageDecoder)
    [name] = os.listdir(tmp_path / "saved_token")
    scene = name.replace("_tokens.pkl", "")
    assert os.listdir(tmp_path / "video") == [f"{scene}.mp4"]
    assert _mp4(tmp_path / "video" / f"{scene}.mp4") == (21, (512, 512))
    assert "decode failed" not in capsys.readouterr().out


def test_cli_builds_no_decoder_under_save_video_false(tmp_path):
    """`--save_video false`: no decoder is built (the JAX CLI builds and runs
    them and drops the pictures), and SceneRunner writes no video."""
    args = evaluate.build_parser().parse_args(
        CLI + ["--save_video", "false"])
    assert evaluate.build_decoders(args, torch.device("cpu")) == (None, None)
    runner = tharness.SceneRunner(None, InferConfig(),
                                  output_path=str(tmp_path),
                                  save_video=False)
    out = _scene()
    runner._postprocess(out, out, "scene", input_cond=20)
    assert os.listdir(tmp_path / "video") == []
    assert os.listdir(tmp_path / "saved_token") == ["scene_tokens.pkl"]


def test_cli_refuses_save_video_without_cv2(tmp_path, monkeypatch):
    """Where cv2 does not import, `--save_video` (the default) stops the run
    before anything is built, naming `--save_video false`."""
    monkeypatch.setitem(sys.modules, "cv2", None)
    built = []
    monkeypatch.setattr(evaluate, "build_params",
                        lambda *a, **k: built.append(1))
    args = evaluate.build_parser().parse_args(
        CLI + ["--output_path", str(tmp_path)])
    with pytest.raises(SystemExit, match="--save_video false"):
        evaluate.run(args)
    assert not built and not os.path.exists(tmp_path / "saved_token")


def test_decode_tokens_gives_jaxs_frames(tmp_path, monkeypatch):
    """A token pickle and reference-format VQ checkpoints the test writes,
    through both packages' decode_token_file: the same frames, within one
    uint8 level on at most 0.1% of the values; the port's CLI entry writes
    an mp4 of every frame.  JAX's importer hands numpy leaves, and its
    jitted decode cannot index a numpy codebook with traced tokens (a
    TracerArrayConversionError: the JAX package's decode_tokens, and its
    CLI's decode, fail on any VQ checkpoint that exists), so its side here
    gets the same leaves as jax arrays."""
    import jax
    from umgen_tpu.runtime import torch_import as jti
    load = jti.load_vq_checkpoint
    monkeypatch.setattr(jti, "load_vq_checkpoint", lambda *a: jax.tree.map(
        jax.numpy.asarray, load(*a)))
    patch_tiny(monkeypatch)
    ckpt = {}
    for name, seed in (("map", 5), ("image", 6)):
        ckpt[name] = str(tmp_path / f"{name}.ckpt")
        torch.save({"state_dict": reference_state_dict(
            jax_params(name, seed=seed))}, ckpt[name])
    tokens = {m: v[:, :4] for m, v in _scene(seed=7).items()}
    pkl = str(tmp_path / "x_tokens.pkl")
    with open(pkl, "wb") as f:
        pickle.dump(tokens, f)
    a = _frames_of(tvz, monkeypatch, tdt.decode_token_file, pkl, "x.mp4",
                   ckpt["map"], ckpt["image"], device="cpu")
    b = _frames_of(jvz, monkeypatch, jdt.decode_token_file, pkl, "x.mp4",
                   ckpt["map"], ckpt["image"])
    assert len(a) == len(b) == 4
    for x, y in zip(a, b):
        assert x.shape == y.shape == (32 + 64, 64, 3)   # image over map
        d = np.abs(x.astype(int) - y)
        assert d.max() <= 1 and (d > 0).mean() <= 1e-3
    monkeypatch.undo()
    patch_tiny(monkeypatch)
    tdt.main([pkl, "--map_ckpt", ckpt["map"], "--image_ckpt",
              ckpt["image"], "--device", "cpu"])
    assert _mp4(tmp_path / "x.mp4") == (4, (64, 96))
