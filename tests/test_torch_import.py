"""The port stands alone: it runs without JAX and without the JAX package.

Importing it and running a tiny rollout through its CLI (the reference
CLI's default run, with its videos and without, and the decode kernels'
paths), in a fresh interpreter, leaves `jax` and `umgen_tpu` out of
sys.modules; no source file of the port (or chip_smoke.py) imports either;
and the framework-free modules the port copied from the JAX package
(config, layout, data, the visualizer) and the VQ configs still say what
their originals say.
"""

import ast
import dataclasses
import os
import pickle
import re
import subprocess
import sys

import numpy as np
import pytest

from test_torch_vq import TINY_IMAGE, TINY_MAP

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# what the port must never import: JAX, the JAX package, JAX's optimizer
# and checkpoint libraries
FOREIGN = ("jax", "jaxlib", "umgen_tpu", "optax", "orbax")

_CHILD = """
import sys
from umgen_tpu_torch.models import vq
from umgen_tpu_torch.tools import evaluate
if sys.argv[2] == "tiny_vq":      # tests/test_torch_vq.py's tiny codecs
    vq.MAP_VQ = vq.VQConfig(**%r)
    vq.IMAGE_VQ = vq.VQConfig(**%r)
rc = evaluate.main(["--model_scale", "tiny", "--debug", "--synthetic_data",
                    "1", "--max_scenes", "1", "--set_num_new_frames", "1",
                    "--device", "cpu", "--output_path", sys.argv[1]]
                   + sys.argv[3:])
foreign = sorted(m for m in sys.modules
                 if m.split(".")[0] in %r)
assert rc == 0 and not foreign, (rc, foreign[:5])
print("PORT_STANDS_ALONE_OK")
""" % (TINY_MAP, TINY_IMAGE, FOREIGN)


# the bf16-ring slice: the decode kernels' plain versions, greedy
FUSED = ("--infer_task", "video", "--fused_oar", "--kv_dtype", "bfloat16",
         "--sample_method", "greedy")


def _run_cli(tmp_path, *flags, videos=False):
    """The CLI in a fresh interpreter; `--save_video false` unless
    `videos`, then with tests/test_torch_vq.py's tiny VQ configs."""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    # two intra-op threads: the suite runs several workers on the same
    # cores, and torch's default (one thread per core) oversubscribes them
    env["OMP_NUM_THREADS"] = "2"
    if not videos:
        flags += ("--save_video", "false")
    res = subprocess.run([sys.executable, "-c", _CHILD, str(tmp_path),
                          "tiny_vq" if videos else "-", *flags],
                         cwd=ROOT, env=env, capture_output=True, text=True,
                         timeout=300)
    assert res.returncode == 0, res.stderr[-3000:]
    assert "PORT_STANDS_ALONE_OK" in res.stdout
    assert "decode failed" not in res.stdout
    assert len(os.listdir(tmp_path / "video")) == (1 if videos else 0)
    [name] = os.listdir(tmp_path / "saved_token")
    with open(tmp_path / "saved_token" / name, "rb") as f:
        out = pickle.load(f)
    assert {m: v.shape for m, v in out.items()} == {
        "pose": (1, 21, 3), "map": (1, 21, 1024), "bbox3d": (1, 21, 660),
        "image": (1, 21, 512)}
    return res.stdout


def test_port_imports_and_runs_without_jax(tmp_path):
    _run_cli(tmp_path, *FUSED)


def test_cli_default_run_stands_alone(tmp_path):
    """The reference CLI's default run (fp8 rings, the unfused decode on an
    fp8 OAR cache, int8 decode weights, top-k) at the tiny scale: no JAX
    imported, token pickles of the right shapes."""
    _run_cli(tmp_path)


def test_cli_writes_videos_stands_alone(tmp_path):
    """The reference CLI's default run with its videos (`--save_video` on,
    the default; the tiny VQ configs patched in): the map and image
    decoders and the pred | GT video, still without JAX — the scene's mp4
    has 21 frames of two 512-wide panels."""
    import cv2
    _run_cli(tmp_path, videos=True)
    [mp4] = os.listdir(tmp_path / "video")
    cap = cv2.VideoCapture(str(tmp_path / "video" / mp4))
    assert (int(cap.get(cv2.CAP_PROP_FRAME_COUNT)),
            int(cap.get(cv2.CAP_PROP_FRAME_WIDTH))) == (21, 1024)
    cap.release()


def test_cli_serves_the_int4_oar_cache(tmp_path):
    """`--fused_oar --oar_kv_dtype int4` on the CPU: the v5i4 / v5mqi4 plain
    versions decode a frame; token pickles of the right shapes."""
    _run_cli(tmp_path, *FUSED, "--oar_kv_dtype", "int4")


@pytest.mark.parametrize("flags", [
    ("--oar_kv_dtype", "bfloat16"), ("--oar_kv_dtype", "float8_e4m3fn"),
    ("--oar_kernel", "7")], ids=["bf16kv", "fp8kv", "v7"])
def test_cli_serves_the_dense_oar_caches_and_v7(tmp_path, flags):
    """`--fused_oar --oar_kv_dtype bfloat16|float8_e4m3fn` (v2's plain
    version for the single-token steps, the eager body for the pushes) and
    `--oar_kernel 7` (v7's) on the CPU: a frame decodes, token pickles of
    the right shapes, no JAX imported."""
    _run_cli(tmp_path, *FUSED, *flags)


def test_cli_tar_options_and_speculation_stand_alone(tmp_path):
    """`--speculative_k 4 --tar_w4 --kv_dtype int2 --temporal_pe relative`
    (the reference CLI's default decode otherwise) on the CPU: a frame
    decodes, no JAX imported, and the CLI prints the JAX CLI's speculative
    line (drafts accepted a chunk, the factor of fewer OAR steps)."""
    out = _run_cli(tmp_path, "--speculative_k", "4", "--tar_w4",
                   "--kv_dtype", "int2", "--temporal_pe", "relative")
    line = re.search(r"^speculative: (\d+\.\d\d) drafts accepted/chunk "
                     r"\(K=4\), (\d+\.\d\d)x fewer OAR steps on "
                     r"speculative segments$", out, re.M)
    assert line, out[-2000:]
    acc, speedup = (float(g) for g in line.groups())
    assert 0 <= acc <= 4 and speedup == pytest.approx(1 + acc, abs=0.011)


_CONTROL_CHILD = """
import dataclasses
import sys
from umgen_tpu_torch.config import InferConfig
from umgen_tpu_torch.data.synthetic import write_control_scenes
from umgen_tpu_torch.layout import SequenceLayout
from umgen_tpu_torch.tools import evaluate
write_control_scenes(evaluate.CONTROL_ROOT,
                     SequenceLayout("pose_map_bbox3d_image"))
args = evaluate.build_parser().parse_args(
    ["--infer_task", "control", "--model_scale", "tiny", "--debug",
     "--device", "cpu", "--output_path", "out", "--save_video", "false"]
    + sys.argv[1:])
for_task = InferConfig.for_task                  # one generated frame
InferConfig.for_task = staticmethod(lambda *a, **k: dataclasses.replace(
    for_task(*a, **k), num_new_frames=1))
evaluate.run(args)
foreign = sorted(m for m in sys.modules
                 if m.split(".")[0] in %r)
assert not foreign, foreign[:5]
print("PORT_STANDS_ALONE_OK")
""" % (FOREIGN,)


def test_cli_control_task_stands_alone(tmp_path):
    """`--infer_task control` (the reference CLI's default decode, cut to
    one frame) from a working directory holding a control pkl under
    data/controlled_scenes, in a fresh interpreter: no JAX imported, the
    scene's token pickle written."""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = ROOT
    env["OMP_NUM_THREADS"] = "2"
    res = subprocess.run([sys.executable, "-c", _CONTROL_CHILD],
                         cwd=tmp_path, env=env, capture_output=True,
                         text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-3000:]
    assert "PORT_STANDS_ALONE_OK" in res.stdout
    assert "collision rate: per-frame" in res.stdout
    [name] = os.listdir(tmp_path / "out" / "saved_token")
    with open(tmp_path / "out" / "saved_token" / name, "rb") as f:
        out = pickle.load(f)
    assert out["pose"].shape == (1, 14, 3)


_TRAIN_CHILD = """
import sys
from umgen_tpu_torch.tools import train, train_vq
out = sys.argv[1]
if sys.argv[2] == "train":
    rc = train.main(["--device", "cpu", "--model_scale", "tiny", "--steps",
                     "1", "--synthetic_data", "1", "--batch_size", "1",
                     "--window", "3", "--ckpt_dir", out, "--data_root",
                     out + "/absent"])
else:
    rc = train_vq.main(["--device", "cpu", "--res", "32", "--ch", "32",
                        "--steps", "1", "--batch_size", "2", "--ckpt_dir",
                        out])
foreign = sorted(m for m in sys.modules
                 if m.split(".")[0] in %r)
assert rc == 0 and not foreign, (rc, foreign[:5])
print("PORT_STANDS_ALONE_OK")
""" % (FOREIGN,)


@pytest.mark.parametrize("tool", ["train", "train_vq"])
def test_training_clis_stand_alone(tmp_path, tool):
    """`tools.train` (one step at the tiny scale) and `tools.train_vq` (one
    step at --res 32 --ch 32) on the CPU, in a fresh interpreter: neither
    imports jax, optax, orbax or the JAX package; each saves its final
    state."""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["OMP_NUM_THREADS"] = "2"
    res = subprocess.run([sys.executable, "-c", _TRAIN_CHILD, str(tmp_path),
                          tool], cwd=ROOT, env=env, capture_output=True,
                         text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-3000:]
    assert "PORT_STANDS_ALONE_OK" in res.stdout
    assert os.path.exists(tmp_path / ("final" if tool == "train"
                                      else "map_final"))


def _jax_parser(main):
    """The argparse parser a JAX CLI builds inside its `main`: caught at
    its parse_args, before anything runs."""
    import argparse

    class Caught(Exception):
        pass

    def catch(parser, *a, **k):
        raise Caught(parser)

    orig = argparse.ArgumentParser.parse_args
    argparse.ArgumentParser.parse_args = catch
    try:
        main([])
    except Caught as e:
        return e.args[0]
    finally:
        argparse.ArgumentParser.parse_args = orig
    raise AssertionError("the JAX CLI parsed no arguments")


@pytest.mark.parametrize("tool", ["train", "train_vq"])
def test_training_cli_flags_equal_the_jax_clis(tool):
    """Drift guard: every flag of the JAX training CLIs is the port's, with
    the same default, type, choices and action; the port adds only
    `--device` (default cuda)."""
    import importlib
    jax_cli = importlib.import_module(f"umgen_tpu.tools.{tool}")
    port_cli = importlib.import_module(f"umgen_tpu_torch.tools.{tool}")

    def flags(parser):
        return {a.dest: (a.default, a.type, a.choices, type(a).__name__,
                         tuple(a.option_strings))
                for a in parser._actions if a.dest != "help"}

    want, got = flags(_jax_parser(jax_cli.main)), \
        flags(port_cli.build_parser())
    assert got.pop("device")[0] == "cuda"
    assert got == want


def _port_sources():
    yield os.path.join(ROOT, "chip_smoke.py")
    for base, _, files in os.walk(os.path.join(ROOT, "umgen_tpu_torch")):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(base, f)


def test_no_port_source_imports_jax_or_the_jax_package():
    """Every import statement of umgen_tpu_torch/**/*.py and chip_smoke.py,
    at any depth: none names `jax`, `jaxlib`, `umgen_tpu`, `optax` or
    `orbax`."""
    paths = list(_port_sources())
    assert len(paths) > 20
    bad = []
    for path in paths:
        with open(path) as f:
            tree = ast.parse(f.read(), path)
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""]
            else:
                continue
            bad += [(os.path.relpath(path, ROOT), node.lineno, n)
                    for n in names
                    if n.split(".")[0] in FOREIGN]
    assert not bad, bad


@pytest.mark.parametrize("what", ["ModelConfig", "larger", "tiny",
                                  "InferConfig", "DataConfig", "constants",
                                  "layout", "synthetic", "pipeline",
                                  "control_keys", "metrics", "visualize",
                                  "vq_configs"])
def test_copied_modules_equal_the_jax_packages(what):
    """Drift guard for the port's copies of config.py, layout.py, data/,
    tools/load_control_tokens.py, ops/metrics.py and tools/visualize.py,
    and for the VQ configs: the same fields and defaults, layout offsets,
    synthetic scenes, pipeline constants, control keys and their aliases,
    MMD attribute views, bandwidth and kernel defaults, the visualizer's
    constants and a rendered frame, VQConfig, MAP_VQ and IMAGE_VQ as the JAX
    package's."""
    from umgen_tpu import config as jc
    from umgen_tpu import layout as jl
    from umgen_tpu.data import pipeline as jp
    from umgen_tpu.data import synthetic as js
    from umgen_tpu_torch import config as tc
    from umgen_tpu_torch import layout as tl
    from umgen_tpu_torch.data import pipeline as tp
    from umgen_tpu_torch.data import synthetic as ts
    asdict = dataclasses.asdict
    if what == "ModelConfig":
        assert asdict(tc.ModelConfig()) == asdict(jc.ModelConfig())
        # either package's config builds the other's, field for field
        assert tc.ModelConfig(**asdict(jc.ModelConfig())) == tc.ModelConfig()
    elif what in ("larger", "tiny"):
        assert asdict(tc.ModelConfig().scaled(what)) == \
            asdict(jc.ModelConfig().scaled(what))
    elif what == "InferConfig":
        assert asdict(tc.InferConfig()) == asdict(jc.InferConfig())
        assert asdict(tc.InferConfig.for_task("video", 2, batch_size=10)) == \
            asdict(jc.InferConfig.for_task("video", 2, batch_size=10))
    elif what == "DataConfig":
        assert asdict(tc.DataConfig()) == asdict(jc.DataConfig())
    elif what == "constants":
        names = [n for n in dir(jc) if n.isupper()]
        assert len(names) > 10 and names == [n for n in dir(tc)
                                             if n.isupper()]
        for n in names:
            np.testing.assert_equal(getattr(tc, n), getattr(jc, n), n)
    elif what == "layout":
        a, b = tl.SequenceLayout("pose_map_bbox3d_image"), \
            jl.SequenceLayout("pose_map_bbox3d_image")
        assert (a.seq_len, a.input_len, a.mod_order) == \
            (b.seq_len, b.input_len, b.mod_order)
        assert [asdict(s) for s in a.segments] == \
            [asdict(s) for s in b.segments]
        assert a.slices() == b.slices() and tl.CONTENT_LEN == jl.CONTENT_LEN
    elif what == "synthetic":
        cfg = tc.ModelConfig().scaled("tiny")
        a = ts.make_token_batch(tl.SequenceLayout(cfg.task), T=3, B=2, seed=5,
                                config=cfg)
        b = js.make_token_batch(jl.SequenceLayout(cfg.task), T=3, B=2, seed=5,
                                config=jc.ModelConfig().scaled("tiny"))
        assert sorted(a) == sorted(b)
        for m in a:
            np.testing.assert_array_equal(a[m], b[m], m)
    elif what == "control_keys":
        from umgen_tpu.tools import load_control_tokens as jlct
        from umgen_tpu_torch.tools import load_control_tokens as tlct
        assert tlct.KEY_ALIASES == jlct.KEY_ALIASES
        assert asdict(tc.InferConfig.for_task("control", 2)) == \
            asdict(jc.InferConfig.for_task("control", 2))
        task = tc.ModelConfig().task
        np.testing.assert_equal(
            ts.make_control_scene(tl.SequenceLayout(task), seed=3),
            js.make_control_scene(jl.SequenceLayout(task), seed=3))
    elif what == "metrics":
        from umgen_tpu.ops import metrics as jm
        from umgen_tpu_torch.ops import metrics as tm
        assert tm.ATTRIBUTE_SLICES == jm.ATTRIBUTE_SLICES
        a, b = tm.MMDMetric(), jm.MMDMetric()
        assert (a.attributes, a.kernel_mul, a.kernel_num) == \
            (b.attributes, b.kernel_mul, b.kernel_num)
        rng = np.random.default_rng(0)
        x, y = rng.normal(size=(7, 3)), rng.normal(size=(5, 3))
        for mul, num in ((1.0, 1), (2.0, 5)):
            np.testing.assert_array_equal(
                tm.gaussian_kernel_sum(x, y, mul, num),
                jm.gaussian_kernel_sum(x, y, mul, num))
        boxes, cats = rng.normal(size=(4, 10)), np.arange(4)
        np.testing.assert_equal(tm.scene_attribute_views(boxes, cats),
                                jm.scene_attribute_views(boxes, cats))
    elif what == "visualize":
        from umgen_tpu.tools import visualize as jvz
        from umgen_tpu_torch.tools import visualize as tvz
        names = [n for n in dir(jvz) if n.isupper()]
        assert "WAYMO_POINT_COLORS" in names and \
            names == [n for n in dir(tvz) if n.isupper()]
        for n in names:
            assert getattr(tvz, n) == getattr(jvz, n), n
        rng = np.random.default_rng(0)
        boxes = np.zeros((8, 10), np.float32)
        boxes[:, 0:2] = rng.uniform(-30, 30, (8, 2))
        boxes[:, 3:5] = rng.uniform(0.5, 5, (8, 2))
        boxes[:, 6:9] = rng.uniform(-3, 3, (8, 3))
        cats, valid = rng.integers(0, 3, 8), rng.random(8) < 0.8
        maps = rng.uniform(-1, 1, (32, 32, 3))
        np.testing.assert_array_equal(
            tvz.render_frame(boxes, cats, valid, maps, collision_ids=[1]),
            jvz.render_frame(boxes, cats, valid, maps, collision_ids=[1]))
    elif what == "vq_configs":
        from umgen_tpu.models import vq as jvq
        from umgen_tpu_torch.models import vq as tvq
        for name in ("VQConfig", "MAP_VQ", "IMAGE_VQ"):
            got, want = getattr(tvq, name), getattr(jvq, name)
            if name == "VQConfig":
                got, want = got(), want()
            assert asdict(got) == asdict(want), name
            assert got.num_resolutions == want.num_resolutions
    else:
        a, b = tp.ScenePipeline().device_constants(), \
            jp.ScenePipeline().device_constants()
        assert sorted(a) == sorted(b)
        for k in a:
            np.testing.assert_array_equal(np.asarray(a[k]), np.asarray(b[k]),
                                          k)
