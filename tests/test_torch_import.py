"""The port stands alone: it runs without JAX and without the JAX package.

Importing it and running a tiny rollout through its CLI (the reference
CLI's default run, and the decode kernels' paths), in a fresh interpreter, leaves `jax` and `umgen_tpu` out of sys.modules; no source file
of the port (or chip_smoke.py) imports either; and the framework-free
modules the port copied from the JAX package (config, layout, data) still
say what their originals say.
"""

import ast
import dataclasses
import os
import pickle
import subprocess
import sys

import numpy as np
import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_CHILD = """
import sys
from umgen_tpu_torch.tools import evaluate
rc = evaluate.main(["--model_scale", "tiny", "--debug", "--synthetic_data",
                    "1", "--max_scenes", "1", "--set_num_new_frames", "1",
                    "--device", "cpu", "--output_path", sys.argv[1]]
                   + sys.argv[2:])
foreign = sorted(m for m in sys.modules
                 if m.split(".")[0] in ("jax", "jaxlib", "umgen_tpu"))
assert rc == 0 and not foreign, (rc, foreign[:5])
print("PORT_STANDS_ALONE_OK")
"""


# the bf16-ring slice: the decode kernels' plain versions, greedy
FUSED = ("--infer_task", "video", "--fused_oar", "--kv_dtype", "bfloat16",
         "--sample_method", "greedy")


def _run_cli(tmp_path, *flags):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    # two intra-op threads: the suite runs several workers on the same
    # cores, and torch's default (one thread per core) oversubscribes them
    env["OMP_NUM_THREADS"] = "2"
    res = subprocess.run([sys.executable, "-c", _CHILD, str(tmp_path), *flags],
                         cwd=ROOT, env=env, capture_output=True, text=True,
                         timeout=300)
    assert res.returncode == 0, res.stderr[-3000:]
    assert "PORT_STANDS_ALONE_OK" in res.stdout
    [name] = os.listdir(tmp_path / "saved_token")
    with open(tmp_path / "saved_token" / name, "rb") as f:
        out = pickle.load(f)
    assert {m: v.shape for m, v in out.items()} == {
        "pose": (1, 21, 3), "map": (1, 21, 1024), "bbox3d": (1, 21, 660),
        "image": (1, 21, 512)}


def test_port_imports_and_runs_without_jax(tmp_path):
    _run_cli(tmp_path, *FUSED)


def test_cli_default_run_stands_alone(tmp_path):
    """The reference CLI's default run (fp8 rings, the unfused decode on an
    fp8 OAR cache, int8 decode weights, top-k) at the tiny scale: no JAX
    imported, token pickles of the right shapes."""
    _run_cli(tmp_path)


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
     "--device", "cpu", "--output_path", "out"] + sys.argv[1:])
for_task = InferConfig.for_task                  # one generated frame
InferConfig.for_task = staticmethod(lambda *a, **k: dataclasses.replace(
    for_task(*a, **k), num_new_frames=1))
evaluate.run(args)
foreign = sorted(m for m in sys.modules
                 if m.split(".")[0] in ("jax", "jaxlib", "umgen_tpu"))
assert not foreign, foreign[:5]
print("PORT_STANDS_ALONE_OK")
"""


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


def _port_sources():
    yield os.path.join(ROOT, "chip_smoke.py")
    for base, _, files in os.walk(os.path.join(ROOT, "umgen_tpu_torch")):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(base, f)


def test_no_port_source_imports_jax_or_the_jax_package():
    """Every import statement of umgen_tpu_torch/**/*.py and chip_smoke.py,
    at any depth: none names `jax`, `jaxlib` or `umgen_tpu`."""
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
                    if n.split(".")[0] in ("jax", "jaxlib", "umgen_tpu")]
    assert not bad, bad


@pytest.mark.parametrize("what", ["ModelConfig", "larger", "tiny",
                                  "InferConfig", "DataConfig", "constants",
                                  "layout", "synthetic", "pipeline",
                                  "control_keys", "metrics"])
def test_copied_modules_equal_the_jax_packages(what):
    """Drift guard for the port's copies of config.py, layout.py, data/,
    tools/load_control_tokens.py and ops/metrics.py: the same fields and
    defaults, layout offsets, synthetic scenes, pipeline constants, control
    keys and their aliases, MMD attribute views, bandwidth and kernel
    defaults as the JAX package's (none of these imports jax)."""
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
    else:
        a, b = tp.ScenePipeline().device_constants(), \
            jp.ScenePipeline().device_constants()
        assert sorted(a) == sorted(b)
        for k in a:
            np.testing.assert_array_equal(np.asarray(a[k]), np.asarray(b[k]),
                                          k)
