"""The port runs without JAX: importing it and running a tiny rollout
through its CLI, in a fresh interpreter, leaves `jax` out of sys.modules."""

import os
import pickle
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_CHILD = """
import sys
from umgen_tpu_torch.tools import evaluate
rc = evaluate.main(["--infer_task", "video", "--model_scale", "tiny",
                    "--fused_oar", "--kv_dtype", "bfloat16", "--debug",
                    "--synthetic_data", "1", "--max_scenes", "1",
                    "--set_num_new_frames", "1", "--sample_method",
                    "greedy", "--device", "cpu", "--output_path", sys.argv[1]])
jax_mods = sorted(m for m in sys.modules if m == "jax" or m.startswith("jax."))
assert rc == 0 and not jax_mods, (rc, jax_mods[:5])
print("PORT_WITHOUT_JAX_OK")
"""


def test_port_imports_and_runs_without_jax(tmp_path):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    # two intra-op threads: the suite runs several workers on the same
    # cores, and torch's default (one thread per core) oversubscribes them
    env["OMP_NUM_THREADS"] = "2"
    res = subprocess.run([sys.executable, "-c", _CHILD, str(tmp_path)],
                         cwd=ROOT, env=env, capture_output=True, text=True,
                         timeout=300)
    assert res.returncode == 0, res.stderr[-3000:]
    assert "PORT_WITHOUT_JAX_OK" in res.stdout
    [name] = os.listdir(tmp_path / "saved_token")
    with open(tmp_path / "saved_token" / name, "rb") as f:
        out = pickle.load(f)
    assert {m: v.shape for m, v in out.items()} == {
        "pose": (1, 21, 3), "map": (1, 21, 1024), "bbox3d": (1, 21, 660),
        "image": (1, 21, 512)}
