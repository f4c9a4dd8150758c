"""Run one cell of the benchmark of umgen_tpu_torch once:

    python3 benchmark/run.py --workload large-serving-b10 --seed 7 \\
        --seconds 10 --trace 0

from the root of a checkout, on a machine with a CUDA card.  The cells,
their configurations, traffic mixes and metrics are in BENCHMARK.json.
The last line of standard output is the run's result, one JSON object;
the compared numbers, each beside its limit, are the last lines of
standard error.  A run that finds no card, fewer cards than the cell asks
for, or JAX loaded once the window has closed, prints no result and exits
with 1.
"""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
# the build and kernel caches at fixed paths inside the checkout
for var, sub in (("TRITON_CACHE_DIR", "triton"),
                 ("TORCH_EXTENSIONS_DIR", "torch_extensions")):
    os.environ[var] = str(ROOT / "benchmark" / ".cache" / sub)
os.environ["USE_FLAX"] = "0"
sys.path.insert(0, str(ROOT))

FORBIDDEN = ("jax", "jaxlib", "flax", "umgen_tpu")


def jax_loaded():
    """Modules of JAX or the JAX package in this process, by top-level
    name compared whole."""
    return sorted({m for m in sys.modules
                   if m.split(".")[0] in FORBIDDEN})


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    a = p.parse_args(argv)

    import torch

    from benchmark import harness
    manifest = harness.load_json(ROOT / "BENCHMARK.json")
    cell, _ = harness.cell_of(manifest, a.workload)
    if not torch.cuda.is_available():
        print("benchmark: no CUDA device", file=sys.stderr)
        return 1
    if torch.cuda.device_count() < cell["chips"]:
        print(f"benchmark: {a.workload} needs {cell['chips']} devices, "
              f"{torch.cuda.device_count()} found", file=sys.stderr)
        return 1
    out = harness.run_cell(a.workload, a.seed, a.seconds, bool(a.trace),
                           device="cuda:0", t_start=T0,
                           log=lambda s: print(s, file=sys.stderr,
                                               flush=True))
    found = jax_loaded()
    if found:
        print(f"benchmark: JAX or the JAX package loaded: {found}",
              file=sys.stderr)
        return 1
    for name, c in out["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
