"""The readings that the limits of `correct` are set from, on the card:

    python3 benchmark/control.py --workload large-serving-b10 \\
        --seeds 11 12 13 --seconds 10 [--control 1]

runs the cell once a seed in this one process, as the benchmark's own runs
do, and prints one JSON line a seed with its compared numbers: with
`--control n` the configuration's n-th "control" (one, or a list) stands
in: the program on its own lower-precision path ("flags", e.g. int4 TAR
weights where the configuration states int8, fp8 rings where it states
bf16), or the reference computed in the precision below the stated one
("act", e.g. fp8 activations for bf16), judged against the float32
reference on the program's frames.  Each must come out not correct.  The
benchmark's own runs never run them.
"""

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--seconds", type=float, default=10)
    p.add_argument("--control", type=int, default=0)
    a = p.parse_args(argv)
    import torch

    from benchmark import harness
    if not torch.cuda.is_available():
        print("control: no CUDA device", file=sys.stderr)
        return 1
    manifest = harness.load_json(ROOT / "BENCHMARK.json")
    _, entry = harness.cell_of(manifest, a.workload)
    conf = harness.load_json(ROOT / entry["file"])
    controls = conf["control"]
    if isinstance(controls, dict):
        controls = [controls]
    if not 0 <= a.control <= len(controls):
        p.error(f"--control: 0 to {len(controls)} for {a.workload}")
    ctl = controls[a.control - 1] if a.control else {}
    flags, act = ctl.get("flags", []), ctl.get("act")
    for seed in a.seeds:
        t = time.perf_counter()
        out = harness.run_cell(a.workload, seed, a.seconds, False,
                               device="cuda:0", extra_flags=flags,
                               control_act=act,
                               log=lambda s: print(s, file=sys.stderr,
                                                   flush=True))
        print(json.dumps({"workload": a.workload, "seed": seed,
                          "control": ctl, "correct": out["correct"],
                          "frames": out["attempted"],
                          "run_s": time.perf_counter() - t,
                          "checks": {k: c["value"] for k, c in
                                     out["checks"].items()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
