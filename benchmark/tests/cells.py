"""Tiny twins of the benchmark's configurations, written only as data
files into a temporary checkout root, for the CPU tests."""

from __future__ import annotations

import json
import os
from pathlib import Path

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent
TINY = dict(n_embd=64, n_head=4, n_tar_layer=1, n_oar_layer=1,
            n_ego_tar_layer=1, n_ego_ca_layer=1, n_map_tar_layer=1,
            n_box_tar_layer=1)
# limits of the tiny twins, from their CPU readings (sound seeds: prior
# 0.013, ego 0.006, gap 0.011 cached / 0.006, 0.006, 0.004 recompute; the
# W4 TAR control: 0.17, 0.12, 0.15 / 0.14, 0.16, 0.11)
TINY_LIMITS = {"prior_err": 0.05, "ego_err": 0.04, "token_gap": 0.05,
               "rule_mismatch": 0, "stored_mismatch": 0}


def write_root(tmp: Path) -> Path:
    """A checkout root holding BENCHMARK.json with three tiny cells (cached
    serving-style, recompute, and cached after a full-window prefill),
    their configuration and traffic files, and the benchmark's metric
    readers."""
    (tmp / "benchmark" / "configs").mkdir(parents=True)
    (tmp / "benchmark" / "traffic").mkdir(parents=True)
    os.symlink(BENCH / "metrics", tmp / "benchmark" / "metrics")
    manifest = json.loads((ROOT / "BENCHMARK.json").read_text())
    cells = [("tiny-cached", "umgen_large_serving", "tiny_cached",
              {"scenes": 2, "history_frames": 3, "warm_frames": 1,
               "check_scenes": 2},
              ["--tar_cache_window", "3"], {"tar_cache_window": 3}, 3),
             ("tiny-recompute", "umgen_stander_int8", "tiny_recompute",
              {"scenes": 1, "history_frames": 20, "warm_frames": 1,
               "check_scenes": 1}, [], {}, 20),
             ("tiny-prefill", "umgen_stander_cached", "tiny_prefill",
              {"scenes": 1, "history_frames": 3, "warm_frames": 2,
               "check_scenes": 1},
              ["--tar_cache_window", "3"], {"tar_cache_window": 3}, 3)]
    manifest["configs"], manifest["workloads"] = [], []
    for cell, base, name, mix, flags, extra, window in cells:
        conf = json.loads((BENCH / "configs" / f"{base}.json").read_text())
        conf["model"].update(TINY, **extra)
        f = conf["flags"]
        f[f.index("--model_scale") + 1] = "tiny"
        if "--tar_cache_window" in f:
            i = f.index("--tar_cache_window")
            del f[i:i + 2]
        conf["flags"] = f + flags
        # W4A8 packing needs d % 256 == 0: the tiny twin runs the CLI's
        # int8 path, and the reference the int8 weights only
        conf["program_weights"] = "cli"
        conf["reference_weights"] = conf["reference_weights"][:1]
        conf["window"]["window"] = window
        conf["limits"] = {k: TINY_LIMITS.get(k, v)
                          for k, v in conf["limits"].items()}
        (tmp / "benchmark" / "configs" / f"{name}.json").write_text(
            json.dumps(conf))
        (tmp / "benchmark" / "traffic" / f"{name}.json").write_text(
            json.dumps(mix))
        manifest["configs"].append(
            {"name": name, "source": conf["source"], "reduced": [],
             "file": f"benchmark/configs/{name}.json", "why": "tiny twin"})
        manifest["workloads"].append(
            {"name": cell, "config": name, "traffic": name, "chips": 1,
             "why": "tiny twin"})
    (tmp / "BENCHMARK.json").write_text(json.dumps(manifest))
    return tmp
