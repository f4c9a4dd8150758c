"""Where one cached frame's time goes, on a CUDA card:

    python -m umgen_tpu_torch.tools.profile_frame --out chiprun_out/profile

Builds the served slice at UMGen_Large width (seeded random weights, int8
decode weights, bf16 rings, a 20-frame synthetic window), runs the prefill
frame, then for one cached frame times its three phases on the host clock
with a synchronize after each: the ego net (`ego_logits_cached`), the TAR
cascade (`tar_priors_cached`) and the OAR decode (`_finish_frame`).  Then
`torch.profiler` traces the TAR cascade once and 200 single-token OAR steps
at cache_len 1000-1199.  Per batch size B it writes the profiler tables
(`tar_B{B}.txt`, `oar_B{B}.txt`, sorted by device time) and, for all,
`summary.json`, whose device milliseconds are the traced kernels' self time.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time
from typing import Optional


def _synced(fn):
    import torch
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def _device_ms(prof) -> float:
    """The traced kernels' self time (the table's "Self CUDA time total"):
    operator rows repeat their kernels' time, so only device rows count."""
    from torch.autograd import DeviceType
    return sum(e.self_device_time_total for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA) / 1e3


def profile_batch(model, ro, params, B: int, generator, out_dir: str,
                  steps: int = 200) -> dict:
    import torch
    from torch.profiler import ProfilerActivity, profile

    from umgen_tpu.data.synthetic import make_token_batch
    cfg, lo = model.config, model.layout
    dev = params["axe"].device
    cond = make_token_batch(lo, T=cfg.tar_cache_window, B=B, seed=0,
                            config=cfg)
    inputs = {m: torch.as_tensor(v, dtype=torch.long, device=dev)
              for m, v in cond.items()}
    res = {}
    (out, cache), res["prefill_frame_s"] = _synced(
        lambda: ro.frame_step_prefill(params, inputs, generator))
    sl = lo.slices()
    frame = {m: out.tokens[:, sl[m]][:, None] for m in lo.mod_order}
    abs_frame = cache["frames"]
    (ego, cache), res["ego_s"] = _synced(
        lambda: model.ego_logits_cached(params, frame, cache, abs_frame))
    pose = ego.argmax(-1)
    shifted = dict(frame, pose=pose[:, None])
    # the TAR cascade rewrites the newest ring slot in place: running it
    # twice (timed, then traced) does the same work twice
    pri, res["tar_s"] = _synced(
        lambda: model.tar_priors_cached(params, shifted, cache, abs_frame))
    no_control = torch.zeros(B, 61, dtype=torch.bool, device=dev)
    _, res["oar_s"] = _synced(lambda: ro._finish_frame(
        params, pri["prior_seq"], pose, frame["bbox3d"][:, 0], no_control,
        generator))

    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    with profile(activities=acts) as prof:
        _synced(lambda: model.tar_priors_cached(params, shifted, cache,
                                                abs_frame))
    res["tar_device_ms"] = _device_ms(prof)
    with open(os.path.join(out_dir, f"tar_B{B}.txt"), "w") as f:
        f.write(prof.key_averages().table(sort_by="cuda_time_total",
                                          row_limit=25))

    kv_k, kv_v = ro.init_kv(B, device=dev)
    x = pri["prior_seq"][:, 1100:1101]
    with profile(activities=acts) as prof:
        _, res[f"oar_{steps}_steps_s"] = _synced(lambda: [
            ro.oar_step(params, x, kv_k, kv_v, cache_len=1000 + i)
            for i in range(steps)])
    res[f"oar_{steps}_steps_device_ms"] = _device_ms(prof)
    with open(os.path.join(out_dir, f"oar_B{B}.txt"), "w") as f:
        f.write(prof.key_averages().table(sort_by="cuda_time_total",
                                          row_limit=25))
    return res


def main(argv: Optional[list] = None) -> int:
    import torch

    from umgen_tpu_torch.models.rollout import Rollout
    from umgen_tpu_torch.models.umgen import UMGen
    from umgen_tpu_torch.params import init_params
    from umgen_tpu_torch.runtime.quantize import (pack_fused,
                                                  quantize_params_int8)
    from umgen_tpu_torch.tools import evaluate

    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--out", default="chiprun_out/profile")
    p.add_argument("--batch_sizes", type=int, nargs="+", default=[1, 2])
    p.add_argument("--model_scale", default="larger")
    a = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("profile_frame: no CUDA device", file=sys.stderr)
        return 1
    args = evaluate.build_parser().parse_args([
        "--fused_oar", "--kv_dtype", "bfloat16", "--debug",
        "--model_scale", a.model_scale, "--sample_method", "topk",
        "--tar_cache_window", "20"])
    evaluate.check_args(args)
    cfg = evaluate.config_from_args(args)
    dev = torch.device("cuda", 0)
    g = torch.Generator(device=dev)
    g.manual_seed(0)
    model = UMGen(cfg)
    ro = Rollout(model)
    params = pack_fused(quantize_params_int8(init_params(cfg, g, dev)))
    os.makedirs(a.out, exist_ok=True)
    summary = {"nvidia_smi": subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip(), "model_scale": a.model_scale}
    for B in a.batch_sizes:
        summary[f"B{B}"] = profile_batch(model, ro, params, B, g, a.out)
        print(f"B={B}: {summary[f'B{B}']}", flush=True)
        torch.cuda.empty_cache()
    with open(os.path.join(a.out, "summary.json"), "w") as f:
        json.dump(summary, f, indent=1)
    print(json.dumps(summary))
    return 0


if __name__ == "__main__":
    sys.exit(main())
