"""CLI entry point of the port — the JAX CLI's flag names
(umgen_tpu/tools/evaluate.py), serving the cached video rollout:

    python -m umgen_tpu_torch.tools.evaluate --infer_task video \\
        --model_scale larger --fused_oar --kv_dtype bfloat16 --int8 decode \\
        --debug --synthetic_data 1 --max_scenes 1 --set_num_new_frames 2

Weights are seeded random (`--debug`, or a missing checkpoint); scenes come
from the dataset or, with `--synthetic_data N`, from the synthetic
generator.  Every flag value outside what the port serves raises
NotPortedError naming the ROADMAP.md item that adds it; none is silently
ignored.
"""

from __future__ import annotations

import argparse
import os
import sys
from typing import Optional

from umgen_tpu_torch.models.umgen import NotPortedError

NOT_PORTED_OUTPUTS = ("videos, MMD and the collision-rate metric are not "
                      "ported yet (ROADMAP.md: 'VQ detokenizers, videos and "
                      "metrics'); writing token pickles only")


def _flag(v: str) -> bool:
    return v not in ("0", "false", "False")


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="UMGen_Evaluation (PyTorch)")
    p.add_argument("--pred_task", type=str, default="pose_map_bbox3d_image")
    p.add_argument("--ckpt_dir", type=str,
                   default="data/weights/UMGen_Large.pt")
    p.add_argument("--model_scale", type=str, default="larger",
                   help="stander | larger | debug | tiny")
    p.add_argument("--infer_task", type=str, default="video")
    p.add_argument("--rule_constrain", type=_flag, default=True)
    p.add_argument("--set_num_new_frames", type=int, default=30)
    p.add_argument("--spe_text", type=str, default="UMGen_Evaluating")
    p.add_argument("--force_vis", type=bool, default=True)
    p.add_argument("--put_text", type=bool, default=True)
    p.add_argument("--save_video", type=_flag, default=True)
    p.add_argument("--debug", action="store_true",
                   help="random weights (no checkpoint)")
    p.add_argument("--output_path", default="output/UMGen/")
    p.add_argument("--map_decoder_weights_path",
                   default="data/weights/map_vae.ckpt")
    p.add_argument("--image_decoder_weights_path",
                   default="data/weights/image_vae.tar")
    p.add_argument("--launcher", type=str, choices=["torch", "mpi"],
                   default=None)
    p.add_argument("--data_root", type=str,
                   default="data/tokenized_origin_scenes")
    p.add_argument("--synthetic_data", type=int, default=0)
    p.add_argument("--batch_size", type=int, default=1)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--max_scenes", type=int, default=-1)
    p.add_argument("--sample_method", type=str, default="topk")
    p.add_argument("--profile_dir", type=str, default=None)
    p.add_argument("--init_token_mod", type=str, default="")
    p.add_argument("--no_gt_video", action="store_true")
    p.add_argument("--tar_mode", type=str, default=None,
                   choices=["temporal_cache", "recompute"])
    p.add_argument("--kv_dtype", type=str, default="float8_e4m3fn")
    p.add_argument("--int8", type=str, default="decode",
                   choices=["off", "decode", "all"])
    p.add_argument("--speculative_k", type=int, default=0)
    p.add_argument("--no_spec_bbox", action="store_true")
    p.add_argument("--tar_cache_window", type=int, default=None)
    p.add_argument("--tar_cache_refresh", type=int, default=0)
    p.add_argument("--chunked_prefill", action="store_true")
    p.add_argument("--fused_oar", action="store_true")
    p.add_argument("--oar_kv_dtype", type=str, default=None)
    p.add_argument("--oar_kernel", type=int, default=5, choices=(5, 7))
    p.add_argument("--oar_batch_block", type=int, default=0)
    p.add_argument("--tar_w4", action="store_true")
    p.add_argument("--temporal_pe", type=str, default="absolute",
                   choices=["absolute", "relative"])
    p.add_argument("--tpe_clamp", type=int, default=None)
    p.add_argument("--dp", type=int, default=1)
    # port-only
    p.add_argument("--device", type=str, default=None,
                   help="torch device (default: cuda when available)")
    return p


def check_args(args) -> None:
    """Raise NotPortedError for any flag value outside the served slice."""
    def no(cond, what, item):
        if cond:
            raise NotPortedError(f"{what} is not ported yet "
                                 f"(ROADMAP.md: {item!r})")

    no(args.infer_task != "video", f"--infer_task {args.infer_task}",
       "Control mode")
    no(args.tar_mode == "recompute", "--tar_mode recompute",
       "Recompute mode")
    no(args.kv_dtype != "bfloat16", f"--kv_dtype {args.kv_dtype}",
       "fp8 / int4 / int2 TAR rings")
    no(args.speculative_k > 0 or args.no_spec_bbox,
       "speculative decoding", "Speculative decoding")
    no(args.dp > 1 or args.launcher is not None, "multi-GPU serving",
       "Multi-GPU and runtime")
    no(args.tar_w4, "--tar_w4", "W4 weights")
    no(args.chunked_prefill or args.tar_cache_refresh > 0,
       "chunked prefill / ring refresh", "Chunked prefill and ring refresh")
    no(args.temporal_pe != "absolute", "--temporal_pe relative",
       "Relative temporal PE")
    no(not args.fused_oar, "the unfused OAR decode (omit --fused_oar)",
       "Unfused and bf16 OAR caches")
    no(args.int8 != "decode", f"--int8 {args.int8}",
       "int8 everywhere / bf16 OAR weights")
    no(args.oar_kv_dtype not in (None, "int8"),
       f"--oar_kv_dtype {args.oar_kv_dtype}", "int4 OAR KV cache")
    no(args.oar_kernel != 5 or args.oar_batch_block,
       "--oar_kernel 7 / --oar_batch_block", "Superseded decode variants")
    no(args.batch_size > 2, f"--batch_size {args.batch_size}",
       "Larger scene batches")
    no(args.profile_dir is not None, "--profile_dir",
       "Multi-GPU and runtime")
    no(bool(args.init_token_mod), "--init_token_mod",
       "VQ detokenizers, videos and metrics")
    if args.sample_method not in ("greedy", "topk", "topp"):
        raise ValueError(f"unknown sample method {args.sample_method!r}")
    no(not args.debug and os.path.exists(args.ckpt_dir),
       "loading a checkpoint", "Multi-GPU and runtime")


def config_from_args(args):
    from umgen_tpu.config import ModelConfig
    return ModelConfig(task=args.pred_task,
                       rule_constrain=args.rule_constrain,
                       sample_method=args.sample_method,
                       tar_mode="temporal_cache",
                       tar_cache_dtype=args.kv_dtype,
                       oar_cache_dtype="int8",
                       fused_oar_kernel=True,
                       tar_cache_window=args.tar_cache_window,
                       tpe_clamp=args.tpe_clamp).scaled(args.model_scale)


def run(args):
    """Run the evaluation; returns the SceneRunner (timings) and the
    Generator."""
    import torch

    from umgen_tpu.config import DataConfig, InferConfig
    from umgen_tpu.data.dataset import NuPlanTokenDataset
    from umgen_tpu.data.pipeline import ScenePipeline
    from umgen_tpu_torch.models.generate import Generator
    from umgen_tpu_torch.models.umgen import UMGen, build_buffers
    from umgen_tpu_torch.params import init_params
    from umgen_tpu_torch.runtime.quantize import (pack_fused,
                                                  quantize_params_int8)
    from umgen_tpu_torch.tools.harness import SceneRunner

    check_args(args)
    cfg = config_from_args(args)
    device = torch.device(args.device or
                          ("cuda" if torch.cuda.is_available() else "cpu"))
    infer_cfg = InferConfig.for_task(args.infer_task,
                                     args.set_num_new_frames,
                                     batch_size=args.batch_size,
                                     seed=args.seed)
    pipeline = ScenePipeline()
    model = UMGen(cfg)
    if not args.debug:
        print(f"checkpoint {args.ckpt_dir} not found — using random "
              "weights (debug mode)")
    g = torch.Generator(device=device)
    g.manual_seed(args.seed)
    params = init_params(cfg, g, device,
                         buffers=build_buffers(cfg, pipeline, device=device))
    params = pack_fused(quantize_params_int8(params))
    print(NOT_PORTED_OUTPUTS)

    data_root = args.data_root
    if not os.path.isdir(data_root) and args.synthetic_data > 0:
        from umgen_tpu.data.synthetic import write_synthetic_dataset
        data_root = os.path.join(args.output_path, "synthetic_scenes")
        write_synthetic_dataset(data_root, n_scenes=args.synthetic_data,
                                seed=args.seed)
        print("generated synthetic dataset at", data_root)
    dcfg = DataConfig(data_root=(data_root,),
                      block_size=infer_cfg.num_new_frames
                      + infer_cfg.cond_frames)
    dataset = NuPlanTokenDataset(dcfg, pipeline)
    if len(dataset) == 0:
        raise SystemExit(f"no scenes found under {data_root}; use "
                         "--synthetic_data N")

    gen = Generator(model, params, seed=args.seed, device=device)
    runner = SceneRunner(gen, infer_cfg, output_path=args.output_path)
    n = len(dataset) if args.max_scenes < 0 else min(args.max_scenes,
                                                     len(dataset))
    group = []
    for i in range(n):
        batch = dataset[i]
        if batch is None:
            continue
        group.append(batch)
        if len(group) >= max(args.batch_size, 1):
            runner.run_scenes(group)
            group = []
    if group:
        runner.run_scenes(group)
    if runner.timings:
        fps = sum(t["frames_per_sec"] for t in runner.timings) \
            / len(runner.timings)
        print(f"mean throughput: {fps:.4f} frames/sec on {device}")
    return runner, gen


def main(argv: Optional[list] = None) -> int:
    run(build_parser().parse_args(argv))
    print("Sucess")   # the reference's success marker
    return 0


if __name__ == "__main__":
    sys.exit(main())
