"""CLI entry point of the port — the JAX CLI's flag names
(umgen_tpu/tools/evaluate.py) and its two tasks.  Its default run is the JAX
CLI's:

    python -m umgen_tpu_torch.tools.evaluate --debug --synthetic_data 1 \\
        --max_scenes 1 --set_num_new_frames 2

— UMGen_Large, fp8 TAR rings, an fp8 OAR cache decoded by the reference's
unfused body (no `--fused_oar`), int8 decode weights.  Tasks: `--infer_task
video` (the scenes of `--data_root`) and `--infer_task control` (the control
pkls of `data/controlled_scenes`, relative to the working directory as in
the JAX CLI: each replays its ego trajectory and overwrites its controlled
agents, one scene at a time, 30 frames); `--init_token_mod map,image` forces
those modalities to the GT continuation.  Weights: the reference checkpoint
`--ckpt_dir` (runtime.torch_import, with the VQ codebooks of
projects/tokenizer/weights/ where present), or seeded random ones under
`--debug` or when it is missing.  Served values: `--tar_mode
temporal_cache|recompute` (recompute: the whole window through every TAR
stack each frame), `--kv_dtype float8_e4m3fn|bfloat16|float32|int4|int2`
(TAR rings; without `--fused_oar` the OAR cache takes the same type unless
it is int4 or int2, with it int8 unless asked otherwise), `--temporal_pe
relative` (a per-head temporal-attention bias by frame distance in place of
the absolute temporal PE), `--tar_w4` (group-128 int4 TAR-family weights),
`--speculative_k K` (TAR-head drafts verified K at a time, on the
multi-query decode kernels under `--fused_oar`; `--no_spec_bbox` keeps the
bbox segment sequential), `--tar_cache_refresh N`, `--fused_oar`
(the decode kernels), `--oar_kv_dtype int8|int4|bfloat16|float8_e4m3fn`
(int4: the nibble-packed OAR cache with per-(row, head) scales, decoded by
the v5i4 / v5mqi4 kernels; bfloat16 / float8_e4m3fn: the dense cache, its
single-token steps decoded by v2 and its multi-row pushes by the eager
body), `--oar_kernel 5|7` (7: the per-(scene, head) query scale of v7 while
batch · heads <= 128), `--int8 off|decode|all`, `--chunked_prefill`,
`--tar_cache_window N`, any `--batch_size`.  Like the JAX CLI it quantizes
unless `--int8 off` and packs the int8 OAR weights for the cache type under
`--fused_oar` (`pack_fused(params, kv_dtype)`), whichever the weights'
source; W4A8 weights are reached as the JAX bench reaches them, through
`serving_params` and the same Generator (chip_smoke.py phases e and g).
It prints the lines the JAX CLI prints (speculative decoding's drafts
accepted a chunk, the collision rate, MMD against the GT continuation),
writes the token pickles and, under `--save_video` (on by default, as in
the JAX CLI), one mp4 a scene under `video/`: the map and image VQ decoders
(models.vq, on the run's device; each from `--map_decoder_weights_path` /
`--image_decoder_weights_path` where that file exists, seeded at random
otherwise) decode every frame, and the video is the prediction | GT panel
unless `--no_gt_video`.  Unlike the JAX CLI, the port builds and runs the
decoders only under `--save_video`: the JAX CLI decodes the pictures under
`--save_video false` too and drops them, and its outputs (token pickles,
metrics) are the same either way.  Where cv2 does not import, `--save_video`
stops the run before the rollout (the JAX CLI fails after it, at the first
rendered frame).

Data parallelism over scenes (parallel/mesh.py; the JAX CLI's `--dp` and
`--launcher`): `--dp N` alone starts N ranks on this host, one a card
(cuda:0 ... N-1, NCCL; under `--device cpu` N ranks on the CPU over gloo),
and refuses where there are fewer cards ("need N devices, have M");
`--launcher torch` makes the process one rank of `torchrun`'s world and
`--launcher mpi` one of Open MPI's, and `--dp` must then equal the world
size.  Every rank builds the same seeded weights, rolls its contiguous
shard of each `--batch_size` batch (a multiple of `--dp`; a last, short
batch is padded by repeating its last scene, and the pads dropped), and
rank 0 gathers the tokens, writes the pickles, metrics and videos, and
prints the lines the one-process run prints, over all the scenes.  `--dp`
serves the video task's temporal-cache rollout through the dp-only
`spmd="shard_map"` program, as the JAX CLI's does (it has no `--tp`):
control and recompute under `--dp` are refused with JAX's reasons.
`--profile_dir DIR` traces the scene loop with `torch.profiler` (CPU, and
the card's kernels on a card) into a Chrome / TensorBoard trace under DIR
that holds the program's `umgen.` spans, with the decode steps of each
frame step by OAR kernel beside it, one file each a rank
(runtime/profiler.py).  `--oar_batch_block` (a VMEM blocking) is refused
by decision.
"""

from __future__ import annotations

import argparse
import os
import sys
from typing import Optional

from umgen_tpu_torch.models.umgen import RING_DTYPES, NotPortedError

# where the JAX CLI looks for the VQ codebooks (umgen_tpu/tools/
# evaluate.py:223-229)
MAP_CODEBOOK = "projects/tokenizer/weights/map_codebook.pth"
IMG_CODEBOOK = "projects/tokenizer/weights/img_codebook.pth"
# the control pkls, relative to the working directory (JAX :266-267)
CONTROL_ROOT = "data/controlled_scenes"


OAR_KV_DTYPES = ("int8", "int4", "bfloat16", "float8_e4m3fn")


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
    p.add_argument("--device", type=str, default="cuda",
                   help="torch device; the CPU only when asked (cpu)")
    return p


def check_args(args) -> None:
    """Refuse a flag value outside what the port serves, each with its
    reason: NotPortedError (naming the ROADMAP.md item or decision),
    ValueError or the JAX CLI's SystemExit."""
    if args.infer_task not in ("video", "control"):
        raise ValueError(f"unknown --infer_task {args.infer_task!r}: video "
                         "or control")
    if args.dp < 1:
        raise ValueError(f"--dp {args.dp}: at least 1")
    if args.dp > 1 and args.infer_task == "control":
        raise SystemExit("--dp > 1 batches video scenes; control mode runs "
                         "per-scene (per-scene init dicts)")
    if args.dp > 1 and args.batch_size % args.dp:
        raise SystemExit(f"--batch_size {args.batch_size} must be a "
                         f"multiple of --dp {args.dp}")
    if (args.dp > 1 or args.launcher is not None) \
            and (args.tar_mode or "temporal_cache") != "temporal_cache":
        raise ValueError("--dp: spmd='shard_map' requires "
                         "tar_mode='temporal_cache' (the JAX CLI's "
                         "data-parallel program serves the cached rollout "
                         "only)")
    if args.kv_dtype not in RING_DTYPES:
        raise ValueError(f"unknown --kv_dtype {args.kv_dtype!r}: "
                         f"{', '.join(RING_DTYPES)}")
    if args.oar_kv_dtype not in (None,) + OAR_KV_DTYPES:
        raise NotPortedError(
            f"--oar_kv_dtype {args.oar_kv_dtype}: served are "
            f"{', '.join(OAR_KV_DTYPES)}.  The reference's fused v2 kernel "
            "reads every other type as if it were fp8 (ROADMAP.md, Queue "
            "3); the port does not copy that")
    if args.oar_batch_block:
        raise NotPortedError(
            "--oar_batch_block splits the batch to fit the TPU's VMEM; the "
            "port runs the whole batch in one kernel and does not port it "
            "(ROADMAP.md: 'VMEM-driven blockings')")
    if args.sample_method not in ("greedy", "topk", "topp"):
        raise ValueError(f"unknown sample method {args.sample_method!r}")


def config_from_args(args):
    """argparse namespace → scaled ModelConfig, field for field as the JAX
    CLI's (umgen_tpu/tools/evaluate.py:146-187): `--kv_dtype int4` sets the
    TAR rings and keeps the OAR cache int8 unless `--oar_kv_dtype int4`
    opts it in too."""
    from umgen_tpu_torch.config import ModelConfig
    return ModelConfig(task=args.pred_task,
                       rule_constrain=args.rule_constrain,
                       sample_method=args.sample_method,
                       tar_mode=args.tar_mode or "temporal_cache",
                       tar_cache_dtype=args.kv_dtype,
                       oar_cache_dtype=(args.oar_kv_dtype or
                                        ("int8" if args.fused_oar
                                         or args.kv_dtype in ("int4", "int2")
                                         else args.kv_dtype)),
                       speculative_k=args.speculative_k,
                       speculative_bbox=not args.no_spec_bbox,
                       fused_oar_kernel=args.fused_oar,
                       oar_kernel_version=args.oar_kernel,
                       oar_batch_block=args.oar_batch_block,
                       chunked_prefill=args.chunked_prefill,
                       tar_cache_window=args.tar_cache_window,
                       tar_cache_refresh=args.tar_cache_refresh,
                       temporal_pe_mode=args.temporal_pe,
                       tpe_clamp=args.tpe_clamp).scaled(args.model_scale)


def build_params(args, cfg, device, pipeline):
    """The CLI's weights on `device`, as the JAX CLI builds them
    (umgen_tpu/tools/evaluate.py:214-242): the reference checkpoint
    `--ckpt_dir`, or seeded random weights under `--debug` or when it is
    missing; then `prepare_params`."""
    import torch

    from umgen_tpu_torch.models.umgen import build_buffers
    from umgen_tpu_torch.params import init_params
    if args.debug or not os.path.exists(args.ckpt_dir):
        if not args.debug:
            print(f"checkpoint {args.ckpt_dir} not found — using random "
                  "weights (debug mode)")
        g = torch.Generator(device=device)
        g.manual_seed(args.seed)
        params = init_params(cfg, g, device,
                             buffers=build_buffers(cfg, pipeline,
                                                   device=device))
    else:
        from umgen_tpu_torch.runtime.torch_import import load_umgen_checkpoint
        print("loading model from", args.ckpt_dir)
        params = load_umgen_checkpoint(
            args.ckpt_dir, cfg, pipeline=pipeline,
            map_codebook_path=_maybe(MAP_CODEBOOK),
            img_codebook_path=_maybe(IMG_CODEBOOK), device=device)
    return prepare_params(args, cfg, params)


def _maybe(path: str) -> Optional[str]:
    return path if os.path.exists(path) else None


def prepare_params(args, cfg, params):
    """Unless `--int8 off`, int8 over `DECODE_KEYS` (`--int8 decode`) or
    `ALL_STACK_KEYS` (`--int8 all`), then under `--fused_oar` the decode
    kernels' packing for the OAR cache's type; then under `--tar_w4` group
    int4 on `TAR_STACK_KEYS` — whichever the weights' source, in the JAX
    CLI's order (umgen_tpu/tools/evaluate.py:230-242)."""
    from umgen_tpu_torch.runtime.quantize import (ALL_STACK_KEYS, DECODE_KEYS,
                                                  pack_fused,
                                                  quantize_params_int8,
                                                  quantize_params_w4)
    if args.int8 != "off":
        params = quantize_params_int8(
            params, ALL_STACK_KEYS if args.int8 == "all" else DECODE_KEYS)
        if cfg.fused_oar_kernel:
            params = pack_fused(params, kv_dtype=cfg.oar_cache_dtype)
    if args.tar_w4:
        params = quantize_params_w4(params)
    return params


def serving_params(cfg, generator, device, buffers=None):
    """The JAX bench's serving weights (bench.py:341-352): seeded random
    params, int8 on every stack, W4A8 OAR weights packed from the raw OAR
    stack — the fused steps then run w4 / w4mq (w4i4 / w4mqi4 on the int4
    OAR cache).  The CLI, like the JAX
    CLI, never builds these."""
    from umgen_tpu_torch.params import init_params
    from umgen_tpu_torch.runtime.quantize import (ALL_STACK_KEYS,
                                                  pack_fused_w4,
                                                  quantize_params_int8)
    raw = init_params(cfg, generator, device, buffers=buffers)
    return pack_fused_w4(quantize_params_int8(raw, ALL_STACK_KEYS),
                         raw["oar"])


def require_cv2(args) -> None:
    """`--save_video` writes mp4s with cv2: where it does not import, stop
    before anything is built."""
    if not args.save_video:
        return
    try:
        import cv2  # noqa: F401
    except ImportError as e:
        raise SystemExit(f"--save_video writes the videos with cv2, which "
                         f"does not import here ({e}): install it, or run "
                         "with --save_video false (token pickles and "
                         "metrics only)") from e


def build_decoders(args, device):
    """The map and image VQ decoders as the JAX CLI builds them
    (umgen_tpu/tools/evaluate.py:244-262), on `device`: each loaded from
    its weights path where that file exists, seeded at random otherwise.
    (None, None) unless `--save_video`."""
    if not args.save_video:
        return None, None
    from umgen_tpu_torch.models import vq
    from umgen_tpu_torch.runtime.torch_import import load_vq_checkpoint

    def weights(path, cfg):
        return load_vq_checkpoint(path, cfg, device) \
            if os.path.exists(path) else None

    return (vq.MapDecoder(weights(args.map_decoder_weights_path, vq.MAP_VQ),
                          device=device),
            vq.ImageDecoder(weights(args.image_decoder_weights_path,
                                    vq.IMAGE_VQ), device=device))


def run_dataset(args, runner, infer_cfg, pipeline):
    """The scenes of `--data_root` (`data/controlled_scenes` under
    `--infer_task control`; `--synthetic_data N` generates video scenes
    where it is missing) through `runner`, `--batch_size` at a time,
    padded to a multiple of `--dp`; under `--profile_dir` the scene loop
    is traced.  Returns the dataset (its journal of error scenes)."""
    import numpy as np

    from umgen_tpu_torch.config import DataConfig
    from umgen_tpu_torch.data.dataset import NuPlanTokenDataset
    from umgen_tpu_torch.runtime.profiler import trace

    control = args.infer_task == "control"
    mesh = runner.gen.mesh
    data_root = CONTROL_ROOT if control else args.data_root
    if not os.path.isdir(data_root) and args.synthetic_data > 0:
        from umgen_tpu_torch.data.synthetic import write_synthetic_dataset
        data_root = os.path.join(args.output_path, "synthetic_scenes")
        if runner.writer:
            write_synthetic_dataset(data_root, n_scenes=args.synthetic_data,
                                    seed=args.seed)
            print("generated synthetic dataset at", data_root)
        if mesh is not None:        # the other ranks read what it wrote
            mesh.broadcast(np.zeros(1, np.uint8))
    dcfg = DataConfig(data_root=(data_root,),
                      block_size=infer_cfg.num_new_frames
                      + infer_cfg.cond_frames, control_test=control)
    dataset = NuPlanTokenDataset(dcfg, pipeline)
    if len(dataset) == 0:
        raise SystemExit(f"no scenes found under {data_root}; use "
                         "--synthetic_data N")
    n = len(dataset) if args.max_scenes < 0 else min(args.max_scenes,
                                                     len(dataset))
    group = []
    with trace(args.profile_dir, runner.gen.device,
               None if mesh is None else mesh.rank):
        for i in range(n):
            batch = dataset[i]
            if batch is None:
                continue
            if control and "dataset_token" not in batch:
                # the JAX CLI fails here with a KeyError: --synthetic_data
                # writes video scenes, which a control run cannot read
                raise SystemExit(
                    f"{batch['file_name']} is not a control scene (no "
                    "'dataset_token'): control mode reads control pkls — "
                    "see data.synthetic.write_control_scenes and "
                    "tools.load_control_tokens")
            group.append(batch)
            if len(group) >= max(args.batch_size, 1):
                runner.run_scenes(group, control_test=control,
                                  pad_to=args.dp)
                group = []
        if group:
            runner.run_scenes(group, control_test=control, pad_to=args.dp)
    if runner.timings and runner.writer:
        fps = sum(t["frames_per_sec"] for t in runner.timings) \
            / len(runner.timings)
        print(f"mean throughput: {fps:.4f} frames/sec on "
              f"{runner.gen.device}")
    return dataset


def report(args, runner, dataset) -> None:
    """The JAX CLI's closing lines (umgen_tpu/tools/evaluate.py:329-346):
    speculative decoding's drafts accepted a chunk, the collision rate, MMD
    against the GT continuation, the error-scene journal."""
    gen, K = runner.gen, runner.gen.model.config.speculative_k
    if K > 0 and gen.spec_chunks:
        # sequential decode of the same tokens costs chunks + accepted steps
        acc = gen.spec_accepted / gen.spec_chunks
        speedup = (gen.spec_chunks + gen.spec_accepted) / gen.spec_chunks
        print(f"speculative: {acc:.2f} drafts accepted/chunk (K={K}), "
              f"{speedup:.2f}x fewer OAR steps on speculative segments")
    ratio, scen = runner.box_overlap.average()
    print(f"collision rate: per-frame {ratio:.4f}, per-scenario {scen:.4f}")
    if any(runner.mmd.scores.values()):
        mmd = runner.mmd.average()
        print("MMD (generated vs GT continuation): "
              + ", ".join(f"{a}={v:.4f}" for a, v in mmd.items()))
    journal = os.path.join(args.output_path, "error_scene.txt")
    dataset.write_error_journal(journal)
    if dataset.error_scenes:
        print(f"{len(dataset.error_scenes)} error scene(s) journaled to "
              f"{journal}")


def run(args, mesh=None):
    """Run the evaluation; returns the SceneRunner (timings, metrics) and
    the Generator.  `mesh`: this rank's parallel.mesh.Mesh under `--dp` /
    `--launcher` (its card is the run's device)."""
    import torch

    from umgen_tpu_torch.config import InferConfig
    from umgen_tpu_torch.data.pipeline import ScenePipeline
    from umgen_tpu_torch.models.generate import Generator
    from umgen_tpu_torch.models.umgen import UMGen
    from umgen_tpu_torch.tools.harness import SceneRunner

    check_args(args)
    require_cv2(args)
    cfg = config_from_args(args)
    device = torch.device(args.device) if mesh is None else mesh.device
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: the port runs on the card; pass "
                           "--device cpu for the plain versions on the CPU")
    infer_cfg = InferConfig.for_task(args.infer_task,
                                     args.set_num_new_frames,
                                     batch_size=args.batch_size,
                                     seed=args.seed)
    pipeline = ScenePipeline()
    model = UMGen(cfg)
    params = build_params(args, cfg, device, pipeline)
    map_dec, image_dec = build_decoders(args, device)
    gen = Generator(model, params, seed=args.seed, device=device, mesh=mesh,
                    spmd="gspmd" if mesh is None else "shard_map")
    runner = SceneRunner(gen, infer_cfg, output_path=args.output_path,
                         pipeline=pipeline, map_decoder=map_dec,
                         image_decoder=image_dec,
                         save_video=args.save_video,
                         init_token_mod=[m for m in
                                         args.init_token_mod.split(",") if m],
                         gt_video=not args.no_gt_video)
    dataset = run_dataset(args, runner, infer_cfg, pipeline)
    if runner.writer:
        report(args, runner, dataset)
    return runner, gen


def rank_main(mesh, args):
    """One rank of a data-parallel run (what `--dp` and `--launcher`
    reach); returns `run`'s (runner, generator)."""
    out = run(args, mesh)
    if mesh.rank == 0:
        print("Sucess")
    return out


def main(argv: Optional[list] = None) -> int:
    args = build_parser().parse_args(argv)
    check_args(args)
    if args.launcher is None and args.dp == 1:
        run(args)
        print("Sucess")   # the reference's success marker
        return 0
    import torch

    from umgen_tpu_torch.parallel import mesh as mesh_lib
    kind = torch.device(args.device).type
    if args.launcher is not None:
        env = mesh_lib.launcher_env(args.launcher)
        if env["world"] != args.dp:
            raise SystemExit(f"--dp {args.dp}: under --launcher it must "
                             f"equal the world size, {env['world']}")
        devices = mesh_lib.host_devices(kind, env["world"])
        mesh_lib.init(env["rank"], env["world"], env["addr"], env["port"],
                      "nccl" if kind == "cuda" else "gloo")
        try:
            if kind == "cuda":
                torch.cuda.set_device(devices[env["local_rank"]])
            rank_main(mesh_lib.make_mesh(args.dp, devices=devices,
                                         local_rank=env["local_rank"]), args)
        finally:
            import torch.distributed as dist
            dist.destroy_process_group()
        return 0
    devices = mesh_lib.host_devices(kind, args.dp)
    mesh_lib.check_devices(args.dp, devices)
    if kind == "cuda":
        from umgen_tpu_torch.ops import _cuda
        _cuda.build()       # once, before the ranks load it
    mesh_lib.launch(rank_main, args.dp, devices, args)
    return 0


if __name__ == "__main__":
    sys.exit(main())
