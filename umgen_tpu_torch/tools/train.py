"""Training CLI (port of umgen_tpu/tools/train.py): teacher-forced
next-scene training of UMGen on one card, with the JAX CLI's flags and
defaults, plus `--device`:

    python -m umgen_tpu_torch.tools.train --model_scale tiny --steps 100 \\
        --synthetic_data 4
    python -m umgen_tpu_torch.tools.train --device cpu --model_scale tiny \\
        --steps 3 --synthetic_data 2

Real data uses the same pkl clips as evaluation (`--data_root`); without
them `--synthetic_data N` writes N synthetic scenes under `--ckpt_dir`.  The
weights are seeded (`--seed`, a torch.Generator on the device); the model
config is the JAX CLI's (`use_pallas_attention=False`, `--temporal_pe`,
`--remat`; `--param_dtype` is accepted and, as in the JAX package, read by
nothing: params and Adam moments are in the config's dtype, bf16).  It
writes `train_meta.json` with the JAX CLI's keys, prints the JAX CLI's line
every `--log_every` steps, saves the train state (runtime/checkpoint.py) as
`step_NNNNNNN` every `--save_every` steps and as `final`, and `--resume
PATH` restores a state and its step (the batches start again from the
seed, as in the JAX CLI).

`--dp N --tp M` trains over the JAX CLI's (dp, tp) mesh: N·M ranks on
this host, one a card (NCCL; under `--device cpu` on the CPU over gloo),
refused where there are fewer cards.  Every rank builds the same initial
params from `--seed`, reads `--resume` (a whole tree), takes its blocks of
the state under tp (parallel/mesh.py), and draws the same global batch
from `batch_iterator`; it takes its dp index's rows of it (`--batch_size`
must be a multiple of `--dp`), and the gradients are the dp ranks' mean
(parallel/train.py).  Rank 0 writes `train_meta.json`, the log lines and
the checkpoints; a checkpoint holds the whole state, gathered over tp (as
orbax saves JAX's global arrays), so a run at any tp resumes it.
"""

from __future__ import annotations

import argparse
import json
import os
import time
from typing import Dict, Iterator

import numpy as np


def batch_iterator(dataset, batch_size: int, window: int,
                   seed: int = 0) -> Iterator[Dict[str, np.ndarray]]:
    """Random clip windows → stacked training batches (numpy; the JAX
    CLI's draws)."""
    rng = np.random.default_rng(seed)
    mods = ("pose", "map", "bbox3d", "image")
    while True:
        batch = {m: [] for m in mods}
        for _ in range(batch_size):
            scene = dataset[int(rng.integers(len(dataset)))]
            T = scene["pose"].shape[0]
            t0 = int(rng.integers(0, max(T - window, 1)))
            for m in mods:
                batch[m].append(np.asarray(scene[m][t0:t0 + window]))
        yield {m: np.stack(v).astype(np.int32) for m, v in batch.items()}


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="UMGen training (PyTorch)")
    p.add_argument("--model_scale", default="tiny")
    p.add_argument("--steps", type=int, default=100)
    p.add_argument("--batch_size", type=int, default=2)
    p.add_argument("--window", type=int, default=4,
                   help="frames per training clip window")
    p.add_argument("--lr", type=float, default=1e-4)
    p.add_argument("--warmup", type=int, default=None,
                   help="LR warmup steps (default min(1000, steps/10) so "
                        "short runs actually reach peak LR)")
    p.add_argument("--dp", type=int, default=1,
                   help="data-parallel ranks, one a card")
    p.add_argument("--tp", type=int, default=1,
                   help="tensor-parallel ranks (heads, hidden columns and "
                        "vocab split over them)")
    p.add_argument("--data_root", default="data/tokenized_origin_scenes")
    p.add_argument("--synthetic_data", type=int, default=0)
    p.add_argument("--ckpt_dir", default="output/train_ckpt")
    p.add_argument("--save_every", type=int, default=500)
    p.add_argument("--log_every", type=int, default=10)
    p.add_argument("--remat", action="store_true",
                   help="recompute each block in the backward pass")
    p.add_argument("--optimizer", default="adamw",
                   choices=("adamw", "sgd", "sign_sgd"),
                   help="sign_sgd = stateless sign updates")
    p.add_argument("--param_dtype", default=None,
                   help="accepted as in the JAX CLI, where nothing reads "
                        "it: the params stay in the config's dtype")
    p.add_argument("--oar_label_smooth", type=float, default=0.0,
                   help="label smoothing on the OAR loss")
    p.add_argument("--oar_loss_weight", type=float, default=1.0)
    p.add_argument("--temporal_pe", default="absolute",
                   choices=("absolute", "relative"),
                   help="relative = a learned per-head temporal-attention "
                        "bias by frame distance")
    p.add_argument("--resume", default=None)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", default="cuda",
                   help="torch device; the CPU only when asked (cpu)")
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)

    import torch

    from umgen_tpu_torch.config import ModelConfig
    from umgen_tpu_torch.parallel import mesh as mesh_lib

    if args.dp < 1 or args.tp < 1:
        raise SystemExit(f"--dp {args.dp} --tp {args.tp}: at least 1 each")
    if args.batch_size % args.dp:
        raise SystemExit(f"--batch_size {args.batch_size} must be a "
                         f"multiple of --dp {args.dp}")
    n_head = ModelConfig().scaled(args.model_scale).n_head
    if n_head % args.tp:
        raise SystemExit(f"--tp {args.tp} must divide the {n_head} heads "
                         f"of --model_scale {args.model_scale}")
    world = args.dp * args.tp
    if world == 1:
        return 0 if train(args) is not None else 1
    devices = mesh_lib.host_devices(torch.device(args.device).type, world)
    mesh_lib.check_devices(world, devices)
    mesh_lib.launch(train_rank, args.dp, devices, args, tp=args.tp)
    return 0


def train_rank(mesh, args) -> None:
    """One rank of `--dp` / `--tp` training."""
    train(args, mesh)


def train(args, mesh=None):
    """The training run (one process, or this rank of a data-parallel
    one: `mesh`, a parallel.mesh.Mesh, whose card is its device).  Returns
    the final TrainState, None without scenes."""
    import torch

    from umgen_tpu_torch.config import DataConfig, ModelConfig
    from umgen_tpu_torch.data.dataset import NuPlanTokenDataset
    from umgen_tpu_torch.models.umgen import UMGen
    from umgen_tpu_torch.params import init_params
    from umgen_tpu_torch.parallel.train import (UMGenTrainer, shard_state,
                                                whole_state)
    from umgen_tpu_torch.runtime import checkpoint as ckpt

    device = torch.device(args.device) if mesh is None else mesh.device
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: the port trains on the card; "
                           "pass --device cpu to train on the CPU")
    writer = mesh is None or mesh.rank == 0

    data_root = args.data_root
    if not os.path.isdir(data_root) and args.synthetic_data > 0:
        from umgen_tpu_torch.data.synthetic import write_synthetic_dataset
        data_root = os.path.join(args.ckpt_dir, "synthetic")
        if writer:
            write_synthetic_dataset(data_root, n_scenes=args.synthetic_data,
                                    seed=args.seed)
        if mesh is not None:        # the other ranks read what it wrote
            mesh.broadcast(np.zeros(1, np.uint8))
    dataset = NuPlanTokenDataset(DataConfig(
        data_root=(data_root,), block_size=args.window + 2))
    if len(dataset) == 0:
        print("no training scenes; use --synthetic_data N")
        return None

    cfg_kw = dict(remat=args.remat, use_pallas_attention=False,
                  temporal_pe_mode=args.temporal_pe)
    if args.param_dtype:
        cfg_kw["param_dtype"] = args.param_dtype
    cfg = ModelConfig(**cfg_kw).scaled(args.model_scale)
    model = UMGen(cfg)
    warmup = args.warmup if args.warmup is not None else \
        min(1000, max(args.steps // 10, 1))
    trainer = UMGenTrainer(model, learning_rate=args.lr,
                           warmup_steps=warmup,
                           total_steps=args.steps,
                           optimizer=args.optimizer,
                           oar_label_smooth=args.oar_label_smooth,
                           oar_loss_weight=args.oar_loss_weight,
                           mesh=mesh)
    params = init_params(cfg, torch.Generator(device).manual_seed(args.seed),
                         device)
    state = trainer.init_state(params)
    if args.resume:
        state = ckpt.load_train_state(args.resume, state)
        if writer:
            print(f"resumed from {args.resume} at step {int(state.step)}")
    if mesh is not None:        # this rank's blocks of the whole state
        state = shard_state(mesh, state)
    step_fn = trainer.jit_train_step(mesh)

    # the training regime beside the checkpoints: serving needs the
    # trained window length to clamp temporal-PE indices (config.tpe_clamp)
    if writer:
        os.makedirs(args.ckpt_dir, exist_ok=True)
        with open(os.path.join(args.ckpt_dir, "train_meta.json"), "w") as f:
            json.dump({"window": args.window,
                       "model_scale": args.model_scale,
                       "optimizer": args.optimizer, "steps": args.steps,
                       "batch_size": args.batch_size,
                       "temporal_pe": args.temporal_pe,
                       "oar_label_smooth": args.oar_label_smooth,
                       "oar_loss_weight": args.oar_loss_weight}, f)

    def save(path):
        """The whole state at `path` (rank 0 writes; under tp every rank
        joins the gather)."""
        whole = state if mesh is None else whole_state(mesh, state)
        if writer:
            ckpt.save_train_state(path, whole)
            print("saved", path)

    it = batch_iterator(dataset, args.batch_size, args.window, args.seed)
    t0 = time.perf_counter()
    for i in range(args.steps):
        batch = {k: torch.as_tensor(v, dtype=torch.long, device=device)
                 for k, v in next(it).items()}
        state, metrics = step_fn(state, batch)
        if writer and ((i + 1) % args.log_every == 0 or i == 0):
            m = {k: float(v) for k, v in metrics.items()}
            dt = time.perf_counter() - t0
            print(f"step {i + 1}/{args.steps} loss={m['loss']:.4f} "
                  f"(ego {m['ego_loss']:.3f} tar {m['tar_loss']:.3f} "
                  f"oar {m['oar_loss']:.3f}) "
                  f"gnorm={m['grad_norm']:.2f} {dt:.1f}s")
        if args.save_every and (i + 1) % args.save_every == 0:
            save(os.path.join(args.ckpt_dir, f"step_{i + 1:07d}"))

    save(os.path.join(args.ckpt_dir, "final"))
    return state


if __name__ == "__main__":
    import sys
    sys.exit(main())
