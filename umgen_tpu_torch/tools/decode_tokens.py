"""Standalone token-pickle → video decoder (port of
umgen_tpu/tools/decode_tokens.py).

The reference's decode_tokens utility (ref:projects/tools/decode_map.py:
186-275): load a saved rollout pickle, detokenize map / image / pose on the
card (`--device`, `cuda` unless asked), and write an mp4: each frame the
camera image over the map raster, with the frame / pose header.

    python -m umgen_tpu_torch.tools.decode_tokens \\
        out/saved_token/x_tokens.pkl --save out/video/x.mp4 \\
        [--map_ckpt ...] [--image_ckpt ...] [--device cpu]

Each decoder is loaded from its checkpoint where that file exists, and
seeded at random otherwise, as in the JAX tool.
"""

from __future__ import annotations

import argparse
import os
import pickle

import numpy as np


def decode_token_file(path: str, save: str, map_ckpt=None, image_ckpt=None,
                      fps: int = 5, cond_num: int = 19,
                      device="cuda") -> str:
    from umgen_tpu_torch.data.pipeline import ScenePipeline
    from umgen_tpu_torch.models.vq import (IMAGE_VQ, MAP_VQ, ImageDecoder,
                                           MapDecoder)
    from umgen_tpu_torch.tools.visualize import (put_header, stack_panels,
                                                 write_video)

    with open(path, "rb") as f:
        data = pickle.load(f)

    def load_vq(ckpt, cfg):
        if ckpt and os.path.exists(ckpt):
            from umgen_tpu_torch.runtime.torch_import import \
                load_vq_checkpoint
            return load_vq_checkpoint(ckpt, cfg, device)
        return None

    maps = images = None
    if "map" in data:
        dec = MapDecoder(load_vq(map_ckpt, MAP_VQ), device=device)
        maps = dec.decode(np.asarray(data["map"])[0])
    if "image" in data:
        dec = ImageDecoder(load_vq(image_ckpt, IMAGE_VQ), device=device)
        images = dec.decode(np.asarray(data["image"])[0])

    pose = ScenePipeline().decode_pose(np.asarray(data["pose"])[0])
    pose[:, 2] = pose[:, 2] * 180.0 / np.pi

    frames = []
    for t in range(pose.shape[0]):
        panels = [np.clip((arr[t] + 1) / 2 * 255, 0, 255).astype(np.uint8)
                  for arr in (images, maps) if arr is not None]
        img = stack_panels(*panels) if panels else np.full(
            (256, 256, 3), 30, np.uint8)
        frames.append(put_header(img, t, cond_num, pose[t]))
    return write_video(frames, save, fps=fps)


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("token_pkl")
    p.add_argument("--save", default=None)
    p.add_argument("--map_ckpt", default="data/weights/map_vae.ckpt")
    p.add_argument("--image_ckpt", default="data/weights/image_vae.tar")
    p.add_argument("--fps", type=int, default=5)
    p.add_argument("--device", type=str, default="cuda",
                   help="torch device; the CPU only when asked (cpu)")
    args = p.parse_args(argv)
    import torch

    from umgen_tpu_torch.tools.visualize import HAS_CV2
    if not HAS_CV2:
        raise SystemExit("decode_tokens writes its video with cv2, which "
                         "does not import here")
    if args.device.startswith("cuda") and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: the decoders run on the card; "
                           "pass --device cpu for the CPU")
    save = args.save or args.token_pkl.replace("_tokens.pkl", ".mp4")
    out = decode_token_file(args.token_pkl, save, args.map_ckpt,
                            args.image_ckpt, args.fps, device=args.device)
    print("wrote", out)


if __name__ == "__main__":
    main()
