"""Synthetic scene generation for tests and benchmarks.

The reference ships no data; its de-facto fixtures are `--debug` random
weights + real pkl clips (ref:README quick-start).  We generate physically
plausible synthetic clips in the exact pkl schema the dataset reader expects,
so the full pipeline (reader → tokenizers → model → decode → video) is
exercisable anywhere.
"""

from __future__ import annotations

import os
import pickle
from typing import Dict, Optional

import numpy as np

from umgen_tpu_torch.config import CATEGORIES


def make_scene(seq_len: int = 220, n_objects: int = 24, seed: int = 0,
               map_vocab: int = 8192, img_vocab: int = 8192) -> Dict:
    """Build one raw scene dict in the nuplan pkl schema."""
    rng = np.random.default_rng(seed)

    # ego: forward motion with gentle curvature
    speed = rng.uniform(2.0, 8.0)
    yaw_rate = rng.uniform(-0.02, 0.02)
    xs, ys, yaws = [0.0], [0.0], [0.0]
    for _ in range(seq_len - 1):
        yaws.append(yaws[-1] + yaw_rate)
        xs.append(xs[-1] + speed * 0.1 * np.cos(yaws[-1]))
        ys.append(ys[-1] + speed * 0.1 * np.sin(yaws[-1]))

    meta_info = []
    ego_pose_all = np.zeros((seq_len, 16), dtype=np.float64)
    ego_pose_all[:, 0] = xs
    ego_pose_all[:, 1] = ys
    ego_pose_all[:, 6] = yaws

    # persistent agents moving in the ego frame
    obj_state = rng.uniform(-50, 50, size=(n_objects, 2))
    obj_vel = rng.uniform(-3, 3, size=(n_objects, 2))
    obj_size = np.stack([
        rng.uniform(3, 8, n_objects),       # l
        rng.uniform(1.5, 2.5, n_objects),   # w
        rng.uniform(1.2, 2.2, n_objects),   # h
    ], axis=1)
    obj_yaw = rng.uniform(-np.pi, np.pi, n_objects)
    obj_cat = rng.choice(list(CATEGORIES), n_objects)
    obj_tid = np.arange(100, 100 + n_objects)

    for t in range(seq_len):
        c, s = np.cos(yaws[t]), np.sin(yaws[t])
        T = np.eye(4)
        T[0, 0], T[0, 1], T[1, 0], T[1, 1] = c, -s, s, c
        T[0, 3], T[1, 3] = xs[t], ys[t]

        pos = obj_state + obj_vel * t * 0.1
        boxes = np.concatenate([
            pos,                                           # x, y
            rng.normal(0, 0.2, (n_objects, 1)),            # z
            obj_size,                                      # l, w, h
            obj_yaw[:, None],                              # yaw
            obj_vel,                                       # vx, vy
            np.zeros((n_objects, 1)),                      # vz
        ], axis=1).astype(np.float32)
        inside = (np.abs(boxes[:, 0]) <= 60) & (np.abs(boxes[:, 1]) <= 60)
        meta_info.append({
            "T_lidar2global": T,
            "bboxes_3d": boxes[inside],
            "track_ids": obj_tid[inside],
            "categories": [str(c) for c in obj_cat[inside]],
        })

    # map/image VQ tokens evolve slowly: each frame keeps ~95% of the
    # previous frame's tokens and resamples the rest (real driving scenes
    # are temporally coherent at the token level — a static-per-frame
    # stream would make any temporal model, and speculative-decode
    # acceptance, unlearnable on synthetic data)
    img0 = rng.integers(0, img_vocab, size=(16, 32))
    image_tokens = []
    for _ in range(seq_len):
        flip = rng.random(img0.shape) < 0.05
        img0 = np.where(flip, rng.integers(0, img_vocab, size=img0.shape),
                        img0)
        image_tokens.append(img0.copy())
    map0 = rng.integers(0, map_vocab, size=(32, 32))
    raster_tokens = np.empty((seq_len, 32, 32), np.int64)
    for t in range(seq_len):
        flip = rng.random(map0.shape) < 0.05
        map0 = np.where(flip, rng.integers(0, map_vocab, size=map0.shape),
                        map0)
        raster_tokens[t] = map0

    return {
        "tokens": {"CAM_F0": {
            "tokens": image_tokens,
            "file_list": [f"frame_{t:04d}.jpg" for t in range(seq_len)],
        }},
        "raster_tokens": raster_tokens,
        "ego_pose_all": ego_pose_all,
        "meta_info": meta_info,
    }


def write_synthetic_dataset(out_dir: str, n_scenes: int = 2,
                            seq_len: int = 220, seed: int = 0) -> str:
    os.makedirs(out_dir, exist_ok=True)
    for i in range(n_scenes):
        scene = make_scene(seq_len=seq_len, seed=seed + i)
        name = f"synthetic_scene_{i:03d}_{seed + i}_clip.pkl"
        with open(os.path.join(out_dir, name), "wb") as f:
            pickle.dump(scene, f)
    return out_dir


def make_control_scene(layout, cond_frames: int = 13, new_frames: int = 30,
                       seed: int = 0, control_slot: int = 0) -> Dict:
    """Synthetic control-mode pkl: conditioning tokens + a forced ego
    trajectory and one controlled agent slot (the reference's
    controlled_scenes schema consumed by the harness,
    ref:tools/model_pl.py:132-170)."""
    rng = np.random.default_rng(seed)
    cond = make_token_batch(layout, T=cond_frames, B=1, seed=seed)
    dataset_token = {m: v[0] for m, v in cond.items()}

    # forced trajectory: steady forward motion tokens near bin center
    pose = np.full((new_frames, 3), 512, np.int64)
    pose[:, 0] = 560          # dx slightly positive
    # controlled agent: slot `control_slot` forced, everything else free
    bbox = np.full((new_frames, 660), -1, np.int64)
    tok = rng.integers(100, 900, size=(new_frames, 11))
    tok[:, 10] = 1024         # vehicle
    bbox[:, control_slot * 11:(control_slot + 1) * 11] = tok
    return {
        "dataset_token": dataset_token,
        "control_dict": {"pose": pose, "bbox3d": bbox},
        "scene_name": f"synthetic_control_{seed}",
        "control_object": control_slot,
        "input_cond_frame": cond_frames,
    }


def write_control_scenes(out_dir: str, layout, n_scenes: int = 1,
                         seed: int = 0) -> str:
    os.makedirs(out_dir, exist_ok=True)
    for i in range(n_scenes):
        scene = make_control_scene(layout, seed=seed + i)
        with open(os.path.join(out_dir,
                               f"control_scene_{i:03d}.pkl"), "wb") as f:
            pickle.dump(scene, f)
    return out_dir


def make_token_batch(layout, T: int = 20, B: int = 1, seed: int = 0,
                     config=None) -> Dict[str, np.ndarray]:
    """Random-but-valid token dict for model smoke tests (window of T cond
    frames)."""
    from umgen_tpu_torch.config import ModelConfig
    cfg = config or ModelConfig()
    rng = np.random.default_rng(seed)
    out = {}
    for seg in layout.segments:
        n = seg.content_len
        if seg.mod == "pose":
            tok = rng.integers(0, cfg.pose_vocab_size, size=(B, T, n))
        elif seg.mod == "map":
            tok = rng.integers(0, cfg.map_vocab_size, size=(B, T, n))
        elif seg.mod == "bbox3d":
            tok = rng.integers(0, 1024, size=(B, T, n))
            # make some slots pad
            boxes = tok.reshape(B, T, 60, 11)
            boxes[:, :, 40:, :] = 1027
            boxes[:, :, :40, 10] = rng.integers(1024, 1027, size=(B, T, 40))
            tok = boxes.reshape(B, T, n)
        elif seg.mod == "image":
            tok = rng.integers(0, cfg.img_vocab_size, size=(B, T, n))
        out[seg.mod] = tok.astype(np.int32)
    return out
