"""Normalize control-scene pickles into the expected key layout.

Equivalent of ref:projects/tools/load_control_tokens.py: control pkls in the
wild carry inconsistent keys; this maps them onto the schema the control
harness consumes ({dataset_token, control_dict, scene_name, control_object,
input_cond_frame}).
"""

from __future__ import annotations

import argparse
import os
import pickle
from typing import Dict


KEY_ALIASES = {
    "dataset_token": ("dataset_token", "dataset_tokens", "gt_tokens"),
    "control_dict": ("control_dict", "control_tokens", "init_tokens"),
    "scene_name": ("scene_name", "file_name", "name"),
    "control_object": ("control_object", "control_id"),
    "input_cond_frame": ("input_cond_frame", "cond_frames"),
}


def normalize_control_pkl(data: Dict) -> Dict:
    out = {}
    for canon, aliases in KEY_ALIASES.items():
        for a in aliases:
            if a in data:
                out[canon] = data[a]
                break
    if "dataset_token" not in out:
        raise KeyError("no dataset tokens found in control pkl")
    out.setdefault("control_dict", {})
    out.setdefault("scene_name", "control_scene")
    return out


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("src_dir")
    p.add_argument("--dst_dir", default=None)
    args = p.parse_args(argv)
    dst = args.dst_dir or args.src_dir
    os.makedirs(dst, exist_ok=True)
    for fn in sorted(os.listdir(args.src_dir)):
        if not fn.endswith(".pkl"):
            continue
        with open(os.path.join(args.src_dir, fn), "rb") as f:
            data = pickle.load(f)
        norm = normalize_control_pkl(data)
        with open(os.path.join(dst, fn), "wb") as f:
            pickle.dump(norm, f)
        print("normalized", fn)


if __name__ == "__main__":
    main()
