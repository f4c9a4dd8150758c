"""The one generator of every traffic mix: a mix file under benchmark/traffic/
names the scene batch and the frames, this module turns it and a seed into
the history tokens both sides are given.

`history_tokens` is a frozen copy of umgen_tpu_torch/data/synthetic.py:156
`make_token_batch` (random-but-valid tokens: uniform pose, map and image
ids; 40 live boxes of uniform attribute bins and a category, 20 <pad>
slots), written against the configuration's layout instead of the
program's.  The same seed gives the same tokens, and every seed the same
sizes.
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import Dict

import numpy as np

TRAFFIC_DIR = Path(__file__).resolve().parent
MIX_KEYS = ("scenes", "history_frames", "warm_frames", "check_scenes")


def load_mix(name: str, root: Path = TRAFFIC_DIR) -> Dict:
    """The mix file `<name>.json`: scenes (the scene batch), history_frames
    (the conditioning frames given), warm_frames (generated in set-up, not
    timed), check_scenes (scenes whose frames the reference judges)."""
    with open(root / f"{name}.json") as f:
        mix = json.load(f)
    missing = [k for k in MIX_KEYS if k not in mix]
    if missing:
        raise ValueError(f"traffic {name}: missing {missing}")
    if not 1 <= mix["check_scenes"] <= mix["scenes"]:
        raise ValueError(f"traffic {name}: check_scenes must be in 1.."
                         f"{mix['scenes']}")
    return mix


def history_tokens(model: Dict, B: int, T: int, seed: int
                   ) -> Dict[str, np.ndarray]:
    """{mod: [B, T, content_len] int32} history of B scenes and T frames.
    model: the configuration's "model" block (its "layout" and vocabulary
    sizes)."""
    rng = np.random.default_rng(seed)
    out = {}
    for mod, n, _, _ in model["layout"]:
        if mod == "pose":
            tok = rng.integers(0, model["pose_vocab_size"], size=(B, T, n))
        elif mod == "map":
            tok = rng.integers(0, model["map_vocab_size"], size=(B, T, n))
        elif mod == "bbox3d":
            tok = rng.integers(0, 1024, size=(B, T, n))
            boxes = tok.reshape(B, T, n // 11, 11)
            boxes[:, :, 40:, :] = model["bbox3d_vocab_size"] - 1
            boxes[:, :, :40, 10] = rng.integers(1024, 1027, size=(B, T, 40))
            tok = boxes.reshape(B, T, n)
        elif mod == "image":
            tok = rng.integers(0, model["img_vocab_size"], size=(B, T, n))
        else:
            raise ValueError(f"unknown modality {mod!r}")
        out[mod] = tok.astype(np.int32)
    return out


def check_scene_ids(B: int, k: int, seed: int) -> np.ndarray:
    """The k scenes of B whose frames are judged, drawn from the seed."""
    rng = np.random.default_rng([seed, 0xC4EC])
    return np.sort(rng.choice(B, size=k, replace=False))
