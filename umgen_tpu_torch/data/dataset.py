"""Scene datasets: pkl clip reader and control-scene reader.

Rebuild of ``NuPlanTokenDataset`` (ref:plugin/data/datasets/
UMGen_nuplan_dataset.py) without the torch DataLoader machinery — scenes are
plain dicts of numpy arrays; batching/sharding happens in the rollout
harness.
"""

from __future__ import annotations

import os
import pickle
from typing import Dict, List, Optional, Sequence

import numpy as np

from umgen_tpu_torch.config import CATEGORIES, DataConfig
from umgen_tpu_torch.data.pipeline import ScenePipeline


def list_scene_files(data_root: Sequence[str]) -> List[str]:
    """Collect and sort .pkl scene files (ref:UMGen_nuplan_dataset.py:84-91)."""
    files: List[str] = []
    for path in data_root:
        if os.path.isfile(path) and path.endswith(".pkl"):
            files.append(path)
            continue
        if os.path.isdir(path):
            for fn in os.listdir(path):
                if fn.endswith(".pkl"):
                    files.append(os.path.join(path, fn))
    return sorted(files)


def get_frame_indices(seq_len: int, block_size: int, sampling_gap: int,
                      start_index: int) -> List[int]:
    """Frame sub-sampling (ref:UMGen_nuplan_dataset.py:145-175)."""
    max_start_index = seq_len - block_size * sampling_gap - sampling_gap
    if max_start_index < sampling_gap:
        max_start_index = sampling_gap
        block = (seq_len - sampling_gap - 1) // sampling_gap
        start = min(start_index, max_start_index)
        return [start + i * sampling_gap for i in range(block)]
    start = min(start_index, max_start_index)
    return [start + i * sampling_gap for i in range(block_size)]


def _wrap_heading(h: float) -> float:
    if h >= np.pi:
        h -= 2 * np.pi
    if h < -np.pi:
        h += 2 * np.pi
    return h


class NuPlanTokenDataset:
    """pkl scene clips → token dicts.

    Expected pkl schema (ref:UMGen_nuplan_dataset.py:211-306):
      tokens[view]{tokens: T×(h,w) image VQ indices, file_list: [str]},
      raster_tokens: (T, 32, 32) map VQ indices,
      ego_pose_all: (T, 16) [x,y,z,w,l,h,heading,...],
      meta_info: T × {T_lidar2global (4,4), bboxes_3d (N,10), track_ids,
                      categories}.
    """

    def __init__(self, config: DataConfig,
                 pipeline: Optional[ScenePipeline] = None):
        self.config = config
        self.pipeline = pipeline or ScenePipeline()
        self.files = list_scene_files(config.data_root)
        self.categories = set(CATEGORIES)
        # scenes whose pkl was malformed, with the error — journaled and
        # skipped instead of killing the batch run
        # (ref:UMGen_nuplan_dataset.py:114,183-200,329-342)
        self.error_scenes: List[Dict[str, str]] = []

    def __len__(self) -> int:
        return len(self.files)

    def __getitem__(self, idx: int) -> Optional[Dict]:
        """One scene, or None (journaled in `error_scenes`) if the pkl is
        corrupt/malformed — a bad scene must not kill a batch run
        (ref:UMGen_nuplan_dataset.py:183-200)."""
        path = self.files[idx]
        try:
            with open(path, "rb") as f:
                raw = pickle.load(f)
            if self.config.control_test:
                # control pkls are already tokenized dicts, loaded verbatim
                # (ref:UMGen_nuplan_dataset.py:204-207)
                raw["file_name"] = f"{idx}_{path}"
                return raw
            return self.format_scene(raw, idx, path)
        except Exception as e:  # noqa: BLE001 — journal any bad scene
            self.error_scenes.append(
                {"scene": path, "error": f"{type(e).__name__}: {e}"})
            print(f"error scene {path}: {type(e).__name__}: {e} — skipped")
            return None

    def write_error_journal(self, path: str) -> None:
        """Append journaled error scenes to a text file (one per line)."""
        if not self.error_scenes:
            return
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        with open(path, "a") as f:
            for rec in self.error_scenes:
                f.write(f"{rec['scene']}\t{rec['error']}\n")

    def format_scene(self, frame_data: Dict, idx: int, path: str) -> Dict:
        """Raw pkl → token dict (ref:UMGen_nuplan_dataset.py:231-417)."""
        cfg = self.config
        view = cfg.views[0]
        image_data = np.stack(frame_data["tokens"][view]["tokens"], axis=0)
        seq_len = image_data.shape[0]
        frame_indices = get_frame_indices(seq_len, cfg.block_size,
                                          cfg.sampling_gap, cfg.start_index)

        meta = frame_data["meta_info"]
        pose_all = np.asarray(frame_data["ego_pose_all"])
        gap = cfg.sampling_gap

        pose_diff, bboxes, cats, tids = [], [], [], []
        for i, fi in enumerate(frame_indices):
            # ego motion INTO frame fi, expressed in the previous frame's
            # lidar coordinates (ref:UMGen_nuplan_dataset.py:252-276)
            index = frame_indices[i - 1] if i > 0 else fi - gap
            assert index >= 0
            tr = np.linalg.inv(meta[index]["T_lidar2global"]) @ (
                meta[index + gap]["T_lidar2global"]
                @ np.array([0.0, 0.0, 0.0, 1.0]).T)
            heading_r = _wrap_heading(
                pose_all[index + gap, 6] - pose_all[index, 6])
            pose_diff.append([tr[0], tr[1], heading_r])

            # category + |x|,|y| <= 64 filter (ref:...py:317-342)
            frame_boxes = np.asarray(meta[fi]["bboxes_3d"], dtype=np.float32)
            frame_cats = list(meta[fi]["categories"])
            frame_tids = np.asarray(meta[fi]["track_ids"])
            keep = [
                j for j, c in enumerate(frame_cats)
                if c in self.categories
                and abs(frame_boxes[j][0]) <= 64
                and abs(frame_boxes[j][1]) <= 64
            ]
            bboxes.append(frame_boxes[keep] if len(frame_boxes) else
                          frame_boxes.reshape(0, 10))
            cats.append([frame_cats[j] for j in keep])
            tids.append(frame_tids[keep] if len(frame_tids) else frame_tids)

        pose = np.asarray(pose_diff, dtype=np.float32)

        map_tokens = np.asarray(frame_data["raster_tokens"])[frame_indices]
        map_tokens = map_tokens.reshape(map_tokens.shape[0], -1)

        image_tokens = image_data[frame_indices].reshape(
            len(frame_indices), -1)

        data = self.pipeline.encode(pose, map_tokens, bboxes, cats, tids,
                                    image_tokens)
        data["file_name"] = f"{idx}_{path}"
        return data
