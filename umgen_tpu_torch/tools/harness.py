"""Scene-rollout harness (port of umgen_tpu/tools/harness.py).

Runs the rollout for one scene (`run_scene`: a video clip, or a control pkl
with its ego trajectory and controlled agents) or a batch of video scenes
(`run_scenes`: one rollout with the scenes on the batch axis), writes the
token pickles ``saved_token/<scene>_tokens.pkl`` (skipping scenes already
done), reports per-frame seconds and frames/s, decodes the boxes and the
pose, and with the VQ decoders the map rasters and camera images (the
scenes whose decode fails are journaled to ``saved_token/undecoded_token.
txt``, as the reference does), accumulates the agent metrics — the
collision rate (`BoxOverlap`) over every frame, MMD against the GT
continuation — and under `save_video` writes one mp4 a scene under
``video/``: by default the prediction | GT panel with the GT maps decoded,
or the single panel with the GT pose (`gt_video=False`, or a scene without
boxes).

Under a data-parallel Generator (its `mesh`) `run_scenes` pads the batch to
a multiple of `pad_to` by repeating its last scene, and drops the pads'
outputs; every rank rolls its shard, and only rank 0 writes (the pickles,
the metrics, the VQ decode and videos) and prints — over all the scenes,
whose tokens every rank gathers.  Which scenes are done is rank 0's
reading of the token directory, so that the ranks agree on the batch.
"""

from __future__ import annotations

import os
import pickle
import time
from typing import Dict, List, Optional, Sequence

import numpy as np

from umgen_tpu_torch.config import InferConfig
from umgen_tpu_torch.data.pipeline import ScenePipeline
from umgen_tpu_torch.models.generate import Generator
from umgen_tpu_torch.ops.collision import BoxOverlap
from umgen_tpu_torch.ops.metrics import MMDMetric
from umgen_tpu_torch.runtime.profiler import annotate


def _scene_name(batch: Dict) -> str:
    return os.path.basename(str(batch.get("file_name", "scene"))).replace(
        ".pkl", "")


def _frames(arr) -> np.ndarray:
    """A scene's stream, [T, len] or [B, T, len] → [B, T, len] int64."""
    arr = np.asarray(arr)
    return (arr[None] if arr.ndim == 2 else arr).astype(np.int64)


class SceneRunner:
    def __init__(self, generator: Generator, infer_config: InferConfig,
                 output_path: str = "output/UMGen",
                 pipeline: Optional[ScenePipeline] = None,
                 map_decoder=None, image_decoder=None,
                 save_video: bool = True,
                 init_token_mod: Optional[Sequence[str]] = None,
                 gt_video: bool = True):
        """map_decoder / image_decoder: models.vq.MapDecoder / ImageDecoder,
        or None (no pictures).  init_token_mod: modalities forced to the GT
        continuation during generation (the reference's init-token replay
        for FID / MMD evaluation, ref:model_pl.py:103-130), e.g. ("map",
        "image").  gt_video: render the pred | GT side-by-side panel when
        the clip has a GT continuation (ref:model_pl.py:283-315 +
        visulize.py:1607-1633)."""
        self.gen = generator
        self.cfg = infer_config
        self.pipeline = pipeline or ScenePipeline()
        self.map_decoder = map_decoder
        self.image_decoder = image_decoder
        self.save_video = save_video
        self.init_token_mod = tuple(init_token_mod or ())
        self.gt_video = gt_video
        self.token_save_path = os.path.join(output_path, "saved_token")
        self.video_save_path = os.path.join(output_path, "video")
        mesh = getattr(generator, "mesh", None)
        # the rank that writes and prints (every other rank of a
        # data-parallel run only rolls its scenes)
        self.writer = mesh is None or mesh.rank == 0
        if self.writer:
            os.makedirs(self.token_save_path, exist_ok=True)
            os.makedirs(self.video_save_path, exist_ok=True)
        self.box_overlap = BoxOverlap()
        self.mmd = MMDMetric()
        self.timings: List[Dict] = []

    def _token_path(self, name: str) -> str:
        return os.path.join(self.token_save_path, f"{name}_tokens.pkl")

    def _done(self, names: List[str]) -> List[bool]:
        """Skip-if-exists resume (ref:model_pl.py:215-216), as rank 0 reads
        the token directory."""
        done = np.array([os.path.exists(self._token_path(n))
                         for n in names])
        mesh = getattr(self.gen, "mesh", None)
        if mesh is not None:
            done = mesh.broadcast(done.astype(np.uint8)).astype(bool)
        for name, d in zip(names, done):
            if d:
                self._print(f"{name} has been processed")
        return done.tolist()

    def _print(self, *a) -> None:
        if self.writer:
            print(*a)

    def _forced(self, cond, input_cond: int, new_frames: int):
        """init_token_mod replay: the listed modalities' GT continuation."""
        forced = {m: cond[m][:, input_cond:input_cond + new_frames]
                  for m in self.init_token_mod
                  if m in cond and cond[m].shape[1] > input_cond}
        return forced or None

    def _generate(self, cond, new_frames, input_cond, scenes, **kw):
        """The rollout of `cond`; `scenes`: how many of its rows are real
        scenes (the rest pads), which the timing counts."""
        n0 = len(self.gen.frame_seconds)
        t0 = time.perf_counter()
        with annotate("umgen.rollout"):
            out = self.gen.generate(cond, new_frames=new_frames,
                                    cond_frames=self.cfg.cond_frames,
                                    input_cond_frames=input_cond, **kw)
        dt = time.perf_counter() - t0
        per_frame = self.gen.frame_seconds[n0:]
        self.timings.append({"scenes": scenes, "frames": new_frames,
                             "seconds": dt, "frame_seconds": per_frame,
                             "frames_per_sec": scenes * new_frames / dt})
        self._print("per-frame seconds: "
                    + ", ".join(f"{s:.3f}" for s in per_frame)
                    + f"  ({scenes * new_frames / dt:.4f} frames/s over "
                    f"{scenes} scene(s))")
        return out

    def run_scene(self, batch: Dict, control_test: bool = False
                  ) -> Optional[Dict[str, np.ndarray]]:
        """One scene: rollout → save → decode → metrics.  batch: a token
        dict from the dataset (video), or a control pkl dict with
        'dataset_token' / 'control_dict' (control, ref:model_pl.py:
        132-200).  Returns the scene's tokens, None if it was done."""
        if control_test:
            gt = batch["dataset_token"]
            control = batch.get("control_dict") or {}
            name = str(batch.get("scene_name", "control_scene"))
            init = {m: _frames(v) for m, v in control.items()}
            input_cond = int(batch.get("input_cond_frame",
                                       self.cfg.input_cond_frames))
            if "no_control" in name:
                init, control_test = None, False
        else:
            gt, init = batch, None
            name = _scene_name(batch)
            input_cond = self.cfg.input_cond_frames
        if self._done([name])[0]:
            return None
        cond = {m: _frames(gt[m]) for m in self.gen.model.layout.mod_order}
        new_frames = self.cfg.num_new_frames
        if new_frames == -1:
            new_frames = cond["bbox3d"].shape[1] - input_cond
        forced = None if control_test else \
            self._forced(cond, input_cond, new_frames)
        out = self._generate(cond, new_frames, input_cond, 1,
                             init_tokens=init, control_test=control_test,
                             forced_streams=forced)
        if not self.writer:
            return None
        self._postprocess(out, gt, name, input_cond)
        return out

    def run_scenes(self, batches: List[Dict], control_test: bool = False,
                   pad_to: int = 1
                   ) -> List[Optional[Dict[str, np.ndarray]]]:
        """Stack the video scenes on the batch axis, run ONE rollout, then
        save and score each scene.  Control scenes carry their own
        trajectories and run one by one.  pad_to > 1 pads the batch by
        repeating its last scene so that a data-parallel mesh divides it;
        the pads' outputs are dropped."""
        if control_test or (len(batches) == 1 and pad_to <= 1):
            return [self.run_scene(b, control_test) for b in batches]
        named = [(_scene_name(b), b) for b in batches]
        todo = [nb for nb, done in zip(named, self._done(
            [n for n, _ in named])) if not done]
        if not todo:
            return []
        mods = self.gen.model.layout.mod_order
        input_cond = self.cfg.input_cond_frames
        T0 = min(_frames(b["pose"]).shape[1] for _, b in todo)
        cond = {m: np.concatenate([_frames(b[m])[:, :T0] for _, b in todo])
                for m in mods}
        n_pad = (-len(todo)) % pad_to
        if n_pad:
            cond = {m: np.concatenate([v] + [v[-1:]] * n_pad)
                    for m, v in cond.items()}
        new_frames = self.cfg.num_new_frames
        if new_frames == -1:
            new_frames = T0 - input_cond
        out = self._generate(
            cond, new_frames, input_cond, len(todo),
            forced_streams=self._forced(cond, input_cond, new_frames))
        if not self.writer:
            return []
        outs = []
        for i, (name, b) in enumerate(todo):
            per = {m: out[m][i:i + 1] for m in mods}
            self._postprocess(per, b, name, input_cond)
            outs.append(per)
        return outs

    def _postprocess(self, out, gt, name: str, input_cond: int) -> None:
        """Save the tokens, decode them, score the agents, render."""
        with open(self._token_path(name), "wb") as f:
            pickle.dump(out, f)
        try:
            with annotate("umgen.decode"):
                decoded = self.decode_tokens(out)
        except Exception as e:  # noqa: BLE001 — journal it, go on
            # scenes whose decode failed, for an offline re-decode (the
            # reference's undecoded_token.txt, ref:model_pl.py:343-348)
            with open(os.path.join(self.token_save_path,
                                   "undecoded_token.txt"), "a") as f:
                f.write(name + "\n")
            print(f"decode failed for {name}: {e}")
            return
        if "bbox3d" not in out:      # agent-free task: no agent metrics
            if self.save_video:
                self.render_video(decoded, name, cond_frames=input_cond)
            return
        # MMD between the generated frames and the GT continuation when the
        # clip is long enough (the paper's agent-realism metric)
        gt_bbox = _frames(gt["bbox3d"])
        if gt_bbox.shape[1] > input_cond:
            gt_boxes, gt_cats, gt_valid = self.pipeline.decode_bboxes(
                gt_bbox[0, input_cond:])
            pb, pc, pv = (decoded["boxes"][input_cond:],
                          decoded["cat_ids"][input_cond:],
                          decoded["valid"][input_cond:])
            n = min(len(gt_boxes), len(pb))
            if n > 0:
                self.mmd.update(pb[:n][pv[:n]], pc[:n][pv[:n]],
                                gt_boxes[:n][gt_valid[:n]],
                                gt_cats[:n][gt_valid[:n]])
        if self.save_video:
            self.render_video(decoded, name, cond_frames=input_cond, gt=gt)

    def decode_tokens(self, out_tokens: Dict[str, np.ndarray]) -> Dict:
        """Token streams → metric boxes, pose values and, with the VQ
        decoders, `maps_rgb` / `images` (T, H, W, 3) in [-1, 1]
        (ref:model_pl.py:357-457); adds the frames to the collision
        rate."""
        T = out_tokens["pose"].shape[1]
        if "bbox3d" in out_tokens:
            boxes, cats, valid = self.pipeline.decode_bboxes(
                out_tokens["bbox3d"][0])
        else:                        # agent-free tasks (e.g. pose_map)
            boxes = np.zeros((T, 0, 10), np.float32)
            cats = np.zeros((T, 0), np.int32)
            valid = np.zeros((T, 0), bool)
        res = {"boxes": boxes, "cat_ids": cats, "valid": valid,
               "pose": self.pipeline.decode_pose(out_tokens["pose"][0])}
        if self.map_decoder is not None and "map" in out_tokens:
            res["maps_rgb"] = self.map_decoder.decode(out_tokens["map"][0])
        if self.image_decoder is not None and "image" in out_tokens:
            res["images"] = self.image_decoder.decode(
                out_tokens["image"][0])
        self.box_overlap.update([boxes[t][valid[t]]
                                 for t in range(boxes.shape[0])])
        return res

    def render_video(self, decoded: Dict, name: str, cond_frames: int,
                     gt: Optional[Dict] = None) -> str:
        """Render the rollout's mp4, ``video/<name>.mp4``.  With `gt` (and
        gt_video on) the reference's prediction | GT side-by-side panel
        (ref:model_pl.py:283-315 + visulize.py:1607-1633), the GT maps
        decoded by the map decoder; otherwise the single-panel scene video
        (map underlay, camera panel, the GT pose where `gt` has one)."""
        from umgen_tpu_torch.tools import visualize as vz
        if not vz.HAS_CV2:
            raise RuntimeError("writing a video needs cv2, which does not "
                               "import here: run with save_video=False "
                               "(the CLI's --save_video false)")
        pose = decoded["pose"].copy()
        pose[:, 2] = pose[:, 2] * 180.0 / np.pi
        path = os.path.join(self.video_save_path, f"{name}.mp4")
        T = decoded["boxes"].shape[0]
        if gt is not None and self.gt_video and "bbox3d" in gt:
            gb, gc, gv = (_pad_to(a, T) for a in self.pipeline.decode_bboxes(
                _frames(gt["bbox3d"])[0, :T]))
            gt_maps = None
            if self.map_decoder is not None and "map" in gt:
                gt_maps = _pad_to(self.map_decoder.decode(
                    _frames(gt["map"])[0, :T]), T)
            return vz.render_pred_gt_video(
                path, decoded["boxes"], decoded["cat_ids"],
                decoded["valid"], gt_boxes=gb, gt_cats=gc, gt_valid=gv,
                pred_maps=decoded.get("maps_rgb"), gt_maps=gt_maps,
                pose=pose, cond_frames=cond_frames)
        gt_pose = None
        if gt is not None and "pose" in gt:
            gt_pose = self.pipeline.decode_pose(_frames(gt["pose"])[0])
            gt_pose[:, 2] = gt_pose[:, 2] * 180.0 / np.pi
        return vz.render_scene_video(
            path, decoded["boxes"], decoded["cat_ids"], decoded["valid"],
            pose=pose, maps_rgb=decoded.get("maps_rgb"),
            images=decoded.get("images"), cond_frames=cond_frames,
            scene_name=name, gt_pose=gt_pose)


def _pad_to(a: np.ndarray, T: int) -> np.ndarray:
    """GT shorter than the rollout: zeros (invalid boxes, black maps)
    after its end."""
    if a.shape[0] >= T:
        return a
    return np.concatenate([a, np.zeros((T - a.shape[0],) + a.shape[1:],
                                       a.dtype)])
