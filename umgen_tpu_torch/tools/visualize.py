"""BEV scene visualization and video output.

Compact rebuild of the reference visualizer (ref:projects/tools/visulize.py):
a 512×512 BEV canvas per frame with the VQ-decoded map raster underlay,
rotated agent rectangles with heading/speed arrows, the ego box, and a
frame/pose text overlay; frames optionally stacked with the decoded
front-camera panel and written to mp4 with cv2.

This file is the port's own copy of umgen_tpu/tools/visualize.py (the port
imports nothing of the JAX package); only the imports differ, and
tests/test_torch_import.py holds its constants and a rendered frame to the
original's.  It imports without cv2, but draws nothing without it: the CLI
refuses `--save_video` where cv2 does not import.
"""

from __future__ import annotations

import os
from typing import Dict, List, Optional, Sequence

import numpy as np

try:
    import cv2
    HAS_CV2 = True
except Exception:          # pragma: no cover
    HAS_CV2 = False

CANVAS = 512
METERS = 128.0             # BEV extent: ±64 m
SCALE = CANVAS / METERS

CATEGORY_COLORS = {
    0: (80, 170, 255),     # vehicle
    1: (90, 230, 120),     # bicycle
    2: (250, 200, 60),     # pedestrian
}
EGO_COLOR = (60, 60, 240)
# colliding boxes are drawn pink, small (<~1 m side) boxes orange —
# matching the reference's draw_box coloring (ref:visulize.py:896-909)
COLLISION_COLOR = (255, 0, 255)
SMALL_BOX_COLOR = (0, 165, 255)
ID_COLOR = (0, 255, 0)


def _to_px(xy: np.ndarray) -> np.ndarray:
    """metric BEV (x forward/up, y left) → pixel coords (reference
    convention: ego centered, x up, ref:visulize.py draw_box)."""
    px = CANVAS / 2 - xy[..., 1] * SCALE
    py = CANVAS / 2 - xy[..., 0] * SCALE
    return np.stack([px, py], axis=-1)


def _box_corners(box: np.ndarray) -> np.ndarray:
    """(10,) metric box → (4, 2) BEV corners."""
    x, y, l, w, yaw = box[0], box[1], box[3], box[4], box[6]
    base = np.array([[-0.5, -0.5], [-0.5, 0.5], [0.5, 0.5], [0.5, -0.5]])
    c, s = np.cos(yaw), np.sin(yaw)
    rot = np.array([[c, -s], [s, c]])
    return (base * [l, w]) @ rot.T + [x, y]


def render_frame(boxes: Optional[np.ndarray] = None,
                 cat_ids: Optional[np.ndarray] = None,
                 valid: Optional[np.ndarray] = None,
                 map_rgb: Optional[np.ndarray] = None,
                 collision_ids: Optional[Sequence[int]] = None,
                 draw_ego: bool = True,
                 arrows: bool = True,
                 object_ids: Optional[np.ndarray] = None,
                 show_ids: bool = True) -> np.ndarray:
    """→ (512, 512, 3) uint8 BGR canvas.

    Reference coloring parity (ref:visulize.py:813-967): colliding boxes
    pink, boxes under ~1 m side orange, slot/object id printed at each
    box's top-left corner (object_ids; defaults to the slot index)."""
    if map_rgb is not None:
        img = np.clip((np.asarray(map_rgb) + 1) / 2 * 255, 0,
                      255).astype(np.uint8)
        img = cv2.resize(img, (CANVAS, CANVAS),
                         interpolation=cv2.INTER_NEAREST)
        if img.ndim == 2:
            img = np.repeat(img[..., None], 3, -1)
    else:
        img = np.full((CANVAS, CANVAS, 3), 30, np.uint8)

    collision_ids = set(collision_ids or [])
    if boxes is not None:
        boxes = np.asarray(boxes)
        n = boxes.shape[0]
        for i in range(n):
            if valid is not None and not valid[i]:
                continue
            pts = _to_px(_box_corners(boxes[i])).astype(np.int32)
            l_px = boxes[i, 3] * SCALE
            w_px = boxes[i, 4] * SCALE
            if i in collision_ids:
                color = COLLISION_COLOR
            elif l_px < 4 or w_px < 4:     # ref:visulize.py:906-907
                color = SMALL_BOX_COLOR
            else:
                color = CATEGORY_COLORS.get(
                    int(cat_ids[i]) if cat_ids is not None else 0,
                    (200, 200, 200))
            cv2.polylines(img, [pts], True, color, 2)
            if arrows:
                vx, vy = boxes[i, 7], boxes[i, 8]
                speed = float(np.hypot(vx, vy))
                if speed > 0.2:
                    start = _to_px(boxes[i, :2][None])[0]
                    end = _to_px((boxes[i, :2] +
                                  np.array([vx, vy]))[None])[0]
                    cv2.arrowedLine(img, tuple(start.astype(int)),
                                    tuple(end.astype(int)), color, 1,
                                    tipLength=0.3)
            if show_ids:
                oid = int(object_ids[i]) if object_ids is not None else i
                corner = pts.min(axis=0)
                cv2.putText(img, str(oid),
                            (int(corner[0]), int(corner[1]) - 4),
                            cv2.FONT_HERSHEY_SIMPLEX, 0.35, ID_COLOR, 1)

    if draw_ego:
        ego = np.array([0, 0, 0, 5.176, 2.297, 1.777, 0, 0, 0, 0])
        pts = _to_px(_box_corners(ego)).astype(np.int32)
        cv2.fillPoly(img, [pts], EGO_COLOR)
    return img


def put_header(img: np.ndarray, frame_idx: int, cond_frames: int,
               pose: Optional[np.ndarray] = None,
               gt_pose: Optional[np.ndarray] = None,
               scene_name: Optional[str] = None,
               n_boxes: Optional[int] = None,
               gt_n_boxes: Optional[int] = None,
               project: str = "umgen_tpu") -> np.ndarray:
    """Per-frame info overlay carrying the reference's information
    classes (ref:visulize.py:969-1078 put_text): frame index + box
    counts, project, scene name, predicted pose, GT pose.  Red while
    conditioning, white when generated (the reference's color switch)."""
    color = (0, 0, 255) if frame_idx < cond_frames else (255, 255, 255)
    img = img.copy()
    lines = []
    head = f"Frame {frame_idx}"
    if n_boxes is not None or gt_n_boxes is not None:
        head += f": pbox={n_boxes if n_boxes is not None else 0}" \
                f", abox={gt_n_boxes if gt_n_boxes is not None else 0}"
    lines.append(head)
    lines.append(f"Project: {project}")
    if scene_name is not None:
        lines.append(f"Scene: {scene_name}")
    if pose is not None:
        p = np.asarray(pose, np.float64)
        lines.append(f"Pose: ({p[0]:.2f}, {p[1]:.2f}, {p[2]:.2f})")
    if gt_pose is not None:
        g = np.asarray(gt_pose, np.float64)
        lines.append(f"GTPose: ({g[0]:.2f}, {g[1]:.2f}, {g[2]:.2f})")
    elif pose is not None and scene_name is not None:
        lines.append("GTPose: out of annotaion")   # sic, ref:1060
    for i, text in enumerate(lines):
        cv2.putText(img, text, (10, 20 + 16 * i),
                    cv2.FONT_HERSHEY_SIMPLEX, 0.45, color, 1)
    return img


def stack_panels(*panels: Optional[np.ndarray]) -> np.ndarray:
    """Vertically stack equal-width panels (ref:visulize.py:1202-1259)."""
    ps = [p for p in panels if p is not None]
    width = max(p.shape[1] for p in ps)
    resized = []
    for p in ps:
        if p.shape[1] != width:
            h = int(round(p.shape[0] * width / p.shape[1]))
            p = cv2.resize(p, (width, h))
        resized.append(p)
    return np.concatenate(resized, axis=0)


def write_video(frames: Sequence[np.ndarray], path: str,
                fps: int = 10) -> str:
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    h, w = frames[0].shape[:2]
    out = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*"mp4v"), fps,
                          (w, h))
    for f in frames:
        out.write(f)
    out.release()
    return path


def render_scene_video(path: str,
                       boxes: np.ndarray, cat_ids: np.ndarray,
                       valid: np.ndarray,
                       pose: Optional[np.ndarray] = None,
                       maps_rgb: Optional[np.ndarray] = None,
                       images: Optional[np.ndarray] = None,
                       cond_frames: int = 20, fps: int = 10,
                       scene_name: Optional[str] = None,
                       gt_pose: Optional[np.ndarray] = None) -> str:
    """Full scene → mp4.  boxes (T, 60, 10) metric, valid (T, 60),
    maps_rgb (T, h, w, 3) in [-1, 1], images (T, h, w, 3) in [-1, 1]."""
    frames = []
    T = boxes.shape[0]
    for t in range(T):
        bev = render_frame(boxes[t], cat_ids[t], valid[t],
                           maps_rgb[t] if maps_rgb is not None else None)
        bev = put_header(bev, t, cond_frames,
                         pose[t] if pose is not None else None,
                         gt_pose=(gt_pose[t] if gt_pose is not None
                                  and t < len(gt_pose) else None),
                         scene_name=scene_name,
                         n_boxes=int(valid[t].sum()))
        cam = None
        if images is not None:
            cam = np.clip((images[t] + 1) / 2 * 255, 0, 255).astype(np.uint8)
        frames.append(stack_panels(cam, bev))
    return write_video(frames, path, fps)


# ---------------------------------------------------------------------------
# token / polyline panels (ref:visulize.py:1261-1339,1341-1394)
# ---------------------------------------------------------------------------
WAYMO_POINT_COLORS = {
    # lane centers red, boundaries/road lines white, crosswalk etc. cyan
    -1: (255, 0, 0), 1: (255, 0, 0), 2: (255, 0, 0), 3: (255, 0, 0),
    0: (255, 255, 255), 4: (255, 255, 255), 5: (255, 255, 255),
    6: (255, 255, 255), 7: (255, 255, 255), 8: (255, 255, 255),
    9: (255, 255, 255), 10: (255, 255, 255), 11: (255, 255, 255),
    12: (255, 255, 255), 13: (255, 255, 255), 14: (255, 255, 255),
    15: (0, 255, 255), 16: (0, 255, 255), 17: (0, 255, 255),
    18: (0, 255, 255), 19: (0, 255, 255),
}


def draw_tokens(tokens: np.ndarray, H: int = 32, W: int = 32,
                base_images: Optional[Sequence[np.ndarray]] = None,
                scale: int = 5) -> List[np.ndarray]:
    """Token-id inspection panel: each frame's (H*W,) token grid printed as
    text on a canvas (ref:visulize.py:1261-1339)."""
    tokens = np.asarray(tokens).reshape(-1, H, W)
    cell = int(CANVAS / H * scale)
    out = []
    for k in range(tokens.shape[0]):
        if base_images is not None:
            img = base_images[k].copy()
        else:
            img = np.full((CANVAS * scale // 1, CANVAS * scale // 1, 3), 30,
                          np.uint8)
        for i in range(H):
            for j in range(W):
                cv2.putText(img, str(int(tokens[k, i, j])),
                            (j * cell + 2, i * cell + 10),
                            cv2.FONT_HERSHEY_SIMPLEX, 0.3, (0, 0, 255), 1)
        out.append(img)
    return out


def draw_point_map(map_polylines: np.ndarray,
                   base_images: Optional[Sequence[np.ndarray]] = None
                   ) -> List[np.ndarray]:
    """Waymo polyline-map mode: per frame, scatter map points onto the BEV
    canvas colored by point type; only background pixels are painted
    (ref:visulize.py:1341-1394).

    map_polylines: (T, n_lines, n_pts, >=7) rows
    [x, y, z, dir_x, dir_y, dir_z, type, ...].
    """
    out = []
    for frame in range(map_polylines.shape[0]):
        img = (base_images[frame].copy() if base_images is not None
               else np.full((CANVAS, CANVAS, 3), 30, np.uint8))
        for line in map_polylines[frame]:
            xy = line[:, :2]
            ptype = line[:, -3] if line.shape[1] >= 7 else line[:, -1]
            m = (np.abs(xy[:, 0]) < 64) & (np.abs(xy[:, 1]) < 64)
            for (x, y), t in zip(xy[m], ptype[m]):
                px = int((-x + 64) * SCALE)
                py = int((-y + 64) * SCALE)
                col = WAYMO_POINT_COLORS.get(int(t), (255, 255, 255))
                if np.all(img[px, py] == 30) or np.all(img[px, py] == 0):
                    img[px, py] = col
        out.append(img)
    return out


# ---------------------------------------------------------------------------
# PNG cache + video assembly (ref:visulize.py:61-75,1080-1120,1396-1498)
# ---------------------------------------------------------------------------
def save_frame_pngs(frames: Sequence[np.ndarray], folder: str) -> List[str]:
    """Write frames as <i>.png (the reference renders to a PNG cache first,
    ref:visulize.py:1080-1120)."""
    os.makedirs(folder, exist_ok=True)
    paths = []
    for i, f in enumerate(frames):
        p = os.path.join(folder, f"{i}.png")
        cv2.imwrite(p, f)
        paths.append(p)
    return paths


def create_video_from_images(image_folder: str, video_path: str,
                             fps: int = 5) -> str:
    """PNG cache dir (numeric names) → mp4 (ref:visulize.py:61-75)."""
    import glob
    images = sorted(glob.glob(os.path.join(image_folder, "*.png")),
                    key=lambda x: int(os.path.splitext(
                        os.path.basename(x))[0]))
    return write_video([cv2.imread(p) for p in images], video_path, fps)


def render_pred_gt_video(path: str,
                         pred_boxes: np.ndarray, pred_cats: np.ndarray,
                         pred_valid: np.ndarray,
                         gt_boxes: Optional[np.ndarray] = None,
                         gt_cats: Optional[np.ndarray] = None,
                         gt_valid: Optional[np.ndarray] = None,
                         pred_maps: Optional[np.ndarray] = None,
                         gt_maps: Optional[np.ndarray] = None,
                         pose: Optional[np.ndarray] = None,
                         cond_frames: int = 20, fps: int = 10,
                         png_cache: Optional[str] = None,
                         mark_collisions: bool = True) -> str:
    """Side-by-side prediction | ground-truth BEV video with per-frame
    collision highlighting — the reference's ``visulize_objects_in_image``
    + ``vis_pred_video`` flow (ref:visulize.py:293-422,1607-1633)."""
    from umgen_tpu_torch.ops.collision import collision_matrix
    T = pred_boxes.shape[0]
    frames = []
    for t in range(T):
        cids = None
        if mark_collisions:
            act = pred_boxes[t][pred_valid[t].astype(bool)]
            mat = collision_matrix(act)
            hit = np.where(mat.any(axis=1))[0]
            live = np.where(pred_valid[t].astype(bool))[0]
            cids = live[hit].tolist()
        gt_n = (int(gt_valid[t].sum()) if gt_valid is not None
                and t < len(gt_valid) else None)
        left = render_frame(pred_boxes[t], pred_cats[t], pred_valid[t],
                            pred_maps[t] if pred_maps is not None else None,
                            collision_ids=cids)
        left = put_header(left, t, cond_frames,
                          pose[t] if pose is not None else None,
                          n_boxes=int(pred_valid[t].sum()),
                          gt_n_boxes=gt_n)
        if gt_boxes is not None:
            right = render_frame(gt_boxes[t], gt_cats[t],
                                 gt_valid[t] if gt_valid is not None
                                 else None,
                                 gt_maps[t] if gt_maps is not None else None)
            right = cv2.putText(right, "GT", (10, 20),
                                cv2.FONT_HERSHEY_SIMPLEX, 0.45,
                                (0, 255, 0), 1)
            frame = np.concatenate([left, right], axis=1)
        else:
            frame = left
        frames.append(frame)
    if png_cache:
        save_frame_pngs(frames, png_cache)
    return write_video(frames, path, fps)


def merge_video_with_images(video_path: str, images: np.ndarray,
                            out_path: str, start_index: int = 10,
                            image_text: str = "decoded") -> str:
    """Append a decoded-image panel under an existing rollout video
    (ref:visulize.py:1396-1498 merage_image_to_video): frames before
    `start_index` show a black panel, after it the corresponding image."""
    cap = cv2.VideoCapture(video_path)
    if not cap.isOpened():
        raise FileNotFoundError(video_path)
    vw = int(cap.get(cv2.CAP_PROP_FRAME_WIDTH))
    fps = cap.get(cv2.CAP_PROP_FPS) or 10
    images = np.asarray(images)
    if images.dtype != np.uint8:
        images = np.clip((images + 1) / 2 * 255, 0, 255).astype(np.uint8)
    frames = []
    idx = 0
    while True:
        ok, frame = cap.read()
        if not ok:
            break
        j = idx - start_index
        if 0 <= j < len(images):
            panel = images[j]
        else:
            panel = np.zeros_like(images[0])
        if panel.shape[1] != vw:
            h = int(round(panel.shape[0] * vw / panel.shape[1]))
            panel = cv2.resize(panel, (vw, h))
        panel = cv2.putText(panel.copy(), image_text, (10, 20),
                            cv2.FONT_HERSHEY_SIMPLEX, 0.45, (0, 255, 0), 1)
        frames.append(np.concatenate([frame, panel], axis=0))
        idx += 1
    cap.release()
    return write_video(frames, out_path, int(fps))
