"""Camera-image loading transforms (host-side, numpy/cv2).

Rebuild of ref:plugin/data/transforms/loading.py — only active when the
dataset is asked for original camera images (``return_ori_image=True``,
which both reference eval tasks leave off, ref:infer_fun.py:174,180,187).
Kept for parity with the reference transform zoo; implemented with
numpy/cv2 instead of PIL/torchvision.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import numpy as np

try:
    import cv2
    HAS_CV2 = True
except Exception:          # pragma: no cover
    HAS_CV2 = False


class LoadMultiViewImageFromFiles:
    """results["img_filename"] (list of paths) → results["img"] (list of
    (H, W, C) arrays) + shape/scale metadata (ref:loading.py:9-73)."""

    def __init__(self, to_float32: bool = False,
                 color_type: str = "unchanged"):
        self.to_float32 = to_float32
        self.color_type = color_type

    def __call__(self, results: Dict) -> Dict:
        flag = (cv2.IMREAD_UNCHANGED if self.color_type == "unchanged"
                else cv2.IMREAD_COLOR)
        imgs = [cv2.imread(name, flag) for name in results["img_filename"]]
        img = np.stack(imgs, axis=-1)
        if self.to_float32:
            img = img.astype(np.float32)
        results["filename"] = results["img_filename"]
        results["img"] = [img[..., i] for i in range(img.shape[-1])]
        results["img_shape"] = img.shape
        results["ori_shape"] = img.shape
        results["pad_shape"] = img.shape
        results["scale_factor"] = 1.0
        num_ch = 1 if img.ndim < 3 else img.shape[2]
        results["img_norm_cfg"] = dict(
            mean=np.zeros(num_ch, np.float32),
            std=np.ones(num_ch, np.float32), to_rgb=False)
        return results


class ResizeCropFlipRotImage:
    """Resize → crop → optional flip/rotate augmentation; folds the 2D
    image-domain transform (ida matrix) into the camera intrinsics
    (ref:loading.py:75-190).

    data_aug_conf keys: final_dim (h, w), resize_lim (lo, hi),
    bot_pct_lim (lo, hi), rand_flip (bool), rot_lim (lo, hi) degrees,
    and a boolean ``train`` flag on the call deciding sample-vs-mean.
    """

    def __init__(self, data_aug_conf: Optional[Dict] = None,
                 intrinsics: bool = True, no_crop: bool = False,
                 train: bool = False, rng: Optional[np.random.Generator]
                 = None):
        self.conf = data_aug_conf or {
            "final_dim": (256, 512), "resize_lim": (1.0, 1.0),
            "bot_pct_lim": (0.0, 0.0), "rand_flip": False,
            "rot_lim": (0.0, 0.0)}
        self.intrinsics = intrinsics
        self.no_crop = no_crop
        self.train = train
        self.rng = rng or np.random.default_rng(0)

    def _sample(self, H: int, W: int):
        fH, fW = self.conf["final_dim"]
        if self.train:
            resize = self.rng.uniform(*self.conf["resize_lim"])
            resize_dims = (int(W * resize), int(H * resize))
            nW, nH = resize_dims
            crop_h = int((1 - self.rng.uniform(*self.conf["bot_pct_lim"]))
                         * nH) - fH
            crop_w = int(self.rng.uniform(0, max(0, nW - fW)))
            flip = bool(self.conf["rand_flip"] and self.rng.random() < 0.5)
            rotate = self.rng.uniform(*self.conf["rot_lim"])
        else:
            resize = max(fH / H, fW / W)
            resize_dims = (int(W * resize), int(H * resize))
            nW, nH = resize_dims
            crop_h = int((1 - np.mean(self.conf["bot_pct_lim"])) * nH) - fH
            crop_w = int(max(0, nW - fW) / 2)
            flip, rotate = False, 0.0
        crop = (crop_w, max(0, crop_h), crop_w + fW, max(0, crop_h) + fH)
        return resize, resize_dims, crop, flip, rotate

    def __call__(self, results: Dict) -> Dict:
        imgs = results["img"]
        H, W = imgs[0].shape[:2]
        resize, resize_dims, crop, flip, rotate = self._sample(H, W)
        fW = crop[2] - crop[0]
        fH = crop[3] - crop[1]
        new_imgs = []
        for i, img in enumerate(imgs):
            im = cv2.resize(np.uint8(img), resize_dims)
            if not self.no_crop:
                im = im[crop[1]:crop[3], crop[0]:crop[2]]
            ida = np.eye(3, dtype=np.float32)
            ida[:2, :2] *= resize
            ida[0, 2] -= crop[0]
            ida[1, 2] -= crop[1]
            if flip:
                im = im[:, ::-1]
                F = np.array([[-1, 0, fW], [0, 1, 0], [0, 0, 1]],
                             np.float32)
                ida = F @ ida
            if abs(rotate) > 1e-6:
                M = cv2.getRotationMatrix2D((fW / 2, fH / 2), rotate, 1.0)
                im = cv2.warpAffine(im, M, (fW, fH))
                R = np.vstack([M, [0, 0, 1]]).astype(np.float32)
                ida = R @ ida
            new_imgs.append(im)
            if self.intrinsics and "intrinsics" in results:
                K = np.asarray(results["intrinsics"][i], np.float32)
                K[:3, :3] = ida @ K[:3, :3]
                results["intrinsics"][i] = K
        results["img"] = new_imgs
        results["ida_mat"] = None   # folded into intrinsics (ref:108-111)
        return results


class ToTensorCollect:
    """Collect the listed keys as contiguous float arrays; images stacked
    (N, C, H, W) like the reference's ToTensor_Collect
    (ref:loading.py torchvision path)."""

    def __init__(self, keys: Sequence[str] = ("img",)):
        self.keys = tuple(keys)

    def __call__(self, results: Dict) -> Dict:
        for k in self.keys:
            v = results.get(k)
            if v is None:
                continue
            if isinstance(v, list):
                v = np.stack([np.asarray(x, np.float32) for x in v])
                if v.ndim == 4:              # (N, H, W, C) → (N, C, H, W)
                    v = v.transpose(0, 3, 1, 2)
            results[k] = np.ascontiguousarray(v)
        return results
