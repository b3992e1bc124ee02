"""Training data on the host (port of hamer_yolo_tpu/io/datasets.py): numpy
batches of fixed shapes, which the train steps move to their device.

- YOLO detection (the reference's yolov7 LoadImagesAndLabels): YOLO-format
  txt labels, the 4- and 9-image mosaics, random perspective, mixup, HSV
  jitter and the left-right flip; batches {"img": (B, S, S, 3) float32 RGB
  in [0, 1], "targets": (B, T, 5) [cls, cx, cy, w, h] in 0..1, padded with
  zero rows}.
- HaMeR crops (the reference's vitdet_dataset / datasets/utils get_example):
  a box -> an augmented square crop (scale, rotation, translation, colour,
  the EFT extreme crop) through getAffineTransform + warpAffine.
- webdataset-style tar shards without webdataset: consecutive members that
  share a basename form one sample.

Every pixel operation is cv2's arithmetic in numpy (io/images.py), byte-equal
to the cv2 the JAX package calls, so the loaders run where cv2 is missing;
cv2 is imported only to read or decode a file (``imread``, ``imdecode``).
Every random draw comes from the caller's numpy Generator, in the JAX
loaders' order, so one seed gives both packages the same batch.
"""
from __future__ import annotations

import glob
import json
import os
import tarfile
from dataclasses import dataclass
from typing import Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np

from hamer_yolo_tpu_torch.io.extreme_crop import extreme_cropping, extreme_cropping_aggressive
from hamer_yolo_tpu_torch.io.images import (affine_transform, bgr_to_hsv, hsv_to_bgr,
                                            resize_linear, rotation_matrix_2d,
                                            warp_affine_linear, warp_perspective_linear)

BORDER = 114  # the letterbox and mosaic fill


def imread(path: str) -> Optional[np.ndarray]:
    """cv2.imread (BGR uint8; None where unreadable), cv2 imported here."""
    import cv2

    return cv2.imread(path)


def imdecode(buf: bytes) -> Optional[np.ndarray]:
    """cv2.imdecode of encoded bytes into BGR uint8, cv2 imported here."""
    import cv2

    return cv2.imdecode(np.frombuffer(buf, np.uint8), cv2.IMREAD_COLOR)


# ---------------------------------------------------------------------------
# YOLO detection
# ---------------------------------------------------------------------------

@dataclass
class YoloDataConfig:
    img_size: int = 640
    max_targets: int = 64
    mosaic: bool = True
    hsv_h: float = 0.015  # hyp.scratch.p5.yaml
    hsv_s: float = 0.7
    hsv_v: float = 0.4
    fliplr: float = 0.5
    # random_perspective (hyp.scratch.p5.yaml)
    degrees: float = 0.0
    translate: float = 0.2
    scale: float = 0.9
    shear: float = 0.0
    perspective: float = 0.0
    mixup: float = 0.15


def load_yolo_labels(label_path: str) -> np.ndarray:
    """YOLO txt -> (N, 5) [cls, cx, cy, w, h], normalised; (0, 5) if absent."""
    if not os.path.exists(label_path):
        return np.zeros((0, 5), np.float32)
    rows = []
    with open(label_path) as f:
        for line in f:
            vals = line.split()
            if len(vals) >= 5:
                rows.append([float(v) for v in vals[:5]])
    return np.asarray(rows, np.float32) if rows else np.zeros((0, 5), np.float32)


def image_label_pairs(img_dir: str, label_dir: Optional[str] = None) -> List[Tuple[str, str]]:
    """(image, label txt) paths of a folder's images, sorted by name; the
    labels in ``label_dir``, by default the path with "images" -> "labels"."""
    label_dir = label_dir or img_dir.replace("images", "labels")
    pairs = []
    for f in sorted(os.listdir(img_dir)):
        if f.lower().endswith((".jpg", ".jpeg", ".png", ".bmp")):
            stem = os.path.splitext(f)[0]
            pairs.append((os.path.join(img_dir, f), os.path.join(label_dir, stem + ".txt")))
    return pairs


def augment_hsv(img: np.ndarray, rng: np.random.Generator, cfg: YoloDataConfig) -> np.ndarray:
    """Random gains on H, S and V through 256-entry tables, on uint8 BGR."""
    r = rng.uniform(-1, 1, 3) * [cfg.hsv_h, cfg.hsv_s, cfg.hsv_v] + 1
    hsv = bgr_to_hsv(img)
    x = np.arange(256)
    luts = (((x * r[0]) % 180).astype(img.dtype), np.clip(x * r[1], 0, 255).astype(img.dtype),
            np.clip(x * r[2], 0, 255).astype(img.dtype))
    return hsv_to_bgr(np.stack([lut[hsv[..., i]] for i, lut in enumerate(luts)], axis=-1))


def random_perspective(img: np.ndarray, targets: np.ndarray, rng: np.random.Generator,
                       degrees: float = 10.0, translate: float = 0.1, scale: float = 0.1,
                       shear: float = 10.0, perspective: float = 0.0,
                       border: Tuple[int, int] = (0, 0),
                       params: Optional[Tuple[float, ...]] = None
                       ) -> Tuple[np.ndarray, np.ndarray]:
    """The reference's affine / perspective jitter (datasets.py:1032-1121).

    targets (n, 5) [cls, x1, y1, x2, y2] in pixels of ``img``; ``border``
    shrinks the canvas (the mosaic's (-S/2, -S/2) cuts its 2S collage to S).
    ``params`` replaces the 8 draws (px, py, angle, scale, shear x, shear y,
    tx, ty fractions), otherwise drawn from ``rng`` in the reference's order.
    """
    height = img.shape[0] + border[0] * 2
    width = img.shape[1] + border[1] * 2
    if params is None:
        params = (rng.uniform(-perspective, perspective), rng.uniform(-perspective, perspective),
                  rng.uniform(-degrees, degrees), rng.uniform(1 - scale, 1.1 + scale),
                  rng.uniform(-shear, shear), rng.uniform(-shear, shear),
                  rng.uniform(0.5 - translate, 0.5 + translate),
                  rng.uniform(0.5 - translate, 0.5 + translate))
    px, py, a, s_, sh_x, sh_y, txf, tyf = params

    C = np.eye(3)
    C[0, 2] = -img.shape[1] / 2
    C[1, 2] = -img.shape[0] / 2
    P = np.eye(3)
    P[2, 0], P[2, 1] = px, py
    R = np.eye(3)
    R[:2] = rotation_matrix_2d((0, 0), a, s_)
    Sh = np.eye(3)
    Sh[0, 1] = np.tan(sh_x * np.pi / 180)
    Sh[1, 0] = np.tan(sh_y * np.pi / 180)
    T = np.eye(3)
    T[0, 2], T[1, 2] = txf * width, tyf * height
    M = T @ Sh @ R @ P @ C
    if border[0] != 0 or border[1] != 0 or (M != np.eye(3)).any():
        if perspective:
            img = warp_perspective_linear(img, M, (width, height), BORDER)
        else:
            img = warp_affine_linear(img, M[:2], (width, height), BORDER)

    n = len(targets)
    if n:
        xy = np.ones((n * 4, 3))
        xy[:, :2] = targets[:, [1, 2, 3, 4, 1, 4, 3, 2]].reshape(n * 4, 2)
        xy = xy @ M.T
        xy = (xy[:, :2] / xy[:, 2:3] if perspective else xy[:, :2]).reshape(n, 8)
        x, y = xy[:, [0, 2, 4, 6]], xy[:, [1, 3, 5, 7]]
        new = np.concatenate((x.min(1), y.min(1), x.max(1), y.max(1))).reshape(4, n).T
        new[:, [0, 2]] = new[:, [0, 2]].clip(0, width)
        new[:, [1, 3]] = new[:, [1, 3]].clip(0, height)
        keep = _box_candidates(targets[:, 1:5].T * s_, new.T)
        targets = targets[keep]
        targets[:, 1:5] = new[keep]
    return img, targets


def _box_candidates(box1, box2, wh_thr=2, ar_thr=20, area_thr=0.1, eps=1e-16):
    """The boxes kept after the jitter (reference datasets.py:1124-1129)."""
    w1, h1 = box1[2] - box1[0], box1[3] - box1[1]
    w2, h2 = box2[2] - box2[0], box2[3] - box2[1]
    ar = np.maximum(w2 / (h2 + eps), h2 / (w2 + eps))
    return (w2 > wh_thr) & (h2 > wh_thr) & (w2 * h2 / (w1 * h1 + eps) > area_thr) & (ar < ar_thr)


def mixup(img: np.ndarray, labels: np.ndarray, img2: np.ndarray, labels2: np.ndarray,
          rng: np.random.Generator) -> Tuple[np.ndarray, np.ndarray]:
    """A Beta(8, 8) blend of two images (float32, truncated to uint8) and
    both images' labels."""
    r = rng.beta(8.0, 8.0)
    out = (img.astype(np.float32) * r + img2.astype(np.float32) * (1 - r)).astype(img.dtype)
    return out, np.concatenate([labels, labels2], axis=0)


def _resized(path: str, S: int) -> np.ndarray:
    """An image read and resized so its longer side is S (int sides, cv2's
    INTER_LINEAR)."""
    img = imread(path)
    h0, w0 = img.shape[:2]
    r = S / max(h0, w0)
    return resize_linear(img, (int(w0 * r), int(h0 * r)))


def load_mosaic4(pairs: Sequence[Tuple[str, str]], indices: Sequence[int],
                 rng: np.random.Generator, cfg: YoloDataConfig
                 ) -> Tuple[np.ndarray, np.ndarray]:
    """The 4-image mosaic (reference datasets.py:723-780): a 2 x 2 collage
    around a random centre on a 2S canvas, the labels to pixel xyxy, then
    random_perspective with border (-S/2, -S/2) cuts it to S."""
    S = cfg.img_size
    yc, xc = (int(rng.uniform(S * 0.5, S * 1.5)) for _ in range(2))
    canvas = np.full((S * 2, S * 2, 3), BORDER, np.uint8)
    all_labels = []
    for i, idx in enumerate(indices[:4]):
        img_path, lbl_path = pairs[idx]
        img = _resized(img_path, S)
        h, w = img.shape[:2]
        if i == 0:
            x1a, y1a, x2a, y2a = max(xc - w, 0), max(yc - h, 0), xc, yc
            x1b, y1b = w - (x2a - x1a), h - (y2a - y1a)
        elif i == 1:
            x1a, y1a, x2a, y2a = xc, max(yc - h, 0), min(xc + w, S * 2), yc
            x1b, y1b = 0, h - (y2a - y1a)
        elif i == 2:
            x1a, y1a, x2a, y2a = max(xc - w, 0), yc, xc, min(S * 2, yc + h)
            x1b, y1b = w - (x2a - x1a), 0
        else:
            x1a, y1a, x2a, y2a = xc, yc, min(xc + w, S * 2), min(S * 2, yc + h)
            x1b, y1b = 0, 0
        canvas[y1a:y2a, x1a:x2a] = img[y1b:y1b + (y2a - y1a), x1b:x1b + (x2a - x1a)]
        labels = load_yolo_labels(lbl_path)
        if len(labels):
            lab = labels.copy()
            lab[:, 1] = labels[:, 1] * w + x1a - x1b
            lab[:, 2] = labels[:, 2] * h + y1a - y1b
            lab[:, 3] = labels[:, 3] * w
            lab[:, 4] = labels[:, 4] * h
            all_labels.append(lab)
    labels = np.concatenate(all_labels) if all_labels else np.zeros((0, 5), np.float32)
    if len(labels):  # xywh on the 2S canvas -> xyxy, clipped (datasets.py:763-765)
        xyxy = labels.copy()
        xyxy[:, 1] = labels[:, 1] - labels[:, 3] / 2
        xyxy[:, 2] = labels[:, 2] - labels[:, 4] / 2
        xyxy[:, 3] = labels[:, 1] + labels[:, 3] / 2
        xyxy[:, 4] = labels[:, 2] + labels[:, 4] / 2
        np.clip(xyxy[:, 1:], 0, 2 * S, out=xyxy[:, 1:])
        labels = xyxy
    canvas, labels = random_perspective(canvas, labels, rng, cfg.degrees, cfg.translate, cfg.scale,
                                        cfg.shear, cfg.perspective, border=(-S // 2, -S // 2))
    if len(labels):  # back to normalised xywh
        out = labels.copy()
        out[:, 1] = (labels[:, 1] + labels[:, 3]) / 2 / S
        out[:, 2] = (labels[:, 2] + labels[:, 4]) / 2 / S
        out[:, 3] = (labels[:, 3] - labels[:, 1]) / S
        out[:, 4] = (labels[:, 4] - labels[:, 2]) / S
        labels = out
    return canvas, labels


def load_mosaic9(pairs: Sequence[Tuple[str, str]], indices: Sequence[int],
                 rng: np.random.Generator, cfg: YoloDataConfig
                 ) -> Tuple[np.ndarray, np.ndarray]:
    """The 9-image mosaic (reference datasets.py:782+): a 3 x 3 collage on a
    3S canvas, a random S crop, the labels shifted and clipped."""
    S = cfg.img_size
    canvas = np.full((S * 3, S * 3, 3), BORDER, np.uint8)
    all_labels = []
    cells = [(r, c) for r in range(3) for c in range(3)]
    for (r, c), idx in zip(cells, indices[:9]):
        img_path, lbl_path = pairs[idx]
        img = _resized(img_path, S)
        h, w = img.shape[:2]
        y0, x0 = r * S, c * S
        canvas[y0:y0 + h, x0:x0 + w] = img
        labels = load_yolo_labels(lbl_path)
        if len(labels):
            lab = labels.copy()
            lab[:, 1] = labels[:, 1] * w + x0
            lab[:, 2] = labels[:, 2] * h + y0
            lab[:, 3] = labels[:, 3] * w
            lab[:, 4] = labels[:, 4] * h
            all_labels.append(lab)
    labels = np.concatenate(all_labels) if all_labels else np.zeros((0, 5), np.float32)
    yc = int(rng.integers(0, 2 * S))
    xc = int(rng.integers(0, 2 * S))
    crop = canvas[yc:yc + S, xc:xc + S]
    if len(labels):
        labels[:, 1] -= xc
        labels[:, 2] -= yc
        x1 = np.clip(labels[:, 1] - labels[:, 3] / 2, 0, S)
        y1 = np.clip(labels[:, 2] - labels[:, 4] / 2, 0, S)
        x2 = np.clip(labels[:, 1] + labels[:, 3] / 2, 0, S)
        y2 = np.clip(labels[:, 2] + labels[:, 4] / 2, 0, S)
        labels[:, 1] = (x1 + x2) / 2 / S
        labels[:, 2] = (y1 + y2) / 2 / S
        labels[:, 3] = (x2 - x1) / S
        labels[:, 4] = (y2 - y1) / S
        labels = labels[(labels[:, 3] > 2 / S) & (labels[:, 4] > 2 / S)]
    return crop, labels


def yolo_batch_iterator(img_dir: str, batch_size: int, cfg: Optional[YoloDataConfig] = None,
                        seed: int = 0, label_dir: Optional[str] = None
                        ) -> Iterator[Dict[str, np.ndarray]]:
    """Endless shuffled batches of fixed shapes, {"img", "targets"}."""
    cfg = cfg or YoloDataConfig()
    pairs = image_label_pairs(img_dir, label_dir)
    rng = np.random.default_rng(seed)
    S, T = cfg.img_size, cfg.max_targets
    while True:
        imgs = np.zeros((batch_size, S, S, 3), np.float32)
        targets = np.zeros((batch_size, T, 5), np.float32)
        for b in range(batch_size):
            if cfg.mosaic:
                img, labels = load_mosaic4(pairs, rng.integers(0, len(pairs), 4), rng, cfg)
                if cfg.mixup > 0 and rng.uniform() < cfg.mixup:
                    img2, labels2 = load_mosaic4(pairs, rng.integers(0, len(pairs), 4), rng, cfg)
                    img, labels = mixup(img, labels, img2, labels2, rng)
            else:
                i = int(rng.integers(0, len(pairs)))
                resized = _resized(pairs[i][0], S)
                img = np.full((S, S, 3), BORDER, np.uint8)
                img[:resized.shape[0], :resized.shape[1]] = resized
                labels = load_yolo_labels(pairs[i][1])
                if len(labels):
                    labels = labels.copy()
                    labels[:, [1, 3]] *= resized.shape[1] / S
                    labels[:, [2, 4]] *= resized.shape[0] / S
            img = augment_hsv(img, rng, cfg)
            if rng.uniform() < cfg.fliplr:
                img = img[:, ::-1]
                if len(labels):
                    labels[:, 1] = 1.0 - labels[:, 1]
            imgs[b] = img[:, :, ::-1].astype(np.float32) / 255.0  # BGR -> RGB
            n = min(len(labels), T)
            targets[b, :n] = labels[:n]
        yield {"img": imgs, "targets": targets}


# ---------------------------------------------------------------------------
# HaMeR crops
# ---------------------------------------------------------------------------

@dataclass
class HamerAugConfig:
    # the reference's configs/__init__.py DATASETS.CONFIG defaults
    scale_factor: float = 0.3
    rot_factor: float = 30.0
    trans_factor: float = 0.02
    color_scale: float = 0.2
    rot_aug_rate: float = 0.6
    do_flip: bool = False
    flip_aug_rate: float = 0.5
    # the EFT extreme crop (configs/__init__.py:66, utils.py:574-586)
    extreme_crop_aug_rate: float = 0.10
    extreme_crop_aug_level: int = 1


def hamer_training_crop(img_bgr: np.ndarray, center: np.ndarray, bbox_size: float,
                        rng: np.random.Generator, aug: Optional[HamerAugConfig] = None,
                        out_size: int = 256, mean=(0.485, 0.456, 0.406),
                        std=(0.229, 0.224, 0.225), keypoints_2d: Optional[np.ndarray] = None
                        ) -> Tuple[np.ndarray, Dict[str, float]]:
    """One augmented training crop (the reference's get_example with
    do_augmentation): (normalised RGB crop (S, S, 3) float32, the draws).
    ``keypoints_2d`` (44, 3) in pixels enables the EFT extreme crop (a
    21-point hand array never enters it), kept where its box is 4 pixels or
    more (the reference's THRESH)."""
    aug = aug or HamerAugConfig()
    tx = float(np.clip(rng.normal(), -1, 1) * aug.trans_factor)
    ty = float(np.clip(rng.normal(), -1, 1) * aug.trans_factor)
    scale = float(np.clip(rng.normal(), -1, 1) * aug.scale_factor + 1.0)
    rot = float(np.clip(rng.normal(), -2, 2) * aug.rot_factor) \
        if rng.uniform() <= aug.rot_aug_rate else 0.0
    do_flip = aug.do_flip and rng.uniform() <= aug.flip_aug_rate
    do_extreme = rng.uniform() <= aug.extreme_crop_aug_rate
    color = rng.uniform(1 - aug.color_scale, 1 + aug.color_scale, 3)

    c_x, c_y = float(center[0]), float(center[1])
    if do_extreme and keypoints_2d is not None and keypoints_2d.shape[0] >= 44:
        fn = extreme_cropping_aggressive if aug.extreme_crop_aug_level == 1 else extreme_cropping
        cx1, cy1, w1, h1 = fn(c_x, c_y, bbox_size, bbox_size, keypoints_2d, rng=rng)
        if w1 >= 4 and h1 >= 4:
            c_x, c_y, bbox_size = cx1, cy1, float(max(w1, h1))
    c_x = c_x + tx * bbox_size
    c_y = c_y + ty * bbox_size

    img = img_bgr
    if do_flip:
        img = img[:, ::-1]
        c_x = img_bgr.shape[1] - c_x - 1

    # the inference path's three-point affine
    rad = np.pi * rot / 180
    sw = bbox_size * scale

    def rot2d(p):
        return np.array([p[0] * np.cos(rad) - p[1] * np.sin(rad),
                         p[0] * np.sin(rad) + p[1] * np.cos(rad)], np.float32)

    c = np.array([c_x, c_y], np.float32)
    src = np.stack([c, c + rot2d([0, sw * 0.5]), c + rot2d([sw * 0.5, 0])])
    dst = np.array([[out_size / 2, out_size / 2], [out_size / 2, out_size],
                    [out_size, out_size / 2]], np.float32)
    patch = warp_affine_linear(np.ascontiguousarray(img), affine_transform(src, dst),
                               (out_size, out_size))
    patch = patch[:, :, ::-1].astype(np.float32)  # BGR -> RGB
    patch = np.clip(patch * color[None, None, :], 0, 255)
    patch = (patch - 255.0 * np.asarray(mean)) / (255.0 * np.asarray(std))
    return patch.astype(np.float32), {"scale": scale, "rot": rot, "do_flip": float(do_flip),
                                      "tx": tx, "ty": ty}


def aa_to_rotmat_np(aa: np.ndarray) -> np.ndarray:
    """(..., 3) axis-angle -> (..., 3, 3) float32, the port's
    geometry.rotations.aa_to_rotmat on the CPU."""
    import torch

    from hamer_yolo_tpu_torch.geometry.rotations import aa_to_rotmat

    return aa_to_rotmat(torch.from_numpy(np.ascontiguousarray(aa, np.float32))).numpy()


def hamer_batch_iterator(tar_paths: Sequence[str], batch_size: int, out_size: int = 256,
                         aug: Optional[HamerAugConfig] = None, seed: int = 0,
                         infinite: bool = True, mocap: Optional["MoCapSource"] = None
                         ) -> Iterator[Dict[str, np.ndarray]]:
    """HaMeR training batches from webdataset-style tar shards.

    A sample is <key>.jpg + <key>.json with optional keypoints_2d (21, 3),
    keypoints_3d (21, 4), mano_pose (48,) axis-angle, mano_betas (10,), the
    box's center and scale; a missing annotation gives zero confidence or
    has_mano_params 0. ``mocap`` gives the unpaired MANO samples of the
    adversarial prior; without one the batch's own are reused (a stand-in
    for smoke runs). A last batch short of ``batch_size`` (``infinite``
    False) keeps zero rows.
    """
    rng = np.random.default_rng(seed)
    aug = aug or HamerAugConfig()

    def sample_stream():
        while True:
            yield from iter_tar_samples(tar_paths)
            if not infinite:
                return

    stream = sample_stream()
    while True:
        imgs = np.zeros((batch_size, out_size, out_size, 3), np.float32)
        kp2d = np.zeros((batch_size, 21, 3), np.float32)
        kp3d = np.zeros((batch_size, 21, 4), np.float32)
        pose_aa = np.zeros((batch_size, 48), np.float32)
        betas = np.zeros((batch_size, 10), np.float32)
        has_mano = np.zeros((batch_size,), np.float32)
        got = 0
        try:
            while got < batch_size:
                _, sample = next(stream)
                if "jpg" not in sample:
                    continue
                img = imdecode(sample["jpg"])
                if img is None:
                    continue
                meta = json.loads(sample.get("json", b"{}"))
                h, w = img.shape[:2]
                center = np.asarray(meta.get("center", [w / 2, h / 2]), np.float32)
                bbox_size = float(meta.get("scale", max(h, w) / 2))
                imgs[got], _ = hamer_training_crop(img, center, bbox_size, rng, aug, out_size)
                if "keypoints_2d" in meta:
                    kp2d[got] = np.asarray(meta["keypoints_2d"], np.float32)
                if "keypoints_3d" in meta:
                    kp3d[got] = np.asarray(meta["keypoints_3d"], np.float32)
                if "mano_pose" in meta:
                    pose_aa[got] = np.asarray(meta["mano_pose"], np.float32)
                    betas[got] = np.asarray(meta.get("mano_betas", np.zeros(10)), np.float32)
                    has_mano[got] = 1.0
                got += 1
        except StopIteration:
            if got == 0:
                return
        rot = aa_to_rotmat_np(pose_aa.reshape(batch_size, 16, 3))
        if mocap is not None:
            mocap_pose, mocap_betas = mocap.sample_rotmats(batch_size, rng)
        else:
            mocap_pose, mocap_betas = rot[:, 1:], betas
        yield {"img": imgs, "keypoints_2d": kp2d, "keypoints_3d": kp3d,
               "mano_global_orient": rot[:, :1], "mano_hand_pose": rot[:, 1:],
               "mano_betas": betas, "has_mano_params": has_mano,
               "mocap_hand_pose": mocap_pose, "mocap_betas": mocap_betas}


class MoCapSource:
    """Unpaired MANO parameters for the adversarial prior (the reference's
    mocap_dataset.py): an npz with hand_pose (N, 48) axis-angle, whose
    global orient is dropped, and betas (N, 10)."""

    def __init__(self, dataset_file: str):
        data = np.load(dataset_file)
        self.pose = data["hand_pose"].astype(np.float32)[:, 3:]
        self.betas = data["betas"].astype(np.float32)
        self.length = len(self.pose)

    def __len__(self) -> int:
        return self.length

    def __getitem__(self, idx: int) -> Dict[str, np.ndarray]:
        return {"hand_pose": self.pose[idx].copy(), "betas": self.betas[idx].copy()}

    def sample_rotmats(self, n: int, rng: np.random.Generator) -> Tuple[np.ndarray, np.ndarray]:
        """n random samples: ((n, 15, 3, 3) rotation matrices, (n, 10) betas)."""
        idx = rng.integers(0, self.length, size=n)
        return aa_to_rotmat_np(self.pose[idx].reshape(n, 15, 3)), self.betas[idx]


def write_synthetic_mocap_npz(path: str, n: int = 4096, seed: int = 0) -> str:
    """A stand-in mocap pool in the reference file's schema: poses near the
    flat hand with per-joint jitter."""
    rng = np.random.default_rng(seed)
    hand_pose = np.zeros((n, 48), np.float32)
    hand_pose[:, 3:] = rng.normal(0.0, 0.25, (n, 45)).astype(np.float32)
    betas = rng.normal(0.0, 0.5, (n, 10)).astype(np.float32)
    np.savez(path, hand_pose=hand_pose, betas=betas)
    return path


def iter_tar_samples(tar_paths: Sequence[str]) -> Iterator[Tuple[str, Dict[str, bytes]]]:
    """(key, {ext: bytes}) of each run of consecutive tar members that share
    a basename, over the shards in order."""
    for path in tar_paths:
        with tarfile.open(path) as tf:
            key, sample = None, {}
            for member in tf:
                if not member.isfile():
                    continue
                base, ext = os.path.splitext(os.path.basename(member.name))
                data = tf.extractfile(member).read()
                if key is not None and base != key:
                    yield key, sample
                    sample = {}
                key = base
                sample[ext.lstrip(".")] = data
            if key is not None and sample:
                yield key, sample


# ---------------------------------------------------------------------------
# A JSON box file over a folder of images (reference hamer/datasets/json_dataset.py)
# ---------------------------------------------------------------------------

class JsonBoxDataset:
    """Images and a JSON file of xyxy boxes -> HaMeR training or eval items.

    One [x1, y1, x2, y2] per image of the sorted ``*.jpg`` of ``img_dir``;
    the reference's 200-pixel convention (center the box's midpoint, scale
    2 (xy2 - xy1) / 200, the crop's side (scale 200).max()); ``right`` the
    handedness of every item; an optional npz (hand_pose (N, 48) +
    has_hand_pose, betas (N, 10) + has_betas, hand_keypoints_2d (N, 21, 3),
    hand_keypoints_3d (N, 21, 4)) fills the MANO supervision, zeros
    otherwise. ``train`` runs the whole augmentation, otherwise every rate
    is 0 (a fixed crop).
    """

    def __init__(self, dataset_file: str, img_dir: str, right: bool = True, train: bool = False,
                 aug: Optional[HamerAugConfig] = None, out_size: int = 256,
                 annotations_npz: Optional[str] = None, seed: int = 0):
        with open(dataset_file) as f:
            boxes = np.asarray(json.load(f), np.float32)
        if boxes.ndim == 1:
            boxes = boxes[None]
        self.imgname = sorted(glob.glob(os.path.join(img_dir, "*.jpg")))
        n = len(boxes)
        self.center = (boxes[:, 2:4] + boxes[:, 0:2]) / 2.0
        self.scale = 2 * (boxes[:, 2:4] - boxes[:, 0:2]) / 200.0
        self.right = np.full(n, 1.0 if right else 0.0, np.float32)
        self.train = train
        self.out_size = out_size
        self.aug = aug or HamerAugConfig()
        if not train:
            self.aug = HamerAugConfig(scale_factor=0.0, rot_factor=0.0, trans_factor=0.0,
                                      color_scale=0.0, rot_aug_rate=0.0, do_flip=False,
                                      extreme_crop_aug_rate=0.0)
        self.rng = np.random.default_rng(seed)
        ann = np.load(annotations_npz) if annotations_npz else None

        def get(key, default):
            return ann[key].astype(np.float32) if ann is not None and key in ann else default

        self.hand_pose = get("hand_pose", np.zeros((n, 48), np.float32))
        self.has_hand_pose = get("has_hand_pose", np.zeros(n, np.float32))
        self.betas = get("betas", np.zeros((n, 10), np.float32))
        self.has_betas = get("has_betas", np.zeros(n, np.float32))
        self.keypoints_2d = get("hand_keypoints_2d", np.zeros((n, 21, 3), np.float32))
        self.keypoints_3d = get("hand_keypoints_3d", np.zeros((n, 21, 4), np.float32))

    def __len__(self) -> int:
        return len(self.scale)

    def __getitem__(self, idx: int) -> Dict[str, np.ndarray]:
        image_file = self.imgname[idx]
        center = self.center[idx].copy()
        bbox_size = float((self.scale[idx] * 200).max())
        crop, _ = hamer_training_crop(imread(image_file), center, bbox_size, self.rng, self.aug,
                                      self.out_size,
                                      keypoints_2d=self.keypoints_2d[idx] if self.train else None)
        hand_pose = self.hand_pose[idx]
        return {
            "img": crop,
            "keypoints_2d": self.keypoints_2d[idx].copy(),
            "keypoints_3d": self.keypoints_3d[idx].copy(),
            "orig_keypoints_2d": self.keypoints_2d[idx].copy(),
            "box_center": center,
            "box_size": np.float32(bbox_size),
            "mano_params": {"global_orient": hand_pose[:3].copy(),
                            "hand_pose": hand_pose[3:].copy(),
                            "betas": self.betas[idx].copy()},
            "has_mano_params": {"global_orient": self.has_hand_pose[idx].copy(),
                                "hand_pose": self.has_hand_pose[idx].copy(),
                                "betas": self.has_betas[idx].copy()},
            "right": self.right[idx].copy(),
            "imgname": image_file,
            "personid": np.int32(idx),
            "idx": np.int32(idx),
        }
