"""HaMeR's extreme-cropping augmentation (port of
hamer_yolo_tpu/io/extreme_crop.py; the reference's
hamer/hamer/datasets/utils.py:648-1010), numpy on the host.

Given 2D keypoints in the 25 OpenPose + 19 extra convention, each crop
variant zeroes a subset of the keypoints and derives the box from those
left; ``extreme_cropping`` and ``extreme_cropping_aggressive`` pick a
variant when the visible keypoints show a full or an upper body, drawing
their one uniform from the caller's numpy Generator, as JAX's do.
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np

# keypoints zeroed per variant + box rescale factor (utils.py:648-884)
_CROP_TABLE = {
    "hips": ([10, 11, 13, 14, 19, 20, 21, 22, 23, 24,
              25 + 0, 25 + 1, 25 + 4, 25 + 5], 1.1),
    "shoulders": ([3, 4, 6, 7, 8, 9, 10, 11, 12, 13, 14, 19, 20, 21, 22, 23,
                   24] + [25 + i for i in
                          [0, 1, 2, 3, 4, 5, 6, 7, 10, 11, 14, 15, 16]], 1.2),
    "head": ([3, 4, 6, 7, 8, 9, 10, 11, 12, 13, 14, 19, 20, 21, 22, 23, 24]
             + [25 + i for i in
                [0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 14, 15, 16]], 1.3),
    "torso": ([0, 3, 4, 6, 7, 10, 11, 13, 14, 15, 16, 17, 18, 19, 20, 21, 22,
               23, 24] + [25 + i for i in
                          [0, 1, 4, 5, 6, 7, 10, 11, 13, 17, 18]], 1.1),
    "rightarm": ([0, 1, 5, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16, 17, 18, 19,
                  20, 21, 22, 23, 24]
                 + [25 + i for i in
                    [0, 1, 2, 3, 4, 5, 9, 10, 11, 12, 13, 14, 15, 16, 17, 18]],
                 1.1),
    "leftarm": ([0, 1, 2, 3, 4, 8, 9, 10, 11, 12, 13, 14, 15, 16, 17, 18, 19,
                 20, 21, 22, 23, 24]
                + [25 + i for i in
                   [0, 1, 2, 3, 4, 5, 6, 7, 8, 12, 13, 14, 15, 16, 17, 18]],
                1.1),
    "legs": ([0, 1, 2, 3, 4, 5, 6, 7, 15, 16, 17, 18]
             + [25 + i for i in [6, 7, 8, 9, 10, 11, 12, 13, 15, 16, 17, 18]],
             1.1),
    "rightleg": ([0, 1, 2, 3, 4, 5, 6, 7, 8, 12, 13, 14, 15, 16, 17, 18, 19,
                  20, 21] + [25 + i for i in
                             [3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16,
                              17, 18]], 1.1),
    "leftleg": ([0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 15, 16, 17, 18, 22, 23,
                 24] + [25 + i for i in
                        [0, 1, 2, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16, 17,
                         18]], 1.1),
}


def get_bbox(keypoints_2d: np.ndarray, rescale: float = 1.2):
    """Center/scale from visible keypoints (utils.py:912-929)."""
    valid = keypoints_2d[:, -1] > 0
    pts = keypoints_2d[valid][:, :-1]
    center = 0.5 * (pts.max(axis=0) + pts.min(axis=0))
    scale = (pts.max(axis=0) - pts.min(axis=0)) * rescale
    return center, scale


def crop_variant(name: str, center_x, center_y, width, height,
                 keypoints_2d: np.ndarray) -> Tuple:
    """One crop_to_* / crop_*_only variant from the table."""
    zero_idx, factor = _CROP_TABLE[name]
    kp = keypoints_2d.copy()
    kp[zero_idx, :] = 0
    if kp[:, -1].sum() > 1:
        center, scale = get_bbox(kp)
        center_x, center_y = center[0], center[1]
        width, height = factor * scale[0], factor * scale[1]
    return center_x, center_y, width, height


def full_body(keypoints_2d: np.ndarray) -> bool:
    """utils.py:884-895."""
    op = [2, 3, 4, 5, 6, 7, 10, 11, 13, 14]
    extra = [25 + i for i in [8, 7, 6, 9, 10, 11, 1, 0, 4, 5]]
    return (np.maximum(keypoints_2d[extra, -1],
                       keypoints_2d[op, -1]) > 0).sum() == len(extra)


def upper_body(keypoints_2d: np.ndarray) -> bool:
    """utils.py:897-910."""
    lower_op = [10, 11, 13, 14]
    lower = [25 + i for i in [1, 0, 4, 5]]
    upper_op = [0, 1, 15, 16, 17, 18]
    upper = [25 + 8, 25 + 9, 25 + 12, 25 + 13, 25 + 17, 25 + 18]
    return ((keypoints_2d[lower + lower_op, -1] > 0).sum() == 0) \
        and ((keypoints_2d[upper + upper_op, -1] > 0).sum() >= 2)


def extreme_cropping(center_x, center_y, width, height,
                     keypoints_2d: np.ndarray,
                     p: Optional[float] = None,
                     rng: Optional[np.random.Generator] = None) -> Tuple:
    """utils.py:931-961 (p replaces the torch.rand draw)."""
    if p is None:
        p = float((rng or np.random.default_rng()).uniform())
    if full_body(keypoints_2d):
        if p < 0.7:
            out = crop_variant("hips", center_x, center_y, width, height, keypoints_2d)
        elif p < 0.9:
            out = crop_variant("shoulders", center_x, center_y, width, height, keypoints_2d)
        else:
            out = crop_variant("head", center_x, center_y, width, height, keypoints_2d)
    elif upper_body(keypoints_2d):
        if p < 0.9:
            out = crop_variant("shoulders", center_x, center_y, width, height, keypoints_2d)
        else:
            out = crop_variant("head", center_x, center_y, width, height, keypoints_2d)
    else:
        out = (center_x, center_y, width, height)
    cx, cy, w, h = out
    return cx, cy, max(w, h), max(w, h)


_AGGRESSIVE_FULL = ["hips", "shoulders", "head", "torso", "rightarm",
                    "leftarm", "legs", "rightleg", "leftleg"]
_AGGRESSIVE_UPPER = ["shoulders", "head", "torso", "rightarm", "leftarm"]


def extreme_cropping_aggressive(center_x, center_y, width, height,
                                keypoints_2d: np.ndarray,
                                p: Optional[float] = None,
                                rng: Optional[np.random.Generator] = None
                                ) -> Tuple:
    """utils.py:963-1010: 9 variants at 0.1 steps (full body) or
    5 at 0.2 steps (upper body)."""
    if p is None:
        p = float((rng or np.random.default_rng()).uniform())
    if full_body(keypoints_2d):
        # thresholds 0.2, 0.3, ..., 0.9 (the first bin is twice as wide)
        idx = int(np.searchsorted([0.2, 0.3, 0.4, 0.5, 0.6, 0.7, 0.8, 0.9], p,
                                  side="right"))
        out = crop_variant(_AGGRESSIVE_FULL[idx], center_x, center_y, width,
                           height, keypoints_2d)
    elif upper_body(keypoints_2d):
        idx = int(np.searchsorted([0.2, 0.4, 0.6, 0.8], p, side="right"))
        out = crop_variant(_AGGRESSIVE_UPPER[idx], center_x, center_y, width,
                           height, keypoints_2d)
    else:
        out = (center_x, center_y, width, height)
    cx, cy, w, h = out
    return cx, cy, max(w, h), max(w, h)
