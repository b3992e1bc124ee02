"""Visualization on the host (port of hamer_yolo_tpu/utils/viz.py, numpy
and cv2, cv2 imported where it draws): the 21-keypoint OpenPose hand
skeleton with a colour per finger, the detection box with its filled label
tag (the reference's plot_one_box), a flat-shaded painter's-algorithm mesh
overlay, a grid of crops with their skeletons, and a frame's detections in
one image. The same numpy and cv2 calls as the JAX package's, so the same
pixels.
"""
from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np

# OpenPose 21-joint hand skeleton (wrist -> 4 joints per finger).
HAND_SKELETON = (
    (0, 1), (1, 2), (2, 3), (3, 4),        # thumb
    (0, 5), (5, 6), (6, 7), (7, 8),        # index
    (0, 9), (9, 10), (10, 11), (11, 12),   # middle
    (0, 13), (13, 14), (14, 15), (15, 16),  # ring
    (0, 17), (17, 18), (18, 19), (19, 20),  # pinky
)

FINGER_COLORS = (
    (0, 0, 255), (0, 165, 255), (0, 255, 255), (0, 255, 0), (255, 0, 0)
)


def draw_hand_skeleton(
    image_bgr: np.ndarray,
    keypoints_2d: np.ndarray,
    valid: Optional[np.ndarray] = None,
    radius: int = 3,
    thickness: int = 2,
) -> np.ndarray:
    """Draw a 21-keypoint hand skeleton; keypoints (21, 2) pixel coords."""
    import cv2

    out = image_bgr.copy()
    kp = keypoints_2d.astype(int)
    for ei, (a, b) in enumerate(HAND_SKELETON):
        if valid is not None and not (valid[a] and valid[b]):
            continue
        color = FINGER_COLORS[ei // 4]
        cv2.line(out, tuple(kp[a]), tuple(kp[b]), color, thickness)
    for j in range(len(kp)):
        if valid is not None and not valid[j]:
            continue
        cv2.circle(out, tuple(kp[j]), radius, (255, 255, 255), -1)
    return out


def plot_box(
    image_bgr: np.ndarray,
    box_xyxy: Sequence[float],
    label: Optional[str] = None,
    color: Tuple[int, int, int] = (0, 200, 0),
    thickness: int = 2,
) -> np.ndarray:
    """plot_one_box equivalent: rectangle + filled label tag."""
    import cv2

    out = image_bgr.copy()
    p1 = (int(box_xyxy[0]), int(box_xyxy[1]))
    p2 = (int(box_xyxy[2]), int(box_xyxy[3]))
    cv2.rectangle(out, p1, p2, color, thickness)
    if label:
        (tw, th), _ = cv2.getTextSize(label, cv2.FONT_HERSHEY_SIMPLEX, 0.5, 1)
        cv2.rectangle(out, p1, (p1[0] + tw, p1[1] - th - 4), color, -1)
        cv2.putText(out, label, (p1[0], p1[1] - 3), cv2.FONT_HERSHEY_SIMPLEX,
                    0.5, (255, 255, 255), 1, cv2.LINE_AA)
    return out


def shaded_mesh_overlay(
    image_bgr: np.ndarray,
    vertices: np.ndarray,
    faces: np.ndarray,
    K: np.ndarray,
    base_color: Tuple[int, int, int] = (180, 140, 110),
    light_dir: Tuple[float, float, float] = (0.3, -0.4, -0.85),
    alpha: float = 0.85,
) -> np.ndarray:
    """Flat-shaded painter's-algorithm mesh render (pyrender replacement).

    Per-triangle Lambert shading from the camera-side light; triangles
    sorted far-to-near; blended onto the image with ``alpha``.
    """
    import cv2

    uvw = vertices @ K.T
    uv = uvw[:, :2] / np.maximum(uvw[:, 2:3], 1e-9)
    tri = vertices[faces]  # (F, 3, 3)
    normals = np.cross(tri[:, 1] - tri[:, 0], tri[:, 2] - tri[:, 0])
    n_norm = normals / np.maximum(np.linalg.norm(normals, axis=-1, keepdims=True), 1e-12)
    ld = np.asarray(light_dir, np.float64)
    ld = ld / np.linalg.norm(ld)
    intensity = np.clip(-n_norm @ ld, 0.0, 1.0) * 0.75 + 0.25

    depth = tri[..., 2].mean(axis=1)
    order = np.argsort(-depth)
    layer = image_bgr.copy()
    pts = uv[faces].astype(np.int32)
    color = np.asarray(base_color, np.float64)
    for i in order:
        c = tuple(int(v) for v in (color * intensity[i]))
        cv2.fillPoly(layer, [pts[i]], c, lineType=cv2.LINE_AA)
    return cv2.addWeighted(layer, alpha, image_bgr, 1 - alpha, 0)


def render_eval_grid(
    crops_rgb01: np.ndarray,
    keypoints_2d: np.ndarray,
    cols: int = 4,
) -> np.ndarray:
    """Tile normalized crops with skeleton overlays into one grid image.

    Equivalent of the reference's tensorboard_logging prediction grids
    (hamer.py:213-267) without the renderer dependency.
    crops_rgb01: (B, S, S, 3) in [0, 1]; keypoints_2d: (B, 21, 2) crop px.
    """
    B, S = crops_rgb01.shape[0], crops_rgb01.shape[1]
    rows = (B + cols - 1) // cols
    grid = np.zeros((rows * S, cols * S, 3), np.uint8)
    for i in range(B):
        img = (np.clip(crops_rgb01[i], 0, 1) * 255).astype(np.uint8)[:, :, ::-1]
        img = draw_hand_skeleton(img, keypoints_2d[i])
        r, c = divmod(i, cols)
        grid[r * S:(r + 1) * S, c * S:(c + 1) * S] = img
    return grid


def detection_summary_image(
    image_bgr: np.ndarray,
    out: dict,
) -> np.ndarray:
    """Draw all valid pipeline detections + 2D keypoints on one frame."""
    img = image_bgr
    n = len(out["valid"])
    for i in range(n):
        if not out["valid"][i]:
            continue
        label = "right" if out["is_right"][i] > 0.5 else "left"
        color = (0, 200, 0) if label == "right" else (200, 100, 0)
        img = plot_box(img, out["boxes"][i], f"{label} {out['scores'][i]:.2f}", color)
        if "keypoints_2d" in out:
            img = draw_hand_skeleton(img, out["keypoints_2d"][i])
    return img
