"""Camera models on tensors (port of hamer_yolo_tpu/geometry/camera.py):
projection, the crop-camera -> full-image lift under real intrinsics (with
RootNet's depth refine), pixel (u, v, depth) <-> camera xyz, and RootNet's
k value."""
from __future__ import annotations

from typing import Optional

import torch


def perspective_projection(points: torch.Tensor, translation: torch.Tensor,
                           focal_length: torch.Tensor) -> torch.Tensor:
    """(B, N, 3) points, (B, 3) translation, (B, 2) focal -> (B, N, 2) crop-space
    pixels about the crop center (HaMeR's projection, no camera center)."""
    points = points + translation[:, None, :]
    proj = points / points[..., 2:3]
    return proj[..., :2] * focal_length[:, None, :]


def project_with_intrinsics(points_cam: torch.Tensor, fx: torch.Tensor, fy: torch.Tensor,
                            cx: torch.Tensor, cy: torch.Tensor, eps: float = 1e-9) -> torch.Tensor:
    """u = fx X / (Z + eps) + cx, v = fy Y / (Z + eps) + cy for (B, N, 3)."""
    z = points_cam[..., 2:3] + eps
    u = points_cam[..., 0:1] / z * fx.reshape(-1, 1, 1) + cx.reshape(-1, 1, 1)
    v = points_cam[..., 1:2] / z * fy.reshape(-1, 1, 1) + cy.reshape(-1, 1, 1)
    return torch.cat([u, v], dim=-1)


def cam_to_translation(pred_cam: torch.Tensor, focal_length: float,
                       image_size: float) -> torch.Tensor:
    """Weak-perspective (s, tx, ty) -> (tx, ty, 2 f / (image_size s + 1e-9))."""
    s, tx, ty = pred_cam[:, 0], pred_cam[:, 1], pred_cam[:, 2]
    tz = 2.0 * focal_length / (image_size * s + 1e-9)
    return torch.stack([tx, ty, tz], dim=-1)


def cam_crop_to_full(cam_bbox: torch.Tensor, box_center: torch.Tensor, box_size: torch.Tensor,
                     img_size: torch.Tensor, focal_length: float = 5000.0) -> torch.Tensor:
    """Crop camera -> full-image translation (B, 3) under default intrinsics
    (the focal length, the image's center); img_size (B, 2) is (w, h)."""
    b = box_size.reshape(-1)
    bs = b * cam_bbox[:, 0] + 1e-9
    tz = 2.0 * focal_length / bs
    tx = (2.0 * (box_center[:, 0] - img_size[:, 0] / 2.0) / bs) + cam_bbox[:, 1]
    ty = (2.0 * (box_center[:, 1] - img_size[:, 1] / 2.0) / bs) + cam_bbox[:, 2]
    return torch.stack([tx, ty, tz], dim=-1)


def custom_cam_crop_to_full(cam_bbox: torch.Tensor, box_center: torch.Tensor,
                            box_size: torch.Tensor, fx: torch.Tensor, fy: torch.Tensor,
                            cx: torch.Tensor, cy: torch.Tensor,
                            depth_refine: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Real-intrinsics crop camera -> full-image translation (B, 3).

    All of box_size, fx, fy, cx, cy and ``depth_refine`` are (B,). With
    ``depth_refine`` (RootNet's depth) tz is forced to it and the scale is
    derived back from it, bs = 2 fx / (tz + 1e-9). The fx != fy correction
    ty *= fx / fy is applied unconditionally, as in JAX.
    """
    if depth_refine is not None:
        tz = depth_refine
        bs = 2.0 * fx / (tz + 1e-9)
    else:
        bs = box_size * cam_bbox[:, 0] + 1e-9
        tz = 2.0 * fx / bs
    tx = (2.0 * (box_center[:, 0] - cx) / bs) + cam_bbox[:, 1]
    ty = (2.0 * (box_center[:, 1] - cy) / bs) + cam_bbox[:, 2]
    ty = ty * (fx / fy)
    return torch.stack([tx, ty, tz], dim=-1)


def calculate_k_value(bbox_wh: torch.Tensor, fx: torch.Tensor, fy: torch.Tensor,
                      real_area: float = 0.09) -> torch.Tensor:
    """RootNet's k: sqrt(real_area fx fy / box area), bbox_wh (..., 2) the
    processed box in pixels. The area is clamped to >= 1, so that a masked
    slot's zero box gives a finite k and not inf."""
    area = torch.clamp(bbox_wh[..., 0] * bbox_wh[..., 1], min=1.0)
    return torch.sqrt(real_area * fx * fy / area)


def _intrinsics(K: torch.Tensor):
    """fx, fy, cx, cy of (..., 3, 3) K, each (..., 1)."""
    return (K[..., 0, 0:1], K[..., 1, 1:2], K[..., 0, 2:3], K[..., 1, 2:3])


def uvd2xyz(uvd: torch.Tensor, K: torch.Tensor) -> torch.Tensor:
    """(..., N, 3) pixel (u, v, depth) -> camera xyz under (..., 3, 3) K."""
    fx, fy, cx, cy = _intrinsics(K)
    x = (uvd[..., 0] - cx) * uvd[..., 2] / fx
    y = (uvd[..., 1] - cy) * uvd[..., 2] / fy
    return torch.stack([x, y, uvd[..., 2]], dim=-1)


def xyz2uvd(xyz: torch.Tensor, K: torch.Tensor) -> torch.Tensor:
    """(..., N, 3) camera xyz -> pixel (u, v, depth) under (..., 3, 3) K."""
    fx, fy, cx, cy = _intrinsics(K)
    u = xyz[..., 0] * fx / xyz[..., 2] + cx
    v = xyz[..., 1] * fy / xyz[..., 2] + cy
    return torch.stack([u, v, xyz[..., 2]], dim=-1)
