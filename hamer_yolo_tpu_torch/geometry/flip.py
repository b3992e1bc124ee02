"""Left-hand flip algebra (port of hamer_yolo_tpu/geometry/flip.py): the crop
camera's tx, the kp3d mirror, the mesh mirror and the faces' rewinding.

Only the corrected kp3d mirror, x * (1 - 2 do_flip), is ported; the
reference's ``x * do_flip`` (which zeroes right-hand x) is a known bug and
has no counterpart here.
"""
from __future__ import annotations

import torch


def flip_correction_factor(do_flip: torch.Tensor) -> torch.Tensor:
    """1.0 for right hands (do_flip=0), -1.0 for left hands (do_flip=1)."""
    return 1.0 - 2.0 * do_flip.reshape(-1)


def correct_pred_cam(pred_cam: torch.Tensor, do_flip: torch.Tensor) -> torch.Tensor:
    """Negate the weak-perspective tx of flipped (left) hands."""
    f = flip_correction_factor(do_flip)
    return torch.stack([pred_cam[:, 0], pred_cam[:, 1] * f, pred_cam[:, 2]], dim=-1)


def flip_keypoints3d(kp3d: torch.Tensor, do_flip: torch.Tensor) -> torch.Tensor:
    """Mirror x of (B, N, 3) keypoints for flipped hands."""
    factor = flip_correction_factor(do_flip)[:, None]
    return torch.stack([kp3d[..., 0] * factor, kp3d[..., 1], kp3d[..., 2]], dim=-1)


def mirror_mesh(vertices: torch.Tensor, is_left: torch.Tensor) -> torch.Tensor:
    """Negate x of (..., V, 3) vertices where ``is_left`` (the batch dims) > 0.5."""
    factor = torch.where(is_left[..., None] > 0.5, -1.0, 1.0).to(vertices.dtype)
    return torch.cat([vertices[..., :1] * factor[..., None], vertices[..., 1:]], dim=-1)


def rewind_faces(faces: torch.Tensor) -> torch.Tensor:
    """Faces' winding reversed ([0, 2, 1]), so that a mirrored mesh faces out."""
    return faces[..., [0, 2, 1]]
