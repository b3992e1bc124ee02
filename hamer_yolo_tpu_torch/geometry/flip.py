"""Left-hand flip algebra (port of hamer_yolo_tpu/geometry/flip.py).

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
