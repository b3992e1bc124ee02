"""Bounding-box algebra on tensors (port of hamer_yolo_tpu/geometry/boxes.py).

Same math, same op order as the JAX functions, so f32 results agree bit for
bit where both sides do plain IEEE arithmetic.
"""
from __future__ import annotations

from typing import Tuple

import torch


def xywh2xyxy(x: torch.Tensor) -> torch.Tensor:
    """(..., 4) center boxes -> (x1, y1, x2, y2)."""
    x1 = x[..., 0] - x[..., 2] / 2
    y1 = x[..., 1] - x[..., 3] / 2
    x2 = x[..., 0] + x[..., 2] / 2
    y2 = x[..., 1] + x[..., 3] / 2
    return torch.stack([x1, y1, x2, y2], dim=-1)


def box_area(box: torch.Tensor) -> torch.Tensor:
    return (box[..., 2] - box[..., 0]) * (box[..., 3] - box[..., 1])


def box_iou(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Pairwise IoU of (..., N, 4) and (..., M, 4) xyxy boxes -> (..., N, M)."""
    lt = torch.maximum(a[..., :, None, :2], b[..., None, :, :2])
    rb = torch.minimum(a[..., :, None, 2:], b[..., None, :, 2:])
    wh = torch.clamp(rb - lt, min=0.0)
    inter = wh[..., 0] * wh[..., 1]
    union = box_area(a)[..., :, None] + box_area(b)[..., None, :] - inter
    return inter / torch.clamp(union, min=1e-12)


def clip_boxes(boxes: torch.Tensor, h: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Clip xyxy boxes to [0, w] x [0, h]; h, w broadcast against boxes[..., 0]."""
    zero = torch.zeros_like(boxes[..., 0])
    x1 = torch.minimum(torch.maximum(boxes[..., 0], zero), w)
    y1 = torch.minimum(torch.maximum(boxes[..., 1], zero), h)
    x2 = torch.minimum(torch.maximum(boxes[..., 2], zero), w)
    y2 = torch.minimum(torch.maximum(boxes[..., 3], zero), h)
    return torch.stack([x1, y1, x2, y2], dim=-1)


def scale_coords(boxes: torch.Tensor, gain: torch.Tensor, pad_wh: torch.Tensor,
                 orig_hw: torch.Tensor) -> torch.Tensor:
    """Undo the letterbox: network-input xyxy -> original-frame xyxy.

    boxes (..., S, 4); gain (...,); pad_wh (..., 2) one-sided (dw, dh);
    orig_hw (..., 2) (h, w) of the original frame.
    """
    g = gain[..., None]
    x1 = (boxes[..., 0] - pad_wh[..., 0:1]) / g
    y1 = (boxes[..., 1] - pad_wh[..., 1:2]) / g
    x2 = (boxes[..., 2] - pad_wh[..., 0:1]) / g
    y2 = (boxes[..., 3] - pad_wh[..., 1:2]) / g
    return clip_boxes(torch.stack([x1, y1, x2, y2], dim=-1),
                      orig_hw[..., 0:1], orig_hw[..., 1:2])


def expand_to_aspect_ratio(wh: torch.Tensor, target_aspect: Tuple[float, float]) -> torch.Tensor:
    """Grow (..., 2) box (w, h) minimally to reach the aspect w_t:h_t."""
    w, h = wh[..., 0], wh[..., 1]
    w_t, h_t = float(target_aspect[0]), float(target_aspect[1])
    too_wide = (h / torch.clamp(w, min=1e-12)) < (h_t / w_t)
    h_new = torch.where(too_wide, torch.maximum(w * h_t / w_t, h), h)
    w_new = torch.where(too_wide, w, torch.maximum(h * w_t / h_t, w))
    return torch.stack([w_new, h_new], dim=-1)


def hamer_box_params(bbox_xyxy: torch.Tensor, rescale_factor: float = 2.5,
                     bbox_shape: Tuple[float, float] = (192.0, 256.0)
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Detector box -> (center (..., 2), square crop size (...,)) for HaMeR."""
    center = torch.stack([(bbox_xyxy[..., 0] + bbox_xyxy[..., 2]) / 2.0,
                          (bbox_xyxy[..., 1] + bbox_xyxy[..., 3]) / 2.0], dim=-1)
    wh = torch.stack([bbox_xyxy[..., 2] - bbox_xyxy[..., 0],
                      bbox_xyxy[..., 3] - bbox_xyxy[..., 1]], dim=-1)
    expanded = expand_to_aspect_ratio(rescale_factor * wh, bbox_shape)
    return center, torch.amax(expanded, dim=-1)
