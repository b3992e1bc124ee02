"""Bounding-box algebra on tensors (port of hamer_yolo_tpu/geometry/boxes.py).

Same math, same op order as the JAX functions, so f32 results agree bit for
bit where both sides do plain IEEE arithmetic.
"""
from __future__ import annotations

from typing import Tuple

import torch


def xyxy2xywh(x: torch.Tensor) -> torch.Tensor:
    """(..., 4) corner boxes -> (cx, cy, w, h)."""
    return torch.stack([(x[..., 0] + x[..., 2]) / 2, (x[..., 1] + x[..., 3]) / 2,
                        x[..., 2] - x[..., 0], x[..., 3] - x[..., 1]], dim=-1)


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


def track_boxes_from_keypoints(kp2d: torch.Tensor, valid: torch.Tensor, orig_hw: torch.Tensor,
                               expand: float = 1.3, min_size: float = 32.0) -> torch.Tensor:
    """Detector-shaped boxes from a previous tick's projected 2D keypoints,
    the detect-skip tracking primitive: kp2d (..., S, 21, 2) full-image
    pixels, valid (..., S), orig_hw (..., 2) (h, w) -> (..., S, 4) xyxy: the
    keypoints' extent times ``expand``, at least ``min_size`` a side, clipped
    to the frame and rounded, invalid slots zeroed (the contract of
    ``detect_hands`` boxes)."""
    lo = torch.amin(kp2d, dim=-2)
    hi = torch.amax(kp2d, dim=-2)
    center = (lo + hi) / 2.0
    wh = torch.clamp((hi - lo) * expand, min=min_size)
    xyxy = torch.cat([center - wh / 2.0, center + wh / 2.0], dim=-1)
    xyxy = torch.round(clip_boxes(xyxy, orig_hw[..., None, 0], orig_hw[..., None, 1]))
    return xyxy * valid.to(xyxy.dtype)[..., None]


def sanitize_bbox_xywh(bbox: torch.Tensor, img_w: torch.Tensor, img_h: torch.Tensor
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Clamp an xywh box into the image -> (box, valid). The reference
    returns None for a degenerate box; here that is valid = False."""
    x, y, w, h = bbox[..., 0], bbox[..., 1], bbox[..., 2], bbox[..., 3]
    x1 = torch.clamp(x, min=0.0)
    y1 = torch.clamp(y, min=0.0)
    x2 = torch.minimum(img_w - 1.0, x1 + torch.clamp(w - 1.0, min=0.0))
    y2 = torch.minimum(img_h - 1.0, y1 + torch.clamp(h - 1.0, min=0.0))
    valid = (w * h > 0) & (x2 > x1) & (y2 > y1)
    return torch.stack([x1, y1, x2 - x1, y2 - y1], dim=-1), valid


def process_bbox(bbox_xywh: torch.Tensor, img_w: torch.Tensor, img_h: torch.Tensor,
                 input_hw: Tuple[float, float] = (256.0, 256.0), ratio: float = 1.5
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """RootNet's box: sanitise, grow to the input's aspect, pad by ``ratio``
    -> ((..., 4) xywh, valid). img_w, img_h broadcast against bbox[..., 0]."""
    bbox, valid = sanitize_bbox_xywh(bbox_xywh, img_w, img_h)
    w, h = bbox[..., 2], bbox[..., 3]
    c_x = bbox[..., 0] + w / 2.0
    c_y = bbox[..., 1] + h / 2.0
    aspect = float(input_hw[1]) / float(input_hw[0])
    h_new = torch.where(w > aspect * h, w / aspect, h)
    w_new = torch.where(w < aspect * h, h * aspect, w)
    w_out, h_out = w_new * ratio, h_new * ratio
    return torch.stack([c_x - w_out / 2.0, c_y - h_out / 2.0, w_out, h_out], dim=-1), valid
