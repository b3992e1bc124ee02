"""3-scale + flip test-time augmentation of the detector (port of
hamer_yolo_tpu/models/yolov7/tta.py; ``detect --augment``).

The reference's ``Model.forward(augment=True)``: scales (1, 0.83, 0.67), the
0.83 branch flipped left-right; each branch's boxes scaled back (/ s) and
unflipped (x -> W - x), the branches concatenated along the candidates.
The scaled shapes follow from the input's, so the three branches are one
fixed-shape program.
"""
from __future__ import annotations

import math
from typing import List

import torch
import torch.nn.functional as F

from hamer_yolo_tpu_torch.models.yolov7.model import YoloConfig, yolov7_forward

TTA_SCALES = (1.0, 0.83, 0.67)
TTA_FLIPS = (None, "lr", None)
PAD_VALUE = 0.447  # the ImageNet-mean grey the reference pads with


def _scale_pad(x: torch.Tensor, ratio: float, gs: int = 32) -> torch.Tensor:
    """The reference's scale_img: a bilinear resize of x (B, H, W, C) to
    int(H ratio) x int(W ratio), half-pixel centres and no antialias (torch's
    bilinear, which JAX's ``antialias=False`` resize matches), then padded at
    the bottom and right with PAD_VALUE to ceil(H ratio / gs) gs, the ceiling
    taken of the float product, as the reference takes it."""
    B, H, W, C = x.shape
    if ratio == 1.0:
        return x
    h, w = int(H * ratio), int(W * ratio)
    resized = F.interpolate(x.permute(0, 3, 1, 2), size=(h, w), mode="bilinear",
                            align_corners=False, antialias=False)
    H2, W2 = math.ceil(H * ratio / gs) * gs, math.ceil(W * ratio / gs) * gs
    return F.pad(resized, (0, W2 - w, 0, H2 - h), value=PAD_VALUE).permute(0, 2, 3, 1)


def yolov7_forward_tta(params, x: torch.Tensor, cfg: YoloConfig = YoloConfig(),
                       spec=None) -> torch.Tensor:
    """(B, H, W, 3) in [0, 1] -> (B, sum of the branches' N, nc + 5)."""
    W = x.shape[2]
    outs: List[torch.Tensor] = []
    for s, f in zip(TTA_SCALES, TTA_FLIPS):
        xi = _scale_pad(x.flip(2) if f == "lr" else x, s)
        yi = yolov7_forward(params, xi, cfg, spec=spec)
        xy = yi[..., :4] / s
        if f == "lr":
            xy = torch.cat([W - xy[..., :1], xy[..., 1:]], dim=-1)
        outs.append(torch.cat([xy, yi[..., 4:]], dim=-1))
    return torch.cat(outs, dim=1)
