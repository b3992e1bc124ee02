"""The centerNet regression head (port of
hamer_yolo_tpu/models/kpfusion_rgbd/centernet.py): a 1-channel ResNet-18
trunk, a global average pool and an fc to (B, joint_num, 3), the
reference's coarse hand center / joints from a depth crop.
"""
from __future__ import annotations

from typing import Any, Dict

import torch

from hamer_yolo_tpu_torch.core import nn
from hamer_yolo_tpu_torch.models.kpfusion_rgbd.resunet import resnet18_forward, resnet18_init

Params = Dict[str, Any]


def centernet_init(gen: torch.Generator, joint_num: int = 21) -> Params:
    return {"backbone": resnet18_init(gen, in_channels=1),
            "fc": nn.linear_init(gen, 512, joint_num * 3)}


def centernet_forward(p: Params, x: torch.Tensor) -> torch.Tensor:
    """x (B, H, W, 1) depth crop -> (B, J, 3)."""
    pooled = resnet18_forward(p["backbone"], x)[-1].mean(dim=(1, 2))
    out = nn.linear(p["fc"], pooled)
    return out.reshape(out.shape[0], -1, 3)
