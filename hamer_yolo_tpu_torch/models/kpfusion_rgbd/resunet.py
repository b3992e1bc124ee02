"""ResNet-UNet image streams (port of hamer_yolo_tpu/models/kpfusion_rgbd/resunet.py).

``OfficialResNetUnet`` (depth stream, 1-channel conv1) and its RGB twin
(3-channel conv1) share one topology: a torchvision-style ResNet-18 emitting
(c0..c4), hourglass ``Residual`` blocks (pre-activation BN-ReLU
conv1-conv3-conv1 with a 1x1 skip) on the skip / up / fusion paths, bilinear
2x upsampling, and 1x1 ``finals`` heads concatenated channel-wise (joint_num
* 3 offset unit vectors, joint_num heatmaps, joint_num weights).

Every BN is inference-mode with running stats at eps 1e-5 (torch's default,
which KPFusion never changes; core/nn.batch_norm's own default is YOLO's
1e-3). Activations are NHWC at every public function.
"""
from __future__ import annotations

from typing import Any, Dict, List, Sequence, Tuple

import torch
import torch.nn.functional as F

from hamer_yolo_tpu_torch.core import nn

Params = Dict[str, Any]

RESNET18_LAYERS = (2, 2, 2, 2)
RESNET18_CHANNELS = (64, 128, 256, 512)
BN_EPS = 1e-5


def _bn(p, x):
    return nn.batch_norm(p, x, eps=BN_EPS)


# --- hourglass Residual (pre-activation bottleneck) --------------------------

def residual_init(gen: torch.Generator, c_in: int, c_out: int) -> Params:
    dev = gen.device
    half = c_out // 2
    p = {
        "bn1": nn.batch_norm_init(c_in, dev),
        "conv1": nn.conv_init(gen, 1, c_in, half, bias=True),
        "bn2": nn.batch_norm_init(half, dev),
        "conv2": nn.conv_init(gen, 3, half, half, bias=True),
        "bn3": nn.batch_norm_init(half, dev),
        "conv3": nn.conv_init(gen, 1, half, c_out, bias=True),
    }
    if c_in != c_out:
        p["skip"] = nn.conv_init(gen, 1, c_in, c_out, bias=True)
    return p


def residual(p: Params, x: torch.Tensor) -> torch.Tensor:
    out = nn.conv2d(p["conv1"], torch.relu(_bn(p["bn1"], x)), padding=0)
    out = nn.conv2d(p["conv2"], torch.relu(_bn(p["bn2"], out)), padding=1)
    out = nn.conv2d(p["conv3"], torch.relu(_bn(p["bn3"], out)), padding=0)
    skip = nn.conv2d(p["skip"], x, padding=0) if "skip" in p else x
    return out + skip


# --- torchvision-style ResNet-18 multiscale backbone -------------------------

def _block_init(gen: torch.Generator, c_in: int, c_out: int, stride: int) -> Params:
    dev = gen.device
    p = {
        "conv1": nn.conv_init(gen, 3, c_in, c_out),
        "bn1": nn.batch_norm_init(c_out, dev),
        "conv2": nn.conv_init(gen, 3, c_out, c_out),
        "bn2": nn.batch_norm_init(c_out, dev),
    }
    if stride != 1 or c_in != c_out:
        p["down"] = nn.conv_init(gen, 1, c_in, c_out)
        p["down_bn"] = nn.batch_norm_init(c_out, dev)
    return p


def _block(p: Params, x: torch.Tensor, stride: int) -> torch.Tensor:
    out = torch.relu(_bn(p["bn1"], nn.conv2d(p["conv1"], x, stride=stride, padding=1)))
    out = _bn(p["bn2"], nn.conv2d(p["conv2"], out, padding=1))
    if "down" in p:
        x = _bn(p["down_bn"], nn.conv2d(p["down"], x, stride=stride, padding=0))
    return torch.relu(out + x)


def resnet18_init(gen: torch.Generator, in_channels: int = 3) -> Params:
    p: Params = {"conv1": nn.conv_init(gen, 7, in_channels, 64),
                 "bn1": nn.batch_norm_init(64, gen.device), "stages": []}
    c_in = 64
    for si, (n, c) in enumerate(zip(RESNET18_LAYERS, RESNET18_CHANNELS)):
        blocks = []
        for b in range(n):
            blocks.append(_block_init(gen, c_in, c, 2 if (b == 0 and si > 0) else 1))
            c_in = c
        p["stages"].append(blocks)
    return p


def resnet18_forward(p: Params, x: torch.Tensor) -> List[torch.Tensor]:
    """x (B, H, W, C) -> [c0, c1, c2, c3, c4] (strides 4, 4, 8, 16, 32)."""
    y = torch.relu(_bn(p["bn1"], nn.conv2d(p["conv1"], x, stride=2, padding=3)))
    y = nn.max_pool(y, k=3, stride=2, padding=1)
    feats = [y]
    for si, blocks in enumerate(p["stages"]):
        for b, bp in enumerate(blocks):
            y = _block(bp, y, 2 if (b == 0 and si > 0) else 1)
        feats.append(y)
    return feats


# --- UNet --------------------------------------------------------------------

def _up2x_bilinear(x: torch.Tensor) -> torch.Tensor:
    """nn.Upsample(scale_factor=2, mode='bilinear', align_corners=False),
    which is jax.image.resize's bilinear at 2x (tests/test_torch_kpfusion.py
    holds the two equal)."""
    _, H, W, _ = x.shape
    y = F.interpolate(x.permute(0, 3, 1, 2), size=(2 * H, 2 * W), mode="bilinear",
                      align_corners=False)
    return y.permute(0, 2, 3, 1)


def unet_init(gen: torch.Generator, joint_num: int = 21, in_channels: int = 1,
              deconv_dim: int = 128, out_dim_list: Sequence[int] | None = None) -> Params:
    out_dim_list = list(out_dim_list or [joint_num * 3, joint_num, joint_num])
    dev = gen.device
    p: Params = {
        "backbone": resnet18_init(gen, in_channels),
        "skip4": residual_init(gen, 256, 256),
        "up4": residual_init(gen, 512, 512),
        "fuse4": residual_init(gen, 512 + 256, 256),
        "skip3": residual_init(gen, 128, 128),
        "up3": residual_init(gen, 256, 256),
        "fuse3": residual_init(gen, 256 + 128, 128),
        "skip2": residual_init(gen, 64, 64),
        "up2": residual_init(gen, 128, 128),
        "fuse2": residual_init(gen, 128 + 64, deconv_dim),
    }
    # the reference's init: finals ~ N(0, 0.001), zero bias
    p["finals"] = [{"w": 0.001 * torch.randn((d, deconv_dim, 1, 1), generator=gen, device=dev),
                    "b": torch.zeros(d, device=dev)} for d in out_dim_list]
    return p


def unet_forward(p: Params, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """x (B, H, W, C) -> (img_result (B, H/4, W/4, sum(out_dims)),
    img_feature (B, H/4, W/4, deconv_dim)), OfficialResNetUnet.forward."""
    c0, c1, c2, c3, c4 = resnet18_forward(p["backbone"], x)
    c4_up = _up2x_bilinear(residual(p["up4"], c4))
    c3_fused = residual(p["fuse4"], torch.cat([c4_up, residual(p["skip4"], c3)], -1))
    c3_up = _up2x_bilinear(residual(p["up3"], c3_fused))
    c2_fused = residual(p["fuse3"], torch.cat([c3_up, residual(p["skip3"], c2)], -1))
    c2_up = _up2x_bilinear(residual(p["up2"], c2_fused))
    feat = residual(p["fuse2"], torch.cat([c2_up, residual(p["skip2"], c1)], -1))
    outs = [nn.conv2d(fp, feat, padding=0) for fp in p["finals"]]
    return torch.cat(outs, dim=-1), feat
