"""YOLOv7 deploy-form blocks on NHWC tensors (port of
hamer_yolo_tpu/models/yolov7/blocks.py): fused Conv(+BN)+SiLU, max pools,
ReOrg (space to depth), SPPCSPC, nearest 2x upsample and deploy RepConv (one
fused 3x3 conv). JAX's peephole that fuses ReOrg into the 3x3 conv after it
(``HYT_FUSE_REORG``, on only on a TPU) is not ported: ReOrg runs unfused."""
from __future__ import annotations

import torch

from hamer_yolo_tpu_torch.core import nn

SPP_POOL_KS = (5, 9, 13)


def silu(x: torch.Tensor) -> torch.Tensor:
    """x * sigmoid(x) with the product rounded in x's dtype, as jax.nn.silu."""
    return x * torch.sigmoid(x)


def conv_block_init(gen: torch.Generator, c1: int, c2: int, k: int = 1) -> nn.Params:
    return {"conv": nn.conv_init(gen, k, c1, c2, bias=True)}


def conv_block(p: nn.Params, x: torch.Tensor, s: int = 1) -> torch.Tensor:
    k = p["conv"]["w"].shape[-1]
    return silu(nn.conv2d(p["conv"], x, stride=s, padding=k // 2))


def mp(x: torch.Tensor, k: int = 2) -> torch.Tensor:
    return nn.max_pool(x, k, k)


def sp(x: torch.Tensor, k: int = 3) -> torch.Tensor:
    return nn.max_pool(x, k, 1, padding=k // 2)


def reorg(x: torch.Tensor) -> torch.Tensor:
    """(B, H, W, C) -> (B, H/2, W/2, 4C) space to depth, channels in the
    reference's order ([::2, ::2], [1::2, ::2], [::2, 1::2], [1::2, 1::2]),
    by JAX's reshape and transpose."""
    B, H, W, C = x.shape
    y = x.reshape(B, H // 2, 2, W // 2, 2, C).permute(0, 1, 3, 4, 2, 5)
    return y.reshape(B, H // 2, W // 2, 4 * C)


def upsample2x(x: torch.Tensor) -> torch.Tensor:
    """Nearest-neighbour 2x upsample, NHWC."""
    return x.repeat_interleave(2, dim=1).repeat_interleave(2, dim=2)


def sppcspc_init(gen: torch.Generator, c1: int, c2: int) -> nn.Params:
    c_ = c2
    return {
        "cv1": conv_block_init(gen, c1, c_), "cv2": conv_block_init(gen, c1, c_),
        "cv3": conv_block_init(gen, c_, c_, 3), "cv4": conv_block_init(gen, c_, c_),
        "cv5": conv_block_init(gen, 4 * c_, c_), "cv6": conv_block_init(gen, c_, c_, 3),
        "cv7": conv_block_init(gen, 2 * c_, c2),
    }


def sppcspc(p: nn.Params, x: torch.Tensor) -> torch.Tensor:
    x1 = conv_block(p["cv4"], conv_block(p["cv3"], conv_block(p["cv1"], x)))
    pools = [sp(x1, k) for k in SPP_POOL_KS]
    y1 = conv_block(p["cv6"], conv_block(p["cv5"], torch.cat([x1] + pools, dim=-1)))
    y2 = conv_block(p["cv2"], x)
    return conv_block(p["cv7"], torch.cat([y1, y2], dim=-1))


def repconv_init(gen: torch.Generator, c1: int, c2: int) -> nn.Params:
    return {"reparam": nn.conv_init(gen, 3, c1, c2, bias=True)}


def repconv(p: nn.Params, x: torch.Tensor, s: int = 1) -> torch.Tensor:
    return silu(nn.conv2d(p["reparam"], x, stride=s, padding=1))
