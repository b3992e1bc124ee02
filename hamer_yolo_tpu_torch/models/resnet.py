"""ResNet-34 trunk for the SAR / RootNet backbone (port of
hamer_yolo_tpu/models/resnet.py): conv1 7x7/2 + BN + ReLU + max pool 3x3/2
(padding 1) + four stages of BasicBlocks [3, 4, 6, 3], output stride 32,
512 channels. BN uses eps 1e-5 (torchvision's) and runs in the
activations' dtype, per op, as in JAX."""
from __future__ import annotations

import torch

from hamer_yolo_tpu_torch.core import nn

RESNET34_LAYERS = (3, 4, 6, 3)
RESNET34_CHANNELS = (64, 128, 256, 512)
BN_EPS = 1e-5


def _basic_block_init(gen: torch.Generator, c_in: int, c_out: int, stride: int) -> nn.Params:
    dev = gen.device
    p = {"conv1": nn.conv_init(gen, 3, c_in, c_out), "bn1": nn.batch_norm_init(c_out, dev),
         "conv2": nn.conv_init(gen, 3, c_out, c_out), "bn2": nn.batch_norm_init(c_out, dev)}
    if stride != 1 or c_in != c_out:
        p["down"] = nn.conv_init(gen, 1, c_in, c_out)
        p["down_bn"] = nn.batch_norm_init(c_out, dev)
    return p


def _basic_block(p: nn.Params, x: torch.Tensor, stride: int) -> torch.Tensor:
    y = torch.relu(nn.batch_norm(p["bn1"], nn.conv2d(p["conv1"], x, stride, 1), BN_EPS))
    y = nn.batch_norm(p["bn2"], nn.conv2d(p["conv2"], y, 1, 1), BN_EPS)
    if "down" in p:
        x = nn.batch_norm(p["down_bn"], nn.conv2d(p["down"], x, stride, 0), BN_EPS)
    return torch.relu(x + y)


def init_resnet34(gen: torch.Generator) -> nn.Params:
    params = {"conv1": nn.conv_init(gen, 7, 3, 64), "bn1": nn.batch_norm_init(64, gen.device),
              "stages": []}
    c_in = 64
    for stage, (n, c_out) in enumerate(zip(RESNET34_LAYERS, RESNET34_CHANNELS)):
        params["stages"].append([_basic_block_init(gen, c_in if b == 0 else c_out, c_out,
                                                   2 if (b == 0 and stage > 0) else 1)
                                 for b in range(n)])
        c_in = c_out
    return params


def resnet34_forward(params: nn.Params, x: torch.Tensor) -> torch.Tensor:
    """x (B, H, W, 3) -> (B, H/32, W/32, 512), in x's dtype."""
    y = torch.relu(nn.batch_norm(params["bn1"], nn.conv2d(params["conv1"], x, 2, 3), BN_EPS))
    y = nn.max_pool(y, 3, 2, padding=1)
    for stage, blocks in enumerate(params["stages"]):
        for b, blk in enumerate(blocks):
            y = _basic_block(blk, y, 2 if (b == 0 and stage > 0) else 1)
    return y
