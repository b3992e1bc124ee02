"""ConvNeXt backbone, SAR's "convnext" option (port of
hamer_yolo_tpu/models/convnext.py), NHWC throughout.

A 4x4 stride-4 patchify stem + LayerNorm, then four stages, each after the
first entered by LayerNorm + a 2x2 stride-2 conv; a block is a 7x7
depthwise conv, LayerNorm (eps 1e-6), pw1 (x4), exact-erf GELU, pw2, the
layer scale ``gamma`` and the residual. Every op rounds in the activation
dtype, as the JAX source's ops do (nn.layer_norm, nn.gelu).
"""
from __future__ import annotations

import torch

from hamer_yolo_tpu_torch.core import nn

CONVNEXT_SPECS = {
    "tiny": ((3, 3, 9, 3), (96, 192, 384, 768)),
    "small": ((3, 3, 27, 3), (96, 192, 384, 768)),
    "base": ((3, 3, 27, 3), (128, 256, 512, 1024)),
    "large": ((3, 3, 27, 3), (192, 384, 768, 1536)),
}


def _block_init(gen: torch.Generator, dim: int, layer_scale: float = 1e-6) -> nn.Params:
    return {"dwconv": nn.conv_init(gen, 7, dim, dim, bias=True, groups=dim),
            "norm": nn.layer_norm_init(dim, gen.device),
            "pw1": nn.linear_init(gen, dim, 4 * dim),
            "pw2": nn.linear_init(gen, 4 * dim, dim),
            "gamma": torch.full((dim,), layer_scale, device=gen.device)}


def _block(p: nn.Params, x: torch.Tensor) -> torch.Tensor:
    y = nn.conv2d(p["dwconv"], x, 1, 3, groups=x.shape[-1])
    y = nn.layer_norm(p["norm"], y)
    y = nn.linear(p["pw2"], nn.gelu(nn.linear(p["pw1"], y)))
    return x + nn.cast_weight(p["gamma"], y.dtype) * y


def init_convnext(gen: torch.Generator, variant: str = "base") -> nn.Params:
    """Random-init ConvNeXt of ``variant``, drawn from ``gen`` on its device
    (JAX's distributions; gamma at JAX's 1e-6 layer scale)."""
    depths, dims = CONVNEXT_SPECS[variant]
    params: nn.Params = {"stem_conv": nn.conv_init(gen, 4, 3, dims[0], bias=True),
                         "stem_norm": nn.layer_norm_init(dims[0], gen.device),
                         "stages": [], "downsamples": []}
    for stage in range(4):
        if stage > 0:
            params["downsamples"].append({
                "norm": nn.layer_norm_init(dims[stage - 1], gen.device),
                "conv": nn.conv_init(gen, 2, dims[stage - 1], dims[stage], bias=True)})
        params["stages"].append([_block_init(gen, dims[stage]) for _ in range(depths[stage])])
    return params


def convnext_forward(params: nn.Params, x: torch.Tensor) -> torch.Tensor:
    """x (B, H, W, 3) -> (B, H / 32, W / 32, dims[-1]), in x's dtype."""
    y = nn.layer_norm(params["stem_norm"], nn.conv2d(params["stem_conv"], x, 4, 0))
    for stage, blocks in enumerate(params["stages"]):
        if stage > 0:
            ds = params["downsamples"][stage - 1]
            y = nn.conv2d(ds["conv"], nn.layer_norm(ds["norm"], y), 2, 0)
        for blk in blocks:
            y = _block(blk, y)
    return y
