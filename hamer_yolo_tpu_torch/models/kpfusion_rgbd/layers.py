"""KeypointFusion's auxiliary layers: CBAM, the RGBDFusion gate, the
hourglass PoseNet and a full-map back-projection (port of
hamer_yolo_tpu/models/kpfusion_rgbd/layers.py; NHWC).

- ``cbam``: channel gate (a shared MLP over the average and max pools) and
  spatial gate (a 7x7 conv over the channel max and mean);
- ``rgbd_fusion``: a gated blend of co-registered RGB and depth features,
  then CBAM;
- ``hourglass``: an encoder-decoder with skip links (the hourglass Residual
  of the runtime's UNets is resunet.residual);
- ``depth_to_pointcloud``: a depth map back-projected to a fixed-capacity
  cloud.

The RGB-D runtime (model.py, runtime.py) uses none of them; each reference
module keeps a counterpart.
"""
from __future__ import annotations

from typing import Any, Dict, Tuple

import numpy as np
import torch

from hamer_yolo_tpu_torch.core import nn

Params = Dict[str, Any]


# --- CBAM --------------------------------------------------------------------

def cbam_init(gen: torch.Generator, dim: int, reduction: int = 16) -> Params:
    hidden = max(dim // reduction, 4)
    return {"mlp1": nn.linear_init(gen, dim, hidden), "mlp2": nn.linear_init(gen, hidden, dim),
            "spatial": nn.conv_init(gen, 7, 2, 1, bias=True)}


def cbam(p: Params, x: torch.Tensor) -> torch.Tensor:
    """(B, H, W, C) channel and spatial attention gating."""
    def mlp(v):
        return nn.linear(p["mlp2"], torch.relu(nn.linear(p["mlp1"], v)))

    att = mlp(torch.mean(x, dim=(1, 2))) + mlp(torch.amax(x, dim=(1, 2)))
    x = x * torch.sigmoid(att)[:, None, None, :]
    pool = torch.stack([torch.amax(x, dim=-1), torch.mean(x, dim=-1)], dim=-1)
    return x * torch.sigmoid(nn.conv2d(p["spatial"], pool, 1, 3))


# --- RGBDFusion --------------------------------------------------------------

def rgbd_fusion_init(gen: torch.Generator, dim: int) -> Params:
    return {"gate_rgb": nn.linear_init(gen, 2 * dim, dim),
            "gate_d": nn.linear_init(gen, 2 * dim, dim), "cbam": cbam_init(gen, dim)}


def rgbd_fusion(p: Params, rgb: torch.Tensor, depth: torch.Tensor) -> torch.Tensor:
    """Gated fusion of co-registered (B, H, W, C) RGB and depth features."""
    cat = torch.cat([rgb, depth], dim=-1)
    g_r = torch.sigmoid(nn.linear(p["gate_rgb"], cat))
    g_d = torch.sigmoid(nn.linear(p["gate_d"], cat))
    return cbam(p["cbam"], rgb * g_r + depth * g_d)


# --- Hourglass PoseNet -------------------------------------------------------

def hourglass_init(gen: torch.Generator, dim: int, depth: int = 3) -> Params:
    downs, ups, skips = [], [], []
    for _ in range(depth):
        downs.append(nn.conv_init(gen, 3, dim, dim, bias=True))
        ups.append(nn.conv_init(gen, 3, dim, dim, bias=True))
        skips.append(nn.conv_init(gen, 1, dim, dim, bias=True))
    return {"downs": downs, "ups": ups, "skips": skips,
            "out": nn.conv_init(gen, 1, dim, dim, bias=True)}


def _resize_nearest(x: torch.Tensor, hw: Tuple[int, int]) -> torch.Tensor:
    """jax.image.resize(method="nearest") of NHWC ``x`` to ``hw``: source
    index floor((i + 0.5) * in / out) in f32."""
    def src(n_in, n_out):
        i = np.floor((np.arange(n_out, dtype=np.float32) + np.float32(0.5)) * np.float32(n_in)
                     / np.float32(n_out)).astype(np.int64)
        return nn.constant(tuple(i.tolist()), torch.long, x.device)

    return x[:, src(x.shape[1], hw[0])][:, :, src(x.shape[2], hw[1])]


def hourglass(p: Params, x: torch.Tensor) -> torch.Tensor:
    skips = []
    y = x
    for down, skip in zip(p["downs"], p["skips"]):
        skips.append(nn.conv2d(skip, y, 1, 0))
        y = torch.relu(nn.conv2d(down, y, 2, 1))
    for up, skip in zip(reversed(p["ups"]), reversed(skips)):
        # back to the skip's resolution (stride-2 convs do not halve odd sizes)
        y = _resize_nearest(y, skip.shape[1:3])
        y = torch.relu(nn.conv2d(up, y, 1, 1)) + skip
    return nn.conv2d(p["out"], y, 1, 0)


def depth_to_pointcloud(depth: torch.Tensor, K: torch.Tensor, num_points: int, stride: int = 2,
                        z_range: Tuple[float, float] = (0.1, 2.0)) -> torch.Tensor:
    """(H, W) depth map -> (num_points, 3) cloud: every ``stride``-th pixel
    back-projected, the valid ones first, cut or padded to ``num_points``;
    invalid slots repeat the valid points' centroid."""
    H, W = depth.shape
    ys, xs = torch.meshgrid(torch.arange(0, H, stride, dtype=torch.float32, device=depth.device),
                            torch.arange(0, W, stride, dtype=torch.float32, device=depth.device),
                            indexing="ij")
    z = depth[::stride, ::stride]
    valid = (z > z_range[0]) & (z < z_range[1])
    x = (xs - K[0, 2]) * z / K[0, 0]
    y = (ys - K[1, 2]) * z / K[1, 1]
    pts = torch.stack([x, y, z], dim=-1).reshape(-1, 3)
    vflat = valid.reshape(-1)
    order = torch.argsort((~vflat).to(torch.int8), stable=True)  # valid first
    pts = pts[order][:num_points]
    vsel = vflat[order][:num_points]
    centroid = torch.sum(pts * vsel[:, None], dim=0) / torch.clamp(vsel.sum(), min=1)
    return torch.where(vsel[:, None], pts, centroid)
