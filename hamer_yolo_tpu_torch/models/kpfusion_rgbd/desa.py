"""DESA: depth-enhanced multi-scale keypoint feature aggregation (port of
hamer_yolo_tpu/models/kpfusion_rgbd/desa.py).

For each of three radii (0.1, 0.2, 0.4; 64 samples each) ball-query-group
the point cloud and the joint nodes around every joint, embed the grouped
relative xyz and residual features with 1x1 convs + BN + ReLU, max-pool
over the group, concatenate the scales with the node features and fuse with
a 1x1 conv + BN + ReLU. The grouping is ops/pointnet.query_and_group.
"""
from __future__ import annotations

from typing import Any, Dict, List, Sequence

import torch

from hamer_yolo_tpu_torch.core import nn
from hamer_yolo_tpu_torch.ops.pointnet import query_and_group

Params = Dict[str, Any]
BN_EPS = 1e-5


def _conv1x1_init(gen: torch.Generator, c_in: int, c_out: int) -> Params:
    return {"conv": nn.conv_init(gen, 1, c_in, c_out, bias=True),
            "bn": nn.batch_norm_init(c_out, gen.device)}


def _conv1x1_bn(p: Params, x: torch.Tensor) -> torch.Tensor:
    """x (..., C) -> 1x1 conv + BN over the last axis (the conv's OIHW
    weight read as (out, in))."""
    y = x @ p["conv"]["w"][:, :, 0, 0].t() + p["conv"]["b"]
    return nn.batch_norm(p["bn"], y, eps=BN_EPS)


def desa_init(gen: torch.Generator, in_channel: int = 128, mlp: Sequence[int] = (128, 128),
              n_scales: int = 3) -> Params:
    scales: List[Params] = []
    for _ in range(n_scales):
        sp: Params = {"l0": _conv1x1_init(gen, 3, mlp[0]),
                      "f0": _conv1x1_init(gen, in_channel, mlp[0]), "mlp": []}
        last = mlp[0]
        for c in mlp[1:]:
            sp["mlp"].append(_conv1x1_init(gen, last, c))
            last = c
        scales.append(sp)
    return {"scales": scales,
            "fusion": _conv1x1_init(gen, in_channel + mlp[-1] * n_scales, in_channel)}


def desa_forward(p: Params, pcl_feat: torch.Tensor, node_feat: torch.Tensor,
                 pcl_xyz: torch.Tensor, node_xyz: torch.Tensor,
                 S: Sequence[int] = (64, 64, 64),
                 radius: Sequence[float] = (0.1, 0.2, 0.4)) -> torch.Tensor:
    """pcl_feat (B, N, C), node_feat (B, J, C), pcl_xyz (B, N, 3),
    node_xyz (B, J, 3) -> (B, J, C) (DESA.forward)."""
    xyz_exp = torch.cat([pcl_xyz, node_xyz], dim=1)
    feat_exp = torch.cat([pcl_feat, node_feat], dim=1)
    outs = []
    for i, sp in enumerate(p["scales"]):
        grouped = query_and_group(xyz_exp, node_xyz, feat_exp, radius[i], S[i])  # (B, J, K, 3+C)
        gxyz = grouped[..., :3] / radius[i]
        gfeat = grouped[..., 3:] - node_feat[:, :, None, :]
        h = torch.relu(_conv1x1_bn(sp["l0"], gxyz) + _conv1x1_bn(sp["f0"], gfeat))
        for mp in sp["mlp"]:
            h = torch.relu(_conv1x1_bn(mp, h))
        outs.append(torch.amax(h, dim=2))                                         # (B, J, C')
    outs.append(node_feat)
    return torch.relu(_conv1x1_bn(p["fusion"], torch.cat(outs, dim=-1)))
