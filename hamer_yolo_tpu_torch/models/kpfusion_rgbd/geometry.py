"""KeypointFusion normalized-coordinate geometry and dense offset decode on
tensors (port of hamer_yolo_tpu/models/kpfusion_rgbd/geometry.py).

- ``uvd_nl2xyznl`` / ``xyz_nl2uvdnl``: normalized crop-space uvd ([-1, 1]
  uv over the crop, depth normalized by the center and the cube) <->
  normalized metric xyz (centered on the crop's center of mass, scaled by
  cube / 2), through the crop matrix M and the pinhole intrinsics;
- ``img2pcl_index``: for each point of the cloud, its 4 nearest image pixels
  in normalized xyz and their inverse-distance closeness weights;
- ``img2anchor_dis``: the Geometry Adjacency Map 1 / (gamma d^2 + 1) between
  each joint and each pixel;
- ``offset2joint_weight``, ``joint2offset``, ``pcl_joint2offset``: dense
  offset / heatmap / weight maps, encode and decode;
- ``joint2heatmap``: gaussian heatmaps.

Offset maps are channel-first (B, 5J, fs, fs) as in the reference; points
and joints (B, N, 3). Distances go through ``ops/pointnet.pairwise_sqdist``
and nearest-k through its stable sort, so the index choices are the same on
every device given the same coordinates. M's inverse is the 3 x 3 adjugate
in float64, rounded once to f32: no solver call, nothing that waits on the
host, so the forward can be captured in a CUDA graph.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from hamer_yolo_tpu_torch.core import nn
from hamer_yolo_tpu_torch.ops.pointnet import pairwise_sqdist, smallest_k, sqsum3


def points_img_to_3d(uvd: torch.Tensor, paras: torch.Tensor, flip: float = 1.0) -> torch.Tensor:
    """(B, N, 3) pixel uvd (z in mm) -> metric xyz."""
    fx, fy, fu, fv = paras[:, 0:1], paras[:, 1:2], paras[:, 2:3], paras[:, 3:4]
    x = (uvd[..., 0] - fu) * uvd[..., 2] / fx
    y = flip * (uvd[..., 1] - fv) * uvd[..., 2] / fy
    return torch.stack([x, y, uvd[..., 2]], dim=-1)


def points_3d_to_img(xyz: torch.Tensor, paras: torch.Tensor, flip: float = 1.0) -> torch.Tensor:
    """(B, N, 3) metric xyz -> pixel uvd."""
    fx, fy, fu, fv = paras[:, 0:1], paras[:, 1:2], paras[:, 2:3], paras[:, 3:4]
    u = xyz[..., 0] * fx / (xyz[..., 2] + 1e-8) + fu
    v = flip * xyz[..., 1] * fy / xyz[..., 2] + fv
    return torch.stack([u, v, xyz[..., 2]], dim=-1)


def inv3x3(M: torch.Tensor) -> torch.Tensor:
    """(B, 3, 3) -> its inverse: the adjugate over the determinant in
    float64, rounded to M's dtype."""
    m = M.double()
    a, b, c = m[:, 0, 0], m[:, 0, 1], m[:, 0, 2]
    d, e, f = m[:, 1, 0], m[:, 1, 1], m[:, 1, 2]
    g, h, i = m[:, 2, 0], m[:, 2, 1], m[:, 2, 2]
    co = torch.stack([e * i - f * h, c * h - b * i, b * f - c * e,
                      f * g - d * i, a * i - c * g, c * d - a * f,
                      d * h - e * g, b * g - a * h, a * e - b * d], dim=-1)
    det = a * co[:, 0] + b * co[:, 3] + c * co[:, 6]
    return (co / det[:, None]).reshape(-1, 3, 3).to(M.dtype)


def _trans_points(points: torch.Tensor, M: torch.Tensor) -> torch.Tensor:
    """Apply the 3x3 crop matrix to uv (get_trans_points)."""
    homo = torch.cat([points[..., 0:2], torch.ones_like(points[..., :1])], dim=-1)
    xy = torch.einsum("bij,bnj->bni", M, homo)[..., 0:2]
    return torch.cat([xy, points[..., 2:]], dim=-1)


def uvd_nl2xyznl(uvd: torch.Tensor, center: torch.Tensor, M: torch.Tensor,
                 cube: torch.Tensor, paras: torch.Tensor, img_size: int = 128,
                 flip: float = 1.0, normalize: bool = True) -> torch.Tensor:
    """(B, N, 3) normalized crop uvd -> normalized xyz (``normalize=False``:
    metric xyz)."""
    B = uvd.shape[0]
    cube_b = cube.reshape(B, 1, 3)
    center_b = center.reshape(B, 1, 3)
    uv_un = (uvd[..., 0:2] + 1.0) * (img_size / 2.0)
    d_un = uvd[..., 2:] * (cube_b[..., 2:] / 2.0) + center_b[..., 2:]
    uvd_img = _trans_points(torch.cat([uv_un, d_un], -1), inv3x3(M))
    xyz = points_img_to_3d(uvd_img, paras, flip)
    if not normalize:
        return xyz
    return (xyz - center_b) / (cube_b / 2.0)


def xyz_nl2uvdnl(xyz: torch.Tensor, center: torch.Tensor, M: torch.Tensor,
                 cube: torch.Tensor, paras: torch.Tensor, img_size: int = 128,
                 flip: float = 1.0) -> torch.Tensor:
    """(B, N, 3) normalized xyz -> normalized crop uvd."""
    B = xyz.shape[0]
    cube_b = cube.reshape(B, 1, 3)
    center_b = center.reshape(B, 1, 3)
    xyz_un = xyz * cube_b / 2.0 + center_b
    uvd_crop = _trans_points(points_3d_to_img(xyz_un, paras, flip), M)
    uv = uvd_crop[..., 0:2] / img_size * 2.0 - 1.0
    d = (uvd_crop[..., 2:] - center_b[..., 2:]) / (cube_b[..., 2:] / 2.0)
    return torch.cat([uv, d], dim=-1)


def _grid_axis(n: int, device) -> torch.Tensor:
    """Pixel centers along one axis, normalized to [-1, 1]."""
    return 2.0 * (torch.arange(n, dtype=torch.float32, device=device) + 0.5) / n - 1.0


def _pixel_uvd(img: torch.Tensor) -> torch.Tensor:
    """(B, H, W, 1) normalized depth crop -> (B, H*W, 3) pixel uvd grid
    (u varies along W, as the reference stacks (mesh_y, mesh_x))."""
    B, H, W, _ = img.shape
    ax = _grid_axis(W, img.device)
    gx = ax[None, :].expand(H, W)
    gy = ax[:, None].expand(H, W)
    grid = torch.stack([gx, gy], dim=-1).reshape(1, H * W, 2).expand(B, H * W, 2)
    return torch.cat([grid, img.reshape(B, H * W, 1)], dim=-1)


def img2pcl_index(pcl: torch.Tensor, img: torch.Tensor, center, M, cube, paras,
                  img_size: int = 128, select_num: int = 4,
                  flip: float = 1.0) -> Tuple[torch.Tensor, torch.Tensor]:
    """(closeness (B, N, k), index (B, N, k)): each point's ``select_num``
    nearest pixels of ``img`` (B, H, W, 1), nearest first."""
    img_xyz = uvd_nl2xyznl(_pixel_uvd(img), center, M, cube, paras, img_size, flip)
    d2, idx = smallest_k(pairwise_sqdist(pcl, img_xyz), select_num)
    closeness = 1.0 / (d2 + 1e-8)
    closeness = closeness / (closeness.sum(-1, keepdim=True) + 1e-8)
    return closeness, idx


def img2anchor_dis(joint_uvd: torch.Tensor, img: torch.Tensor, center, M, cube, paras,
                   img_size: int = 128, gamma: float = 10.0, flip: float = 1.0) -> torch.Tensor:
    """The GAM (B, J, H, W) of ``img`` (B, H, W, 1)."""
    B, J, _ = joint_uvd.shape
    H, W = img.shape[1], img.shape[2]
    joint_xyz = uvd_nl2xyznl(joint_uvd, center, M, cube, paras, img_size, flip)
    img_xyz = uvd_nl2xyznl(_pixel_uvd(img), center, M, cube, paras, img_size, flip)
    d2 = pairwise_sqdist(joint_xyz, img_xyz)
    return (1.0 / (gamma * d2 + 1.0)).reshape(B, J, H, W)


# --- dense offset maps -------------------------------------------------------

def _mesh_coords(B: int, feature_size: int, device) -> torch.Tensor:
    ax = _grid_axis(feature_size, device)
    gx = ax[None, :].expand(feature_size, feature_size)
    gy = ax[:, None].expand(feature_size, feature_size)
    return torch.stack([gx, gy], dim=0)[None].expand(B, 2, feature_size, feature_size)


def _resize_nearest_torch(x_nchw: torch.Tensor, fs: int) -> torch.Tensor:
    """F.interpolate(mode='nearest') as the JAX package writes it: source
    index floor(i * (H / fs)) in f32."""
    _, _, H, W = x_nchw.shape
    dev = x_nchw.device

    def src(n):
        i = np.floor(np.arange(fs, dtype=np.float32) * np.float32(n / fs)).astype(np.int64)
        return nn.constant(tuple(i.tolist()), torch.long, dev)

    return x_nchw[:, :, src(H)][:, :, :, src(W)]


def offset2joint_weight(offset_nchw: torch.Tensor, depth_nchw: torch.Tensor,
                        kernel_size: float = 0.8) -> torch.Tensor:
    """(B, 5J, fs, fs) offset maps + (B, 1, H, W) depth -> (B, J, 3) joints."""
    B, C, fs, _ = offset_nchw.shape
    J = C // 5
    if depth_nchw.shape[-1] != fs:
        depth_nchw = _resize_nearest_torch(depth_nchw, fs)
    offset_unit = offset_nchw[:, :J * 3]
    heatmap = offset_nchw[:, J * 3:J * 4]
    weight = offset_nchw[:, J * 4:]

    coords = torch.cat([_mesh_coords(B, fs, offset_nchw.device), depth_nchw], dim=1)
    coords = coords.repeat(1, J, 1, 1).reshape(B, J, 3, -1)
    mask = (depth_nchw < 0.99).to(offset_nchw.dtype)
    offset_mask = (offset_unit * mask).reshape(B, J, 3, -1)
    heatmap_mask = (heatmap * mask).reshape(B, J, -1)
    weight_mask = torch.where(depth_nchw > 0.99, -1e8, weight)
    normal_weight = nn.softmax(weight_mask.reshape(B, J, -1), dim=-1)
    dist = kernel_size - heatmap_mask * kernel_size
    return torch.sum((offset_mask * dist[:, :, None, :] + coords) * normal_weight[:, :, None, :],
                     dim=-1)


def joint2offset(joint: torch.Tensor, img_nchw: torch.Tensor, kernel_size: float,
                 feature_size: int) -> torch.Tensor:
    """(B, J, 3) + (B, 1, H, W) -> (B, 4J, fs, fs) offset maps."""
    B, J, _ = joint.shape
    fs = feature_size
    img = _resize_nearest_torch(img_nchw, fs)
    coords = torch.cat([_mesh_coords(B, fs, joint.device), img], dim=1)
    coords = coords.repeat(1, J, 1, 1).reshape(B, J, 3, fs, fs)
    offset = joint.reshape(B, J, 3, 1, 1) - coords
    dist = torch.sqrt(sqsum3(offset.movedim(2, -1)))
    offset_norm = offset / dist[:, :, None]
    heatmap = (kernel_size - dist) / kernel_size
    mask = (heatmap >= 0).to(img.dtype) * (img < 0.99).to(img.dtype).reshape(B, 1, fs, fs)
    offset_norm_mask = (offset_norm * mask[:, :, None]).reshape(B, J * 3, fs, fs)
    return torch.cat([offset_norm_mask, heatmap * mask], dim=1)


def pcl_joint2offset(joint: torch.Tensor, pcl: torch.Tensor,
                     kernel_size: float = 0.8) -> torch.Tensor:
    """(B, J, 3), (B, N, 3) -> (B, N, 4J) per-point offsets and distance."""
    offset = joint[:, :, None, :] - pcl[:, None, :, :]            # (B, J, N, 3)
    dis = torch.sqrt(sqsum3(offset))
    offset_norm = offset / (dis[..., None] + 1e-8)
    B, J, N, _ = offset.shape
    offset_norm = offset_norm.permute(0, 1, 3, 2).reshape(B, J * 3, N)
    heatmap = (kernel_size - dis) / kernel_size
    mask = (heatmap >= 0).to(joint.dtype) * (pcl[:, :, 2] < 0.99).to(joint.dtype)[:, None, :]
    out = torch.cat([offset_norm * mask.repeat_interleave(3, dim=1), heatmap * mask], dim=1)
    return out.permute(0, 2, 1)


def joint2heatmap(joint: torch.Tensor, std: float, heatmap_size: int,
                  sigma: float = 1.5) -> torch.Tensor:
    """(B, J, >=2) normalized joints -> (B, J, hs, hs) gaussians."""
    hs = heatmap_size
    mesh = torch.arange(hs, dtype=torch.float32, device=joint.device) + 0.5
    mx = mesh[None, :].expand(hs, hs)
    my = mesh[:, None].expand(hs, hs)
    jx = ((joint[..., 0] + 1.0) / 2.0 * hs)[:, :, None, None]
    jy = ((joint[..., 1] + 1.0) / 2.0 * hs)[:, :, None, None]
    return torch.exp(-(((mx - jx) / std) ** 2 + ((my - jy) / std) ** 2) / (2.0 * sigma ** 2))
