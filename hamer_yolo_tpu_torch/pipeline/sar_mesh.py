"""SAR's full mesh recovery on tensors (port of
hamer_yolo_tpu/pipeline/sar_mesh.py, the reference's EstimateRGB.run and
post_processing): per hand slot, RootNet's box -> SAR patch -> backbone ->
SAR head's 799 points (778 vertices, 21 joints) in normalised uvd -> the
full image and absolute camera xyz.

- z_abs = z * depth_box + root depth;
- uv in the crop = (uv + 0.5) * input_size: the reference adds 0.5 to the
  [-1, 1] value, an asymmetric mapping kept as it is;
- crop -> image through the inverse of the patch affine, then the
  left-right de-flip where a slot asks for it;
- the root depth from RootNet's k value, or sampled bilinearly from a depth
  image at the predicted root pixel (the reference's grid_sample path).
Geometry in f32; the backbone in the SAR config's compute dtype. Also the
mask-driven box of the masked runner (``bbox_from_mask``).
"""
from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np
import torch

from hamer_yolo_tpu_torch.geometry.affine import (bilinear_sample, gen_trans_from_patch,
                                                  invert_affine)
from hamer_yolo_tpu_torch.geometry.boxes import process_bbox
from hamer_yolo_tpu_torch.geometry.camera import calculate_k_value, uvd2xyz
from hamer_yolo_tpu_torch.models.sar import (SarConfig, rootnet_depth, sar_backbone_forward,
                                             sar_head_forward)
from hamer_yolo_tpu_torch.pipeline.preprocess import sar_patch

NUM_VERTS = 778


def decode_sar_uvd(coords: torch.Tensor, root_depth: torch.Tensor, bb2img: torch.Tensor,
                   img_width, do_flip: torch.Tensor, depth_box: float = 0.3,
                   input_size: int = 256) -> torch.Tensor:
    """(B, 799, 3) normalised uvd -> (B, 799, 3) full-image [u px, v px, z m]."""
    z = coords[..., 2] * depth_box + root_depth[:, None]
    uv_crop = (coords[..., :2] + 0.5) * input_size
    uv_full = torch.einsum("bij,bnj->bni", bb2img[:, :, :2], uv_crop) + bb2img[:, None, :, 2]
    width = torch.as_tensor(img_width, dtype=uv_full.dtype, device=uv_full.device)
    u = torch.where(do_flip.reshape(-1, 1) > 0.5, width.reshape(-1, 1) - uv_full[..., 0] - 1.0,
                    uv_full[..., 0])
    return torch.stack([u, uv_full[..., 1], z], dim=-1)


def sample_depth_at_root(depth_image: torch.Tensor, root_uv: torch.Tensor) -> torch.Tensor:
    """Bilinear depth at each root pixel: depth_image (H, W) m, root_uv (B, 2)
    px -> (B,)."""
    return bilinear_sample(depth_image[..., None], root_uv[:, 0], root_uv[:, 1])[:, 0]


def sar_full_mesh(sar_params, image_bgr: torch.Tensor, bbox_xyxy: torch.Tensor,
                  orig_hw: torch.Tensor, K: torch.Tensor, cfg: SarConfig = SarConfig(),
                  do_flip: Optional[torch.Tensor] = None,
                  depth_image: Optional[torch.Tensor] = None) -> Dict[str, torch.Tensor]:
    """EstimateRGB.run over S hand slots of one frame: image_bgr (H, W, 3)
    f32 0..255, bbox_xyxy (S, 4), orig_hw (2,), K (3, 3), do_flip (S,),
    depth_image (H, W) in m -> mesh_uvd (S, 778, 3), pose_uvd (S, 21, 3),
    mesh_xyz, pose_xyz and root_depth (S,)."""
    S, dev = bbox_xyxy.shape[0], bbox_xyxy.device
    if do_flip is None:
        do_flip = torch.zeros(S, device=dev)
    b = bbox_xyxy
    xywh = torch.stack([b[:, 0], b[:, 1], b[:, 2] - b[:, 0], b[:, 3] - b[:, 1]], dim=-1)
    size = float(cfg.input_size)
    pb, _ = process_bbox(xywh, orig_hw[1], orig_hw[0], (size, size), 1.5)
    patches = sar_patch(image_bgr[None], pb[None], cfg.input_size)[0]

    feats = sar_backbone_forward(sar_params, patches, cfg)
    coords = sar_head_forward(sar_params["head"], feats, cfg)  # (S, 799, 3)

    img2bb = gen_trans_from_patch(pb[:, 0] + pb[:, 2] / 2.0, pb[:, 1] + pb[:, 3] / 2.0,
                                  pb[:, 2], pb[:, 3], size, size)
    bb2img = invert_affine(img2bb)
    if depth_image is not None:
        root_uv_crop = (coords[:, NUM_VERTS, :2] + 0.5) * cfg.input_size
        uv1 = torch.cat([root_uv_crop, torch.ones(S, 1, device=dev)], dim=-1)
        root_uv = torch.einsum("bij,bj->bi", bb2img, uv1)
        root_depth = sample_depth_at_root(depth_image, root_uv)
    else:
        k_val = calculate_k_value(pb[:, 2:4], K[0, 0], K[1, 1],
                                  real_area=cfg.bbox_real[0] * cfg.bbox_real[1])
        root_depth = rootnet_depth(sar_params, feats, k_val)

    uvd_full = decode_sar_uvd(coords, root_depth, bb2img, orig_hw[1], do_flip,
                              cfg.bbox_real[0], cfg.input_size)
    xyz = uvd2xyz(uvd_full, K)
    return {"mesh_uvd": uvd_full[:, :NUM_VERTS], "pose_uvd": uvd_full[:, NUM_VERTS:],
            "mesh_xyz": xyz[:, :NUM_VERTS], "pose_xyz": xyz[:, NUM_VERTS:],
            "root_depth": root_depth}


def bbox_from_mask(mask, target_val: int = 3) -> Optional[List[float]]:
    """The reference's get_bbox_from_npy: (H, W) mask -> [x1, y1, x2, y2] of
    the pixels equal to ``target_val`` (inclusive pixel bounds), or None."""
    rows, cols = np.where(np.asarray(mask) == target_val)
    if len(rows) == 0:
        return None
    return [float(cols.min()), float(rows.min()), float(cols.max()), float(rows.max())]
