"""HaMeR: ViT-H backbone + MANO head + MANO LBS (port of
hamer_yolo_tpu/models/hamer.py): center-crop 256x256 -> 256x192, ViT
tokens (the W8A8 int8 backbone with ``int8_backbone``, ToMe token merging
with ``tome_r``, or both), MANO head,
crop-space camera tz = 2 f / (IMAGE_SIZE s + 1e-9), MANO forward,
crop-space 2D projection with focal f / IMAGE_SIZE."""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable, Dict, Optional

import torch

from hamer_yolo_tpu_torch.core import nn
from hamer_yolo_tpu_torch.core.quant import vit_forward_int8
from hamer_yolo_tpu_torch.geometry.camera import cam_to_translation, perspective_projection
from hamer_yolo_tpu_torch.models.mano import ManoModel, mano_forward_rotmat
from hamer_yolo_tpu_torch.models.mano_head import ManoHeadConfig, init_mano_head, mano_head_forward
from hamer_yolo_tpu_torch.models.tome import vit_forward_tome
from hamer_yolo_tpu_torch.models.vit import ViTConfig, init_vit, vit_forward


@dataclass(frozen=True)
class HamerConfig:
    image_size: int = 256
    focal_length: float = 5000.0
    crop_margin: int = 32
    vit: ViTConfig = field(default_factory=ViTConfig)
    head: ManoHeadConfig = field(default_factory=ManoHeadConfig)
    # W8A8 int8 backbone (core/quant.py): params["backbone"] must hold
    # quantize_vit_params output, with or without attached static scales.
    int8_backbone: bool = False
    # The fused MANO LBS (kernel K9, ops/mano_lbs.py) in place of the einsums.
    fused_mano: bool = False
    # ToMe token merging (models/tome.py): tokens merged per ViT layer, 0 =
    # off. Composes with int8_backbone.
    tome_r: int = 0


def init_hamer(gen: torch.Generator, cfg: HamerConfig = HamerConfig()) -> nn.Params:
    return {"backbone": init_vit(gen, cfg.vit), "mano_head": init_mano_head(gen, cfg.head)}


def hamer_forward(params: nn.Params, mano_model: ManoModel, img: torch.Tensor,
                  cfg: HamerConfig = HamerConfig(),
                  attn_impl: Optional[Callable] = None) -> Dict[str, torch.Tensor]:
    """img (B, S, S, 3) normalised RGB crops (NHWC) -> the reference's output
    dict. ``attn_impl`` replaces the bf16 / f32 ViT's attention (vit_forward,
    vit_forward_tome); the int8 backbone picks its own (core/quant) and takes
    none."""
    B = img.shape[0]
    m = cfg.crop_margin
    if cfg.int8_backbone and cfg.tome_r <= 0 and attn_impl is not None:
        raise ValueError("hamer_forward: the int8 backbone takes no attn_impl (core/quant "
                         "picks its attention from HYT_ATTN)")
    if cfg.tome_r > 0:
        context = vit_forward_tome(params["backbone"], img[:, :, m:-m, :], cfg.vit,
                                   r_per_layer=cfg.tome_r, attn_impl=attn_impl)
    elif cfg.int8_backbone:
        context = vit_forward_int8(params["backbone"], img[:, :, m:-m, :], cfg.vit)
    else:
        context = vit_forward(params["backbone"], img[:, :, m:-m, :], cfg.vit,
                              attn_impl=attn_impl)
    pred_mano, pred_cam = mano_head_forward(params["mano_head"], context, cfg.head)
    pred_cam_t = cam_to_translation(pred_cam, cfg.focal_length, cfg.image_size)
    focal = torch.full((B, 2), cfg.focal_length, device=img.device)
    out = mano_forward_rotmat(mano_model, pred_mano["global_orient"], pred_mano["hand_pose"],
                              pred_mano["betas"], fused=cfg.fused_mano)
    kp2d = perspective_projection(out.joints, translation=pred_cam_t,
                                  focal_length=focal / cfg.image_size)
    return {
        "pred_cam": pred_cam,
        "pred_cam_t": pred_cam_t,
        "focal_length": focal,
        "pred_mano_params": pred_mano,
        "betas": pred_mano["betas"],
        "pred_vertices": out.vertices,
        "pred_keypoints_3d": out.joints,
        "pred_keypoints_2d": kp2d,
    }
