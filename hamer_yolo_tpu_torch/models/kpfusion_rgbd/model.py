"""Block_KPFusion and the 2-stage KPFusion (port of
hamer_yolo_tpu/models/kpfusion_rgbd/model.py).

Depth and RGB ResNet-UNet streams emit dense offset / heatmap / weight maps
and 128-d feature maps; the depth offsets decode to initial joints; point
features are gathered from both streams through the image -> cloud index;
each of the two stages runs DESA aggregation, an intra-modal BERT encoder
(init_TR), a heatmap- and GAM-gated RGB keypoint readout, a cross-modal
decoder (updatedDecoder) and a final BERT readout (final_TR) that refines
the joints.

Functions over a parameter tree, f32 throughout. Image tensors cross this
module in the reference's NCHW layout (moved once from the NHWC UNet
outputs), so every gather and flatten follows the reference's.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Tuple

import torch

from hamer_yolo_tpu_torch.core import nn
from hamer_yolo_tpu_torch.models.kpfusion_rgbd import geometry as G
from hamer_yolo_tpu_torch.models.kpfusion_rgbd.bert import (kp_interaction, kp_interaction_init,
                                                           small_linear_init)
from hamer_yolo_tpu_torch.models.kpfusion_rgbd.desa import desa_forward, desa_init
from hamer_yolo_tpu_torch.models.kpfusion_rgbd.resunet import unet_forward, unet_init
from hamer_yolo_tpu_torch.models.kpfusion_rgbd.transfusion import decoder_forward, decoder_init

Params = Dict[str, Any]
BN_EPS = 1e-5


@dataclass(frozen=True)
class KPFusionConfig:
    joint_num: int = 21
    dim: int = 128
    num_stages: int = 2
    img_size: int = 128       # crop resolution (config.py input_size)
    feature_size: int = 32    # UNet output stride 4
    kernel: float = 0.8       # feature_para[0]
    heads: int = 4
    sample_num: int = 1024    # point cloud size (config.py point_num)
    flip: float = 1.0


def _emb_init(gen: torch.Generator, c_in: int, c_out: int) -> Params:
    """Conv1d(k=1) + BN1d."""
    return {"conv": small_linear_init(gen, c_in, c_out),
            "bn": nn.batch_norm_init(c_out, gen.device)}


def _emb(p: Params, x: torch.Tensor) -> torch.Tensor:
    """(B, N, C_in) -> (B, N, C_out), channel-last conv1d + BN1d."""
    return nn.batch_norm(p["bn"], nn.linear(p["conv"], x), eps=BN_EPS)


def init_block(gen: torch.Generator, cfg: KPFusionConfig) -> Params:
    J, C = cfg.joint_num, cfg.dim
    return {
        "pcl_feat_emb": _emb_init(gen, C, C),
        "pcl_xyz_emb": _emb_init(gen, 3, C),
        "pcl_pose_emb": _emb_init(gen, J * 5, C),
        "joint_feat_emb": _emb_init(gen, C, C),
        "joint_xyz_emb": _emb_init(gen, 3, C),
        "pcl_feat_emb_RGB": _emb_init(gen, C, C),
        "FA": desa_init(gen, C, (C, C)),
        # hidden == C (the reference's hidden 128 with dim 128), so that
        # scaled-down configs stay consistent
        "init_TR": kp_interaction_init(gen, C, hidden=C),
        "final_TR": kp_interaction_init(gen, C + 3, hidden=C),
        "crossTR": decoder_init(gen, "updated", J, C, C, 4),
        "atten_spatial": small_linear_init(gen, C + J, J),
        "fc_spatial": small_linear_init(gen, cfg.feature_size ** 2, 1),
        "weight_dis": torch.zeros(1, device=gen.device),
    }


def block_forward(
    p: Params,
    cfg: KPFusionConfig,
    img_feat: torch.Tensor,          # (B, C, H, W) depth-stream features
    img_feat_rgb: torch.Tensor,      # (B, C, H, W)
    pcl: torch.Tensor,               # (B, N, 3)
    joint_xyz: torch.Tensor,         # (B, J, 3)
    pcl_closeness: torch.Tensor,     # (B, N, k)
    pcl_index: torch.Tensor,         # (B, N, k)
    img_offset: torch.Tensor,        # (B, 5J, fs, fs) depth offsets
    updated_2d_feature: Optional[torch.Tensor],
    img_down: torch.Tensor,          # (B, 1, H, W) nearest-downsampled depth
    center: torch.Tensor, M: torch.Tensor, cube: torch.Tensor, cam_para: torch.Tensor,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Block_KPFusion.forward -> (refined_3d, refined_2d, img_feat_j,
    spatial_weight)."""
    B, C, H, W = img_feat.shape
    J = cfg.joint_num
    N = pcl.shape[1]
    joint_xyz = joint_xyz.detach()
    pcl_offset_xyz = G.pcl_joint2offset(joint_xyz, pcl, cfg.kernel).detach()  # (B, N, 4J)

    # image features at the point-cloud pixels
    k = pcl_index.shape[-1]
    idx_flat = pcl_index.reshape(B, 1, N * k)

    def gather_feat(feat_bchw):
        Cp = feat_bchw.shape[1]
        flat = feat_bchw.reshape(B, Cp, H * W)
        g = torch.gather(flat, 2, idx_flat.expand(B, Cp, N * k)).reshape(B, Cp, N, k)
        return torch.sum(g * pcl_closeness[:, None], dim=-1).permute(0, 2, 1)  # (B, N, Cp)

    pcl_feat0 = gather_feat(img_feat)
    pcl_feat_rgb = gather_feat(img_feat_rgb)
    pcl_weight = gather_feat(img_offset[:, J * 4:]).detach()                  # (B, N, J)

    pcl_feat = torch.relu(_emb(p["pcl_feat_emb"], pcl_feat0) + _emb(p["pcl_xyz_emb"], pcl)
                          + _emb(p["pcl_pose_emb"],
                                 torch.cat([pcl_weight, pcl_offset_xyz], dim=-1)))
    pcl_feat = torch.relu(pcl_feat + _emb(p["pcl_feat_emb_RGB"], pcl_feat_rgb))

    attention = nn.softmax(pcl_weight.permute(0, 2, 1), dim=-1)
    joint_feat = attention @ pcl_feat                                          # (B, J, C)
    joint_feat = torch.relu(_emb(p["joint_feat_emb"], joint_feat)
                            + _emb(p["joint_xyz_emb"], joint_xyz))
    joint_feat = desa_forward(p["FA"], pcl_feat, joint_feat, pcl, joint_xyz)

    # intra-modal interaction
    out_init, refined_3d = kp_interaction(p["init_TR"], joint_feat, cfg.heads)

    # RGB keypoint aggregation gated by the heatmap and the GAM
    hm = G.joint2heatmap(refined_3d[:, :, :2], cfg.kernel, H, sigma=1.0)
    gam = G.img2anchor_dis(refined_3d, img_down.permute(0, 2, 3, 1), center, M, cube,
                           cam_para, cfg.img_size, flip=cfg.flip)
    sp_in = torch.cat([img_feat_rgb, hm], dim=1)                               # (B, C+J, H, W)
    sp_logit = torch.einsum("bchw,cj->bjhw", sp_in, p["atten_spatial"]["w"]) \
        + p["atten_spatial"]["b"][None, :, None, None]
    spatial_weight = torch.sigmoid(sp_logit)                                   # (B, J, H, W)
    w = torch.sigmoid(p["weight_dis"])[0]
    gate = w * gam[:, :, None] + (1.0 - w) * spatial_weight[:, :, None]
    rgb_j = torch.relu(gate * img_feat_rgb[:, None]).reshape(B, J, C, H * W)
    img_feat_j = (rgb_j @ p["fc_spatial"]["w"])[..., 0] + p["fc_spatial"]["b"]
    if updated_2d_feature is not None:
        img_feat_j = torch.relu((img_feat_j + updated_2d_feature) / 2.0)

    # inter-modal interaction
    refined_joint_feat = decoder_forward(p["crossTR"], "updated", img_feat_j, out_init,
                                         cfg.heads)
    refined_joint_feat = torch.cat([refined_3d, refined_joint_feat], dim=-1)
    _, refined_2d = kp_interaction(p["final_TR"], refined_joint_feat, cfg.heads)
    return refined_3d, refined_2d, img_feat_j, spatial_weight


def init_kpfusion(gen: torch.Generator, cfg: KPFusionConfig = KPFusionConfig()) -> Params:
    """Seeded random parameters on ``gen``'s device (the JAX initialisers'
    distributions, not their numbers)."""
    J = cfg.joint_num
    return {
        "backbone_rgb": unet_init(gen, J, 3, cfg.dim, [J * 3, J, J]),
        "backbone_d": unet_init(gen, J, 1, cfg.dim, [J * 3, J, J]),
        "blocks": [init_block(gen, cfg) for _ in range(cfg.num_stages)],
    }


def kpfusion_forward(
    params: Params,
    img_rgb: torch.Tensor,   # (B, 3, S, S) RGB crop in [0, 1] (NCHW)
    img: torch.Tensor,       # (B, 1, S, S) normalized depth crop in [-1, 1]
    pcl: torch.Tensor,       # (B, N, 3) normalized point cloud
    center: torch.Tensor, M: torch.Tensor, cube: torch.Tensor, cam_para: torch.Tensor,
    cfg: KPFusionConfig = KPFusionConfig(),
) -> Dict[str, Any]:
    """KPFusion.forward -> {"results": [depth offsets, RGB offsets, then each
    stage's refined_3d and refined_2d], "spatial_weights", "joint_uvd_init",
    "joints": the last stage's refined joints (B, J, 3)}."""
    off_d, feat_d = unet_forward(params["backbone_d"], img.permute(0, 2, 3, 1))
    off_rgb, feat_rgb = unet_forward(params["backbone_rgb"], img_rgb.permute(0, 2, 3, 1))
    img_offset = off_d.permute(0, 3, 1, 2)
    img_offset_rgb = off_rgb.permute(0, 3, 1, 2)
    img_feat = feat_d.permute(0, 3, 1, 2)
    img_feat_rgb = feat_rgb.permute(0, 3, 1, 2)

    joint_uvd = G.offset2joint_weight(img_offset, img, cfg.kernel).detach()
    img_offset_sg = img_offset.detach()

    img_down = G._resize_nearest_torch(img, img_feat.shape[2])
    joint_xyz = G.uvd_nl2xyznl(joint_uvd, center, M, cube, cam_para, cfg.img_size, cfg.flip)
    pcl_closeness, pcl_index = G.img2pcl_index(pcl, img_down.permute(0, 2, 3, 1), center, M,
                                               cube, cam_para, cfg.img_size, select_num=4,
                                               flip=cfg.flip)

    results: List[torch.Tensor] = [img_offset, img_offset_rgb]
    spatial_weights = []
    updated: Optional[torch.Tensor] = None
    for i in range(cfg.num_stages):
        r3d, r2d, updated, sw = block_forward(
            params["blocks"][i], cfg, img_feat, img_feat_rgb, pcl, joint_xyz, pcl_closeness,
            pcl_index, img_offset_sg, updated, img_down, center, M, cube, cam_para)
        results += [r3d, r2d]
        spatial_weights.append(sw)
        joint_xyz = r2d
    return {"results": results, "spatial_weights": spatial_weights,
            "joint_uvd_init": joint_uvd, "joints": results[-1]}
