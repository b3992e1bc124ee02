"""KeypointFusion's MANO regression head (port of
hamer_yolo_tpu/models/kpfusion_rgbd/mano_head.py).

``mano_regHead``: a backbone feature -> LeakyReLU MLP -> 16 x 6d pose + 10
shape -> rot6d -> rotation matrix -> axis-angle -> manopth's ManoLayer
(flat_hand_mean, no PCA, millimeters; models/mano.mano_forward_manopth) ->
778 vertices and 21 joints in OBMAN's order. The shipped RGB-D runtime does
not use it; it is the mesh-output head of the AWR family.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, Tuple

import torch
import torch.nn.functional as F

from hamer_yolo_tpu_torch.core import nn
from hamer_yolo_tpu_torch.geometry.rotations import rot6d_to_rotmat, rotmat_to_aa
from hamer_yolo_tpu_torch.models.mano import ManoModel, mano_forward_manopth

# manolayer's joint order -> OBMAN's
OBMAN2MANO = (0, 5, 6, 7, 9, 10, 11, 17, 18, 19, 13, 14, 15, 1, 2, 3, 8, 12, 20, 16, 4)
# AWR's fingertip vertex ids (the reference's 26-row J_regressor; for eval tools)
AWR_FINGERTIP_VERTEX_IDS = (728, 353, 442, 576, 694)


@dataclass(frozen=True)
class ManoRegConfig:
    feature_size: int = 1024
    neurons: Tuple[int, ...] = (1024, 512)  # mano_neurons
    n_pose: int = 16


def init_mano_reg(gen: torch.Generator, cfg: ManoRegConfig = ManoRegConfig()) -> Dict[str, Any]:
    dims = (cfg.feature_size,) + tuple(cfg.neurons)
    return {"base": [nn.linear_init(gen, i, o) for i, o in zip(dims[:-1], dims[1:])],
            "pose_reg": nn.linear_init(gen, dims[-1], cfg.n_pose * 6),
            "shape_reg": nn.linear_init(gen, dims[-1], 10)}


def mano_reg_forward(params: Dict[str, Any], features: torch.Tensor, mano_model: ManoModel,
                     cfg: ManoRegConfig = ManoRegConfig()) -> Dict[str, torch.Tensor]:
    """(B, feature_size) -> verts3d (B, 778, 3) mm, joints3d (B, 21, 3) in
    OBMAN order, mano_shape (B, 10), mano_pose (B, 16, 3, 3), mano_pose_aa
    (B, 48): the reference's pred_mano_results."""
    x = features
    for lin in params["base"]:
        x = F.leaky_relu(nn.linear(lin, x), negative_slope=0.01)
    pose6d = nn.linear(params["pose_reg"], x)
    shape = nn.linear(params["shape_reg"], x)
    rotmat = rot6d_to_rotmat(pose6d.reshape(-1, cfg.n_pose, 6))
    aa = rotmat_to_aa(rotmat).reshape(-1, cfg.n_pose * 3)
    out = mano_forward_manopth(mano_model, aa, betas=shape, use_pca=False, flat_hand_mean=True)
    return {"verts3d": out.vertices,
            "joints3d": out.joints[:, nn.constant(OBMAN2MANO, torch.long, out.joints.device)],
            "mano_shape": shape, "mano_pose": rotmat, "mano_pose_aa": aa}
