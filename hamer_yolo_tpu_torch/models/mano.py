"""MANO hand model: LBS forward on tensors (port of hamer_yolo_tpu/models/mano.py).

smplx.MANOLayer convention as HaMeR uses it: rotation-matrix pose input,
meters, 16 regressed joints + 5 fingertip vertices, OpenPose order. The
LBS is the einsum form (``lbs``) unless ``fused`` asks for kernel K9
(ops/mano_lbs.py), which is opt-in as in the JAX package.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, NamedTuple, Tuple

import numpy as np
import torch

from hamer_yolo_tpu_torch.core import nn

MANO_TO_OPENPOSE = (0, 13, 14, 15, 16, 1, 2, 3, 17, 4, 5, 6, 18, 10, 11, 12, 19, 7, 8, 9, 20)
SMPLX_TIP_IDS = (744, 320, 443, 554, 671)


@dataclass(frozen=True)
class ManoModel:
    """MANO arrays as tensors on one device."""

    v_template: torch.Tensor      # (778, 3)
    shapedirs: torch.Tensor       # (778, 3, S)
    posedirs: torch.Tensor        # (778, 3, 135)
    J_regressor: torch.Tensor     # (16, 778)
    weights: torch.Tensor         # (778, 16)
    faces: np.ndarray             # (1538, 3) int32, host side (OBJ export)
    parents: Tuple[int, ...]      # static kinematic tree

    @classmethod
    def from_arrays(cls, data: Dict[str, np.ndarray], device="cpu") -> "ManoModel":
        def t(k):
            return torch.as_tensor(np.asarray(data[k], np.float32), device=device)

        return cls(v_template=t("v_template"), shapedirs=t("shapedirs"), posedirs=t("posedirs"),
                   J_regressor=t("J_regressor"), weights=t("weights"),
                   faces=np.asarray(data["f"], np.int32),
                   parents=tuple(int(p) for p in data["kintree_parents"]))


def lbs(model: ManoModel, betas: torch.Tensor, rotmats: torch.Tensor
        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """betas (B, S'), rotmats (B, 16, 3, 3) -> (vertices (B, 778, 3), joints (B, 16, 3))."""
    B = rotmats.shape[0]
    nb = betas.shape[-1]
    v_shaped = model.v_template + torch.einsum("vds,bs->bvd", model.shapedirs[..., :nb], betas)
    j_rest = torch.einsum("jv,bvd->bjd", model.J_regressor, v_shaped)
    eye = torch.eye(3, dtype=rotmats.dtype, device=rotmats.device)
    pose_feature = (rotmats[:, 1:] - eye).reshape(B, 135)
    v_posed = v_shaped + torch.einsum("vdp,bp->bvd", model.posedirs, pose_feature)

    # Forward kinematics along the static parent chain:
    # A[k] = A[parent] @ [R_k | j_k - j_parent].
    transforms = [torch.cat([rotmats[:, 0], j_rest[:, 0, :, None]], dim=-1)]
    for k in range(1, 16):
        p = model.parents[k]
        t_rel = j_rest[:, k] - j_rest[:, p]
        parent = transforms[p]
        rot = torch.einsum("bij,bjk->bik", parent[:, :, :3], rotmats[:, k])
        tr = torch.einsum("bij,bj->bi", parent[:, :, :3], t_rel) + parent[:, :, 3]
        transforms.append(torch.cat([rot, tr[:, :, None]], dim=-1))
    A = torch.stack(transforms, dim=1)  # (B, 16, 3, 4)
    joints = A[:, :, :, 3]
    t_skin = joints - torch.einsum("bkij,bkj->bki", A[:, :, :, :3], j_rest)
    R_blend = torch.einsum("vk,bkij->bvij", model.weights, A[:, :, :, :3])
    t_blend = torch.einsum("vk,bki->bvi", model.weights, t_skin)
    verts = torch.einsum("bvij,bvj->bvi", R_blend, v_posed) + t_blend
    return verts, joints


class ManoOutput(NamedTuple):
    vertices: torch.Tensor  # (B, 778, 3)
    joints: torch.Tensor    # (B, 21, 3) OpenPose order


def mano_forward_rotmat(model: ManoModel, global_orient: torch.Tensor,
                        hand_pose: torch.Tensor, betas: torch.Tensor,
                        fused: bool = False) -> ManoOutput:
    """global_orient (B, 1, 3, 3), hand_pose (B, 15, 3, 3), betas (B, 10).
    ``fused`` routes through the single-kernel LBS (K9, ops/mano_lbs.py)."""
    rotmats = torch.cat([global_orient, hand_pose], dim=1)
    if fused:
        from hamer_yolo_tpu_torch.ops.mano_lbs import mano_lbs_fused

        verts, joints16 = mano_lbs_fused(model, betas, rotmats)
    else:
        verts, joints16 = lbs(model, betas, rotmats)
    # index tensors made once (nn.constant): a list index is copied from the host
    tips = verts[:, nn.constant(SMPLX_TIP_IDS, torch.long, verts.device)]
    joints = torch.cat([joints16, tips], dim=1)[:, nn.constant(MANO_TO_OPENPOSE, torch.long,
                                                               verts.device)]
    return ManoOutput(vertices=verts, joints=joints)


def watertight_closure_faces() -> np.ndarray:
    """The 14 hand-authored triangles sealing the MANO wrist for OBJ export."""
    return np.array([
        [92, 38, 122], [234, 92, 122], [239, 234, 122], [279, 239, 122],
        [215, 279, 122], [215, 122, 118], [215, 118, 117], [215, 117, 119],
        [215, 119, 120], [215, 120, 108], [215, 108, 79], [215, 79, 78],
        [215, 78, 121], [214, 215, 121],
    ], np.int32)
