"""MANO hand model: LBS forward on tensors (port of hamer_yolo_tpu/models/mano.py).

``mano_forward_rotmat``: smplx.MANOLayer's convention as HaMeR uses it:
rotation-matrix pose input, meters, 16 regressed joints + 5 fingertip
vertices, OpenPose order. The LBS is the einsum form (``lbs``) unless
``fused`` asks for kernel K9 (ops/mano_lbs.py), which is opt-in as in the
JAX package. ``mano_forward_manopth``: manopth.ManoLayer's convention
(axis-angle or PCA pose, millimeters, manopth's fingertips), which
KeypointFusion's MANO head uses.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch

from hamer_yolo_tpu_torch.core import nn
from hamer_yolo_tpu_torch.geometry.rotations import aa_to_rotmat

MANO_TO_OPENPOSE = (0, 13, 14, 15, 16, 1, 2, 3, 17, 4, 5, 6, 18, 10, 11, 12, 19, 7, 8, 9, 20)
SMPLX_TIP_IDS = (744, 320, 443, 554, 671)
MANOPTH_TIP_IDS_RIGHT = (745, 317, 444, 556, 673)
MANOPTH_TIP_IDS_LEFT = (745, 317, 445, 556, 673)


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
    hands_components: Optional[torch.Tensor] = None  # (45, 45) PCA basis (manopth)
    hands_mean: Optional[torch.Tensor] = None        # (45,)
    side: str = "right"

    @classmethod
    def from_arrays(cls, data: Dict[str, np.ndarray], device="cpu",
                    side: str = "right") -> "ManoModel":
        def t(k):
            return torch.as_tensor(np.asarray(data[k], np.float32), device=device)

        return cls(v_template=t("v_template"), shapedirs=t("shapedirs"), posedirs=t("posedirs"),
                   J_regressor=t("J_regressor"), weights=t("weights"),
                   faces=np.asarray(data["f"], np.int32),
                   parents=tuple(int(p) for p in data["kintree_parents"]),
                   hands_components=t("hands_components") if "hands_components" in data else None,
                   hands_mean=t("hands_mean") if "hands_mean" in data else None, side=side)


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


def mano_forward_manopth(model: ManoModel, pose_coeffs: torch.Tensor,
                         betas: Optional[torch.Tensor] = None,
                         trans: Optional[torch.Tensor] = None, use_pca: bool = False,
                         ncomps: int = 45, flat_hand_mean: bool = True,
                         center_idx: Optional[int] = None,
                         root_palm: bool = False) -> ManoOutput:
    """manopth.ManoLayer's forward: pose_coeffs (B, 3 + ncomps), the root's
    axis-angle and the hand pose (PCA coefficients with ``use_pca``). Output
    in MILLIMETERS, manopth's fingertips, OpenPose joint order."""
    B = pose_coeffs.shape[0]
    hand = pose_coeffs[:, 3:3 + ncomps]
    if use_pca:
        hand = hand @ model.hands_components[:ncomps]
    if not flat_hand_mean:
        hand = hand + model.hands_mean
    rotmats = aa_to_rotmat(torch.cat([pose_coeffs[:, :3], hand], dim=1).reshape(B, 16, 3))
    if betas is None:
        betas = torch.zeros((B, 10), dtype=pose_coeffs.dtype, device=pose_coeffs.device)
    verts, joints16 = lbs(model, betas, rotmats)
    tip_ids = MANOPTH_TIP_IDS_RIGHT if model.side == "right" else MANOPTH_TIP_IDS_LEFT
    tips = verts[:, nn.constant(tip_ids, torch.long, verts.device)]
    if root_palm:
        palm = (verts[:, 95] + verts[:, 22])[:, None] / 2.0
        joints16 = torch.cat([palm, joints16[:, 1:]], dim=1)
    joints = torch.cat([joints16, tips], dim=1)[:, nn.constant(MANO_TO_OPENPOSE, torch.long,
                                                               verts.device)]
    if trans is not None:
        joints = joints + trans[:, None]
        verts = verts + trans[:, None]
    elif center_idx is not None:
        center = joints[:, center_idx:center_idx + 1]
        joints = joints - center
        verts = verts - center
    return ManoOutput(vertices=verts * 1000.0, joints=joints * 1000.0)


def sar_joint_regressor(model: ManoModel) -> torch.Tensor:
    """(21, 778) regressor from vertices to OpenPose-ordered joints (the
    reference's rootnet/mano.py:20-26): the 16-joint J_regressor and the
    fingertip one-hots [745, 317, 445, 556, 673], reordered. The reference
    takes 445 for the middle tip even for the right hand, and so does this."""
    V = model.J_regressor.shape[1]
    tips = torch.zeros((5, V), dtype=model.J_regressor.dtype, device=model.J_regressor.device)
    for i, vid in enumerate((745, 317, 445, 556, 673)):
        tips[i, vid] = 1.0
    return torch.cat([model.J_regressor, tips], dim=0)[list(MANO_TO_OPENPOSE)]


def mano_template(model: ManoModel) -> torch.Tensor:
    """(778, 3) template vertices (SAIGB's per-vertex positional feature)."""
    return model.v_template


def watertight_closure_faces() -> np.ndarray:
    """The 14 hand-authored triangles sealing the MANO wrist for OBJ export."""
    return np.array([
        [92, 38, 122], [234, 92, 122], [239, 234, 122], [279, 239, 122],
        [215, 279, 122], [215, 122, 118], [215, 118, 117], [215, 117, 119],
        [215, 119, 120], [215, 120, 108], [215, 108, 79], [215, 79, 78],
        [215, 78, 121], [214, 215, 121],
    ], np.int32)
