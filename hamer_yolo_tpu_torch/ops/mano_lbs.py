"""Kernel K9: fused MANO blendshapes + skinning (port of
hamer_yolo_tpu/ops/mano_pallas.py).

``mano_lbs_fused`` is the fused equivalent of models/mano.lbs: the shape and
pose blendshapes, the blend of the 16 joint transforms and the per-vertex
affine run in one kernel (``csrc/mano_lbs.cu``, all f32); the 16-step forward
kinematics stays outside it in plain torch (``_fk``), fed by the factorisation

    j_rest = J_regressor @ v_template + (J_regressor @ shapedirs) . betas

which rounds differently from lbs (it regresses the joints from v_shaped).

On the card the work is tiny (about 16 MFLOP and 1.6 MB for 16 hands), so the
kernel is bound by its launch, and ``_fk``'s loop of small einsums (some 90
launches) costs more than the kernel. Folding the kinematics into the kernel
is later work; the TPU kernel keeps it outside too.
"""
from __future__ import annotations

from typing import Tuple

import torch

from hamer_yolo_tpu_torch.ops import cuda_build

V = 778
J = 16
MAX_NB = 64  # of csrc/mano_lbs.cu


def _fk(model, betas: torch.Tensor, rotmats: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Forward kinematics -> (A_flat (S, J, 12) [R row-major | t_skin],
    joints (S, J, 3))."""
    jr_t = model.J_regressor @ model.v_template  # (J, 3)
    jr_sd = torch.einsum("jv,vds->jds", model.J_regressor, model.shapedirs[..., :betas.shape[-1]])
    j_rest = jr_t + torch.einsum("jds,bs->bjd", jr_sd, betas)  # (S, J, 3)
    rot, tr = [rotmats[:, 0]], [j_rest[:, 0]]
    for k in range(1, J):
        p = model.parents[k]
        t_rel = j_rest[:, k] - j_rest[:, p]
        rot.append(torch.einsum("bij,bjk->bik", rot[p], rotmats[:, k]))
        tr.append(torch.einsum("bij,bj->bi", rot[p], t_rel) + tr[p])
    A_rot = torch.stack(rot, dim=1)  # (S, J, 3, 3)
    joints = torch.stack(tr, dim=1)  # (S, J, 3)
    t_skin = joints - torch.einsum("bkij,bkj->bki", A_rot, j_rest)
    return torch.cat([A_rot.reshape(-1, J, 9), t_skin], dim=-1), joints


def _kernel_inputs(model, betas: torch.Tensor, rotmats: torch.Tensor):
    S, nb = betas.shape
    sd = model.shapedirs[..., :nb].reshape(V * 3, nb)
    pd = model.posedirs.reshape(V * 3, 135)
    eye = torch.eye(3, dtype=rotmats.dtype, device=rotmats.device)
    pose_feat = (rotmats[:, 1:] - eye).reshape(S, 135)
    A_flat, joints = _fk(model, betas, rotmats)
    return sd, pd, pose_feat, A_flat, joints


def blend_skin_ref(betas, pose_feat, A_flat, v_template, sd, pd, weights) -> torch.Tensor:
    """Plain version of the kernel body (_mano_blend_skin_kernel), in its op
    order: -> vertices (S, 778, 3)."""
    S = betas.shape[0]
    v_shaped = v_template + (betas @ sd.T).reshape(S, V, 3)
    v_posed = v_shaped + (pose_feat @ pd.T).reshape(S, V, 3)
    T = torch.einsum("vk,bkj->bvj", weights, A_flat)  # (S, V, 12)
    x, y, z = v_posed[..., 0], v_posed[..., 1], v_posed[..., 2]
    return torch.stack([T[..., 3 * c] * x + T[..., 3 * c + 1] * y + T[..., 3 * c + 2] * z
                        + T[..., 9 + c] for c in range(3)], dim=-1)


def mano_lbs_fused_ref(model, betas: torch.Tensor, rotmats: torch.Tensor
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of K9: betas (S, nb), rotmats (S, 16, 3, 3) ->
    (vertices (S, 778, 3), joints (S, 16, 3))."""
    sd, pd, pose_feat, A_flat, joints = _kernel_inputs(model, betas, rotmats)
    return blend_skin_ref(betas, pose_feat, A_flat, model.v_template, sd, pd,
                          model.weights), joints


def mano_lbs_fused(model, betas: torch.Tensor, rotmats: torch.Tensor
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Fused equivalent of models/mano.lbs, the JAX signature: betas (S, nb),
    rotmats (S, 16, 3, 3) -> (vertices (S, 778, 3), joints (S, 16, 3)).

    CPU tensors take the plain version. CUDA tensors launch
    ``csrc/mano_lbs.cu``: f32 betas and rotmats on the model's device, nb at
    most 64; anything else raises.
    """
    if betas.device.type == "cpu":
        return mano_lbs_fused_ref(model, betas, rotmats)
    what = "mano_lbs_fused"
    dev = betas.device
    if dev.type != "cuda":
        raise ValueError(f"{what}: unsupported device {dev}")
    if betas.dtype != torch.float32 or rotmats.dtype != torch.float32:
        raise ValueError(f"{what}: the kernel takes f32 betas and rotmats, got {betas.dtype} "
                         f"and {rotmats.dtype}")
    if rotmats.device != dev or model.posedirs.device != dev:
        raise ValueError(f"{what}: betas on {dev}, rotmats on {rotmats.device}, the model on "
                         f"{model.posedirs.device}")
    S, nb = betas.shape
    if rotmats.shape != (S, J, 3, 3) or not 0 < nb <= min(MAX_NB, model.shapedirs.shape[-1]):
        raise ValueError(f"{what}: betas {tuple(betas.shape)}, rotmats {tuple(rotmats.shape)}")
    sd, pd, pose_feat, A_flat, joints = _kernel_inputs(model, betas, rotmats)
    verts = launch_blend_skin(betas, pose_feat, A_flat, model.v_template, sd, pd, model.weights)
    mano_lbs_fused.launches += 1
    return verts, joints


def launch_blend_skin(betas, pose_feat, A_flat, v_template, sd, pd, weights) -> torch.Tensor:
    """Launch csrc/mano_lbs.cu on f32 CUDA tensors (the arguments of
    blend_skin_ref): -> vertices (S, 778, 3)."""
    S, nb = betas.shape
    verts = torch.empty((S, V, 3), dtype=torch.float32, device=betas.device)
    args = [t.contiguous() for t in (betas, pose_feat, A_flat, v_template, sd, pd, weights)]
    lib = cuda_build.load("mano_lbs.cu")
    with torch.cuda.device(betas.device):
        stream = torch.cuda.current_stream().cuda_stream
        cuda_build.check(lib.hyt_mano_lbs(*(t.data_ptr() for t in args), verts.data_ptr(), S, nb,
                                          stream), "mano_lbs_fused: mano_blend_skin_kernel")
    return verts


mano_lbs_fused.launches = 0

# K9 against its plain version on the card: all f32, the sums of 135 and of
# 16 terms taken in another order, on vertices of about 0.1 m: errors of the
# order of 1e-7 m. The limit is absolute, in metres, a hundredth of the JAX
# package's own (1e-3, tests/test_pallas_kernels.py). A skinning transform
# with its translation left out moves vertices by centimetres
# (tests/test_torch_optin_kernels.py::TestLimits).
MAX_ABS_ERR_M = 1e-5


def check_against_plain(got: torch.Tensor, ref: torch.Tensor, what: str = "K9") -> dict:
    """Raise unless K9's vertices ``got`` agree with the plain version's
    ``ref`` to the limit above; returns the reading."""
    r = {"max_abs_err": float((got - ref).abs().max())}
    if got.shape != ref.shape or not r["max_abs_err"] <= MAX_ABS_ERR_M:
        raise AssertionError(f"{what} disagrees with its plain version: {r} (limit: "
                             f"{MAX_ABS_ERR_M} m on every vertex coordinate)")
    return r
