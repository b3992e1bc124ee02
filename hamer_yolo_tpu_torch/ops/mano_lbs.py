"""Kernel K9: fused MANO forward kinematics, blendshapes and skinning (port
of hamer_yolo_tpu/ops/mano_pallas.py).

``mano_lbs_fused`` is the fused equivalent of models/mano.lbs. On the card it
is one launch of ``csrc/mano_lbs.cu`` (all f32): each CTA computes its
hand's pose features and 16-joint forward kinematics, then the shape and
pose blendshapes, the blend of the joint transforms and the per-vertex
affine. The kinematics start from the factorisation

    j_rest = J_regressor @ v_template + (J_regressor @ shapedirs) . betas

(which rounds differently from lbs: it regresses the joints from v_shaped)
whose two per-model constants ``fk_constants`` makes once per model and
number of betas. The TPU kernel leaves the kinematics (``_fk``) to XLA
outside it, which fuses them; in eager torch their loop of small ops costs
some 90 launches, 43 times the kernel, so they run inside it. The work is
tiny (about 16 MFLOP and 1.6 MB for 16 hands), so the kernel is bound by its
launch.

``fk_ref`` is the plain version of the kernel's kinematics, in its order:
the constants, then the chain one depth level at a time (MANO's five
fingers, three levels deep below the root).
"""
from __future__ import annotations

from typing import Tuple

import torch

from hamer_yolo_tpu_torch.core import nn
from hamer_yolo_tpu_torch.ops import cuda_build

V = 778
J = 16
MAX_NB = 64  # of csrc/mano_lbs.cu


def fk_levels(parents) -> Tuple[Tuple[int, ...], ...]:
    """The joints at depth 1, 2, ... of the kinematic tree ``parents``
    (parents[0] = -1, every other parent an earlier joint)."""
    if len(parents) != J or parents[0] != -1 or any(not 0 <= parents[k] < k
                                                    for k in range(1, J)):
        raise ValueError(f"mano_lbs_fused: parents {tuple(parents)}: the root first, each "
                         "joint after its parent")
    depth = [0] * J
    for k in range(1, J):
        depth[k] = depth[parents[k]] + 1
    return tuple(tuple(k for k in range(J) if depth[k] == d) for d in range(1, max(depth) + 1))


def fk_constants(model, nb: int):
    """(jr_t (16, 3), jr_sd (16, 3, nb), parents (16,) int32), the per-model
    constants of the kinematics, on the model's device: made once per model
    (keyed by its J_regressor, v_template and shapedirs tensors) and number
    of betas; ``fk_constants.made`` counts them."""
    def make():
        fk_levels(model.parents)
        fk_constants.made += 1
        jr_t = model.J_regressor @ model.v_template
        jr_sd = torch.einsum("jv,vds->jds", model.J_regressor, model.shapedirs[..., :nb])
        parents = torch.tensor(model.parents, dtype=torch.int32,
                               device=model.J_regressor.device)
        return jr_t.contiguous(), jr_sd.contiguous(), parents

    return nn.derived(model.J_regressor,
                      ("mano_fk", nb, id(model.v_template), id(model.shapedirs)), make)


fk_constants.made = 0


def fk_ref(model, betas: torch.Tensor, rotmats: torch.Tensor
           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Forward kinematics in the kernel's order -> (A_flat (S, J, 12)
    [R row-major | t_skin], joints (S, J, 3))."""
    jr_t, jr_sd, _ = fk_constants(model, betas.shape[-1])
    j_rest = jr_t + torch.einsum("jds,bs->bjd", jr_sd, betas)  # (S, J, 3)
    rot, tr = [None] * J, [None] * J
    rot[0], tr[0] = rotmats[:, 0], j_rest[:, 0]
    for level in fk_levels(model.parents):
        ps = [model.parents[k] for k in level]
        r_p = torch.stack([rot[p] for p in ps], dim=1)  # (S, n, 3, 3)
        t_p = torch.stack([tr[p] for p in ps], dim=1)
        r_k = r_p @ rotmats[:, list(level)]
        t_rel = j_rest[:, list(level)] - j_rest[:, ps]
        t_k = (r_p @ t_rel[..., None])[..., 0] + t_p
        for i, k in enumerate(level):
            rot[k], tr[k] = r_k[:, i], t_k[:, i]
    A_rot = torch.stack(rot, dim=1)  # (S, J, 3, 3)
    joints = torch.stack(tr, dim=1)  # (S, J, 3)
    t_skin = joints - (A_rot @ j_rest[..., None])[..., 0]
    return torch.cat([A_rot.reshape(-1, J, 9), t_skin], dim=-1), joints


def _plain_inputs(model, betas: torch.Tensor, rotmats: torch.Tensor):
    """The blend's inputs of the plain version: (shapedirs (2334, nb),
    posedirs (2334, 135), pose features (S, 135), A_flat, joints)."""
    S, nb = betas.shape
    sd = model.shapedirs[..., :nb].reshape(V * 3, nb)
    pd = model.posedirs.reshape(V * 3, 135)
    eye = torch.eye(3, dtype=rotmats.dtype, device=rotmats.device)
    pose_feat = (rotmats[:, 1:] - eye).reshape(S, 135)
    A_flat, joints = fk_ref(model, betas, rotmats)
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
    sd, pd, pose_feat, A_flat, joints = _plain_inputs(model, betas, rotmats)
    return blend_skin_ref(betas, pose_feat, A_flat, model.v_template, sd, pd,
                          model.weights), joints


def mano_lbs_fused(model, betas: torch.Tensor, rotmats: torch.Tensor
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Fused equivalent of models/mano.lbs, the JAX signature: betas (S, nb),
    rotmats (S, 16, 3, 3) -> (vertices (S, 778, 3), joints (S, 16, 3)).

    CPU tensors take the plain version. CUDA tensors make one launch of
    ``csrc/mano_lbs.cu``: f32 betas and rotmats on the model's device, nb at
    most 64; anything else raises.
    """
    cuda_build.refuse_grad("mano_lbs_fused", betas, rotmats)
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
    if not all(t.is_contiguous() for t in (model.v_template, model.shapedirs, model.posedirs,
                                           model.weights)):
        raise ValueError(f"{what}: the model's arrays must be contiguous")
    S, nb = betas.shape
    if rotmats.shape != (S, J, 3, 3) or not 0 < nb <= min(MAX_NB, model.shapedirs.shape[-1]):
        raise ValueError(f"{what}: betas {tuple(betas.shape)}, rotmats {tuple(rotmats.shape)}")
    jr_t, jr_sd, parents = fk_constants(model, nb)
    betas, rotmats = betas.contiguous(), rotmats.contiguous()
    verts = torch.empty((S, V, 3), dtype=torch.float32, device=dev)
    joints = torch.empty((S, J, 3), dtype=torch.float32, device=dev)
    lib = cuda_build.load("mano_lbs.cu")
    idx = betas.get_device()
    with torch.cuda.device(idx):  # an index: less host work than a device
        stream = torch.cuda.current_stream(idx).cuda_stream
        cuda_build.check(lib.hyt_mano_lbs(
            betas.data_ptr(), rotmats.data_ptr(), jr_t.data_ptr(), jr_sd.data_ptr(),
            parents.data_ptr(), model.v_template.data_ptr(), model.shapedirs.data_ptr(),
            model.posedirs.data_ptr(), model.weights.data_ptr(), verts.data_ptr(),
            joints.data_ptr(), S, nb, model.shapedirs.shape[-1], stream),
            f"{what}: mano_lbs_kernel")
    mano_lbs_fused.launches += 1
    return verts, joints


mano_lbs_fused.launches = 0

# K9 against its plain version on the card: all f32, the sums of 135, of 16
# and of the kinematics' 3-term products taken in another order, on vertices
# and joints of about 0.1 m: errors of the order of 1e-7 m. The limit is
# absolute, in metres, a hundredth of the JAX package's own (1e-3,
# tests/test_pallas_kernels.py). A skinning transform with its translation
# left out moves vertices by centimetres
# (tests/test_torch_optin_kernels.py::TestLimits).
MAX_ABS_ERR_M = 1e-5


def check_against_plain(got: torch.Tensor, ref: torch.Tensor, what: str = "K9") -> dict:
    """Raise unless K9's vertices (or joints) ``got`` agree with the plain
    version's ``ref`` to the limit above; returns the reading."""
    r = {"max_abs_err": float((got - ref).abs().max())}
    if got.shape != ref.shape or not r["max_abs_err"] <= MAX_ABS_ERR_M:
        raise AssertionError(f"{what} disagrees with its plain version: {r} (limit: "
                             f"{MAX_ABS_ERR_M} m on every coordinate)")
    return r
