"""Rotation conversions on tensors (port of hamer_yolo_tpu/geometry/rotations.py).

``aa_to_rotmat`` (via quaternion, with the reference's +1e-8 pre-norm
regulariser), ``rot6d_to_rotmat`` (Gram-Schmidt, column-stacked),
``rotmat_to_aa`` (branchless max-pivot quaternion, then Rodrigues inverse),
``rotmat_orthonormalize`` (the nearest rotation by SVD) and the Euler
conversions of KeypointFusion's convention library (pytorch3d's intrinsic
semantics: a 3-letter convention c0 c1 c2 is R = R_c0(a0) R_c1(a1) R_c2(a2)).
All accept arbitrary leading batch dims.
"""
from __future__ import annotations

import torch


def quat_to_rotmat(quat: torch.Tensor) -> torch.Tensor:
    """(..., 4) wxyz quaternion -> (..., 3, 3) rotation matrix."""
    q = quat / torch.linalg.norm(quat, dim=-1, keepdim=True)
    w, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    w2, x2, y2, z2 = w * w, x * x, y * y, z * z
    wx, wy, wz = w * x, w * y, w * z
    xy, xz, yz = x * y, x * z, y * z
    rot = torch.stack([
        w2 + x2 - y2 - z2, 2 * xy - 2 * wz, 2 * wy + 2 * xz,
        2 * wz + 2 * xy, w2 - x2 + y2 - z2, 2 * yz - 2 * wx,
        2 * xz - 2 * wy, 2 * wx + 2 * yz, w2 - x2 - y2 + z2,
    ], dim=-1)
    return rot.reshape(quat.shape[:-1] + (3, 3))


def aa_to_rotmat(theta: torch.Tensor) -> torch.Tensor:
    """(..., 3) axis-angle -> (..., 3, 3); angle = |theta + 1e-8|."""
    angle = torch.linalg.norm(theta + 1e-8, dim=-1, keepdim=True)
    normalized = theta / angle
    half = angle * 0.5
    quat = torch.cat([torch.cos(half), torch.sin(half) * normalized], dim=-1)
    return quat_to_rotmat(quat)


def rot6d_to_rotmat(x: torch.Tensor) -> torch.Tensor:
    """(..., 6) continuous 6D rotation -> (..., 3, 3), columns (b1, b2, b1 x b2)."""
    m = x.reshape(x.shape[:-1] + (2, 3))
    a1, a2 = m[..., 0, :], m[..., 1, :]
    eps = 1e-12
    b1 = a1 / torch.clamp(torch.linalg.norm(a1, dim=-1, keepdim=True), min=eps)
    proj = torch.sum(b1 * a2, dim=-1, keepdim=True)
    u2 = a2 - proj * b1
    b2 = u2 / torch.clamp(torch.linalg.norm(u2, dim=-1, keepdim=True), min=eps)
    b3 = torch.linalg.cross(b1, b2, dim=-1)
    return torch.stack([b1, b2, b3], dim=-1)


def rotmat_to_quat(rot: torch.Tensor) -> torch.Tensor:
    """(..., 3, 3) rotation -> (..., 4) wxyz quaternion with w >= 0."""
    m00, m01, m02 = rot[..., 0, 0], rot[..., 0, 1], rot[..., 0, 2]
    m10, m11, m12 = rot[..., 1, 0], rot[..., 1, 1], rot[..., 1, 2]
    m20, m21, m22 = rot[..., 2, 0], rot[..., 2, 1], rot[..., 2, 2]
    zero = torch.zeros_like(m00)
    qw_sq = torch.maximum(zero, 1.0 + m00 + m11 + m22)
    qx_sq = torch.maximum(zero, 1.0 + m00 - m11 - m22)
    qy_sq = torch.maximum(zero, 1.0 - m00 + m11 - m22)
    qz_sq = torch.maximum(zero, 1.0 - m00 - m11 + m22)
    cw = torch.stack([qw_sq, m21 - m12, m02 - m20, m10 - m01], dim=-1)
    cx = torch.stack([m21 - m12, qx_sq, m01 + m10, m02 + m20], dim=-1)
    cy = torch.stack([m02 - m20, m01 + m10, qy_sq, m12 + m21], dim=-1)
    cz = torch.stack([m10 - m01, m02 + m20, m12 + m21, qz_sq], dim=-1)
    idx = torch.argmax(torch.stack([qw_sq, qx_sq, qy_sq, qz_sq], dim=-1), dim=-1)
    cand = torch.stack([cw, cx, cy, cz], dim=-2)  # (..., 4 candidates, 4)
    q = torch.gather(cand, -2, idx[..., None, None].expand(idx.shape + (1, 4)))[..., 0, :]
    q = q / torch.clamp(torch.linalg.norm(q, dim=-1, keepdim=True), min=1e-12)
    return q * torch.where(q[..., :1] < 0, -1.0, 1.0)


def rotmat_to_aa(rot: torch.Tensor) -> torch.Tensor:
    """(..., 3, 3) rotation -> (..., 3) axis-angle."""
    q = rotmat_to_quat(rot)
    w = torch.clamp(q[..., 0], -1.0, 1.0)
    xyz = q[..., 1:]
    sin_half = torch.linalg.norm(xyz, dim=-1, keepdim=True)
    angle = 2.0 * torch.atan2(sin_half[..., 0], w)[..., None]
    axis = xyz / torch.clamp(sin_half, min=1e-12)
    return torch.where(sin_half < 1e-8, xyz * 2.0, axis * angle)


def rotmat_orthonormalize(rot: torch.Tensor) -> torch.Tensor:
    """(..., 3, 3) near-rotations projected onto SO(3) by SVD, det +1."""
    u, _, vt = torch.linalg.svd(rot)
    det = torch.linalg.det(u @ vt)
    d = torch.cat([torch.ones(rot.shape[:-2] + (2,), dtype=rot.dtype, device=rot.device),
                   det[..., None]], dim=-1)
    return (u * d[..., None, :]) @ vt


def _axis_rotmat(axis: str, angle: torch.Tensor) -> torch.Tensor:
    c, s = torch.cos(angle), torch.sin(angle)
    one, zero = torch.ones_like(angle), torch.zeros_like(angle)
    if axis == "x":
        rows = ((one, zero, zero), (zero, c, -s), (zero, s, c))
    elif axis == "y":
        rows = ((c, zero, s), (zero, one, zero), (-s, zero, c))
    elif axis == "z":
        rows = ((c, -s, zero), (s, c, zero), (zero, zero, one))
    else:
        raise ValueError(f"bad axis {axis!r}")
    return torch.stack([torch.stack(r, dim=-1) for r in rows], dim=-2)


def _check_convention(convention: str) -> str:
    """Three axes of xyz, no axis twice in a row (Tait-Bryan xyz... and
    proper Euler zxz...)."""
    convention = convention.lower()
    if (len(convention) != 3 or any(a not in "xyz" for a in convention)
            or convention[0] == convention[1] or convention[1] == convention[2]):
        raise ValueError(f"bad euler convention {convention!r}")
    return convention


def ee_to_rotmat(euler: torch.Tensor, convention: str = "xyz") -> torch.Tensor:
    """(..., 3) Euler angles (radians) -> (..., 3, 3) rotations."""
    convention = _check_convention(convention)
    mats = [_axis_rotmat(a, euler[..., i]) for i, a in enumerate(convention)]
    return mats[0] @ mats[1] @ mats[2]


def rotmat_to_ee(rot: torch.Tensor, convention: str = "xyz") -> torch.Tensor:
    """(..., 3, 3) rotations -> (..., 3) Euler angles (radians), the
    principal branch of a Tait-Bryan convention (c0, c1, c2) with
    permutation sign s: b = asin(s R[i0, i2]), a = atan2(-s R[i1, i2],
    R[i2, i2]), c = atan2(-s R[i0, i1], R[i0, i0])."""
    convention = _check_convention(convention)
    if convention[0] == convention[2]:
        raise NotImplementedError("proper Euler (repeated-axis) extraction "
                                  "not needed by the reference")
    i0, i1, i2 = ("xyz".index(a) for a in convention)
    sign = 1.0 if convention in ("xyz", "yzx", "zxy") else -1.0
    central = torch.asin(torch.clamp(sign * rot[..., i0, i2], -1.0, 1.0))
    first = torch.atan2(-sign * rot[..., i1, i2], rot[..., i2, i2])
    third = torch.atan2(-sign * rot[..., i0, i1], rot[..., i0, i0])
    return torch.stack([first, central, third], dim=-1)


def aa_to_ee(theta: torch.Tensor, convention: str = "xyz") -> torch.Tensor:
    """Axis-angle -> Euler angles."""
    return rotmat_to_ee(aa_to_rotmat(theta), convention)


def ee_to_aa(euler: torch.Tensor, convention: str = "xyz") -> torch.Tensor:
    """Euler angles -> axis-angle."""
    return rotmat_to_aa(ee_to_rotmat(euler, convention))
