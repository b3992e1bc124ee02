"""Affine crop geometry on tensors, f32 (port of
hamer_yolo_tpu/geometry/affine.py): the letterbox geometry, the patch
affine from a box (``gen_trans_from_patch``, the reference's 3-point
construction in closed form), its inverse, and the bilinear sample with a
constant border (cv2.INTER_LINEAR + BORDER_CONSTANT). Every function takes
leading batch dimensions where JAX's is mapped over them."""
from __future__ import annotations

import math

import torch


def letterbox_geometry_traced(h: torch.Tensor, w: torch.Tensor, out_size: int,
                              stride: float = 32.0):
    """cv2-letterbox-exact geometry for frame sizes held in tensors.

    The reference's rect letterbox (int(round(w r)) resize target, mod-stride
    pad, the round(d - 0.1) quirk) embedded top-left in a static
    out_size x out_size canvas. Returns (r, new_w, new_h, left, top, gain,
    pad) with pad (..., 2) = (dw, dh) unrounded, as the reference's
    scale_coords derives them. ``torch.round`` rounds half to even, like
    Python's round and jnp.round.
    """
    r = torch.minimum(out_size / h, out_size / w)
    new_w = torch.round(w * r)
    new_h = torch.round(h * r)
    dw_total = torch.remainder(out_size - new_w, stride)
    dh_total = torch.remainder(out_size - new_h, stride)
    left = torch.round(dw_total / 2.0 - 0.1)
    top = torch.round(dh_total / 2.0 - 0.1)
    rect_w = new_w + dw_total
    rect_h = new_h + dh_total
    gain = torch.minimum(rect_h / h, rect_w / w)
    pad = torch.stack([(rect_w - w * gain) / 2.0, (rect_h - h * gain) / 2.0], dim=-1)
    return r, new_w, new_h, left, top, gain, pad


def _rotate_2d(x: torch.Tensor, y: torch.Tensor, rot_rad: torch.Tensor):
    sn, cs = torch.sin(rot_rad), torch.cos(rot_rad)
    return x * cs - y * sn, x * sn + y * cs


def _inv2x2(m: torch.Tensor) -> torch.Tensor:
    """(..., 2, 2) inverses: the adjugate over the determinant."""
    det = m[..., 0, 0] * m[..., 1, 1] - m[..., 0, 1] * m[..., 1, 0]
    adj = torch.stack([torch.stack([m[..., 1, 1], -m[..., 0, 1]], -1),
                       torch.stack([-m[..., 1, 0], m[..., 0, 0]], -1)], -2)
    return adj / det[..., None, None]


def _affine_from_triangles(src: torch.Tensor, dst: torch.Tensor) -> torch.Tensor:
    """(..., 3, 2) source and destination points -> the (..., 2, 3) affine
    mapping one onto the other: L = B A^-1 with A, B the edge columns,
    t = dst0 - L src0 (the closed form of cv2.getAffineTransform)."""
    a = torch.stack([src[..., 1, :] - src[..., 0, :], src[..., 2, :] - src[..., 0, :]], -1)
    b = torch.stack([dst[..., 1, :] - dst[..., 0, :], dst[..., 2, :] - dst[..., 0, :]], -1)
    lin = b @ _inv2x2(a)
    t = dst[..., 0, :] - (lin @ src[..., 0, :, None])[..., 0]
    return torch.cat([lin, t[..., None]], -1)


def gen_trans_from_patch(c_x: torch.Tensor, c_y: torch.Tensor, src_w: torch.Tensor,
                         src_h: torch.Tensor, dst_w: float, dst_h: float, scale=1.0,
                         rot_deg=0.0, inv: bool = False) -> torch.Tensor:
    """(..., 2, 3) affine from the box (center, size, scale, rotation) onto a
    dst_w x dst_h patch (``inv``: the patch onto the box). The anchor points
    are the box center and the rotated half-down and half-right directions,
    as in the reference."""
    c_x, c_y, src_w, src_h = (torch.as_tensor(t, dtype=torch.float32)
                              for t in (c_x, c_y, src_w, src_h))
    sw, sh = src_w * scale, src_h * scale
    rot = torch.as_tensor(math.pi * rot_deg / 180.0, dtype=torch.float32, device=c_x.device)
    zero = torch.zeros_like(sw)
    down = _rotate_2d(zero, sh * 0.5, rot)
    right = _rotate_2d(sw * 0.5, zero, rot)
    center = torch.stack([c_x, c_y], -1)
    src = torch.stack([center, center + torch.stack(down, -1), center + torch.stack(right, -1)],
                      -2)
    dst = torch.tensor([[dst_w * 0.5, dst_h * 0.5], [dst_w * 0.5, dst_h],
                        [dst_w, dst_h * 0.5]], dtype=torch.float32, device=c_x.device)
    dst = dst.expand(src.shape)
    return _affine_from_triangles(dst, src) if inv else _affine_from_triangles(src, dst)


def invert_affine(trans: torch.Tensor) -> torch.Tensor:
    """The inverse of (..., 2, 3) affine transforms."""
    inv_l = _inv2x2(trans[..., :, :2])
    inv_t = -(inv_l @ trans[..., :, 2, None])[..., 0]
    return torch.cat([inv_l, inv_t[..., None]], -1)


def bilinear_sample(img: torch.Tensor, xs: torch.Tensor, ys: torch.Tensor,
                    border_value: float = 0.0) -> torch.Tensor:
    """(H, W, C) image at float coordinates xs, ys (any matching shape S) ->
    (S..., C): taps outside the image read ``border_value`` and blend with
    the ones inside."""
    H, W = img.shape[0], img.shape[1]
    x0, y0 = torch.floor(xs), torch.floor(ys)
    wx, wy = (xs - x0)[..., None], (ys - y0)[..., None]
    x0i, y0i = x0.long(), y0.long()

    def tap(yi, xi):
        inside = (xi >= 0) & (xi < W) & (yi >= 0) & (yi < H)
        v = img[torch.clamp(yi, 0, H - 1), torch.clamp(xi, 0, W - 1)]
        return torch.where(inside[..., None], v, torch.full_like(v, border_value))

    top = tap(y0i, x0i) * (1 - wx) + tap(y0i, x0i + 1) * wx
    bottom = tap(y0i + 1, x0i) * (1 - wx) + tap(y0i + 1, x0i + 1) * wx
    return top * (1 - wy) + bottom * wy
