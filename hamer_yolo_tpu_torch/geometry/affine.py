"""Affine crop geometry on tensors, f32 (port of
hamer_yolo_tpu/geometry/affine.py): the letterbox geometry, the patch
affine from a box (``gen_trans_from_patch``, the reference's 3-point
construction in closed form), its inverse, the bilinear sample with a
constant border (cv2.INTER_LINEAR + BORDER_CONSTANT), the warp and HaMeR's
crop built on it, and the letterbox resize (``jax.image.resize``'s
antialiased linear weights, then the pad). Every function takes leading
batch dimensions where JAX's is mapped over them. ``letterbox_params`` and
``letterbox_numpy`` are the host's (io/images.py)."""
from __future__ import annotations

import math
from typing import Tuple

import numpy as np
import torch

from hamer_yolo_tpu_torch.io.images import letterbox_numpy, letterbox_params  # noqa: F401


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


def warp_affine(img: torch.Tensor, trans: torch.Tensor, out_hw: Tuple[int, int],
                border_value: float = 0.0) -> torch.Tensor:
    """cv2.warpAffine(INTER_LINEAR, BORDER_CONSTANT) of an (H, W, C) image
    under the forward (2, 3) map ``trans`` -> (out_h, out_w, C)."""
    out_h, out_w = out_hw
    inv = invert_affine(trans)
    ys, xs = torch.meshgrid(torch.arange(out_h, dtype=torch.float32, device=img.device),
                            torch.arange(out_w, dtype=torch.float32, device=img.device),
                            indexing="ij")
    src_x = inv[0, 0] * xs + inv[0, 1] * ys + inv[0, 2]
    src_y = inv[1, 0] * xs + inv[1, 1] * ys + inv[1, 2]
    return bilinear_sample(img, src_x, src_y, border_value)


def crop_resize_normalize(img: torch.Tensor, center: torch.Tensor, size: torch.Tensor,
                          out_hw: Tuple[int, int], mean: torch.Tensor, std: torch.Tensor,
                          do_flip: torch.Tensor, border_value: float = 0.0) -> torch.Tensor:
    """HaMeR's input for one box of one (H, W, 3) BGR image: the size x size
    square about ``center`` warped to out_hw, BGR -> RGB, mirrored where
    ``do_flip`` > 0.5, and normalised (x - 255 mean) / (255 std)."""
    out_h, out_w = out_hw
    trans = gen_trans_from_patch(center[0], center[1], size, size, float(out_w), float(out_h))
    patch = warp_affine(img, trans, out_hw, border_value).flip(-1)
    patch = torch.where(do_flip > 0.5, patch.flip(1), patch)
    return (patch - 255.0 * mean) / (255.0 * std)


def _triangle(x: np.ndarray) -> np.ndarray:
    return np.maximum(np.float32(0.0), np.float32(1.0) - np.abs(x)).astype(np.float32)


def _keys_cubic(x: np.ndarray) -> np.ndarray:
    """Keys' cubic kernel, a = -0.5, of |x|, in float32."""
    f = np.float32
    out = ((f(1.5) * x - f(2.5)) * x) * x + f(1.0)
    out = np.where(x >= 1.0, ((f(-0.5) * x + f(2.5)) * x - f(4.0)) * x + f(2.0), out)
    return np.where(x >= 2.0, f(0.0), out).astype(np.float32)


RESIZE_KERNELS = {"linear": _triangle, "cubic": _keys_cubic}


def resize_weights(n_in: int, n_out: int, kernel: str = "linear") -> np.ndarray:
    """(n_in, n_out) float32 weights of ``jax.image.resize`` along one axis
    (method "linear" or "cubic"), antialiased as its default is: half-pixel
    centres, on a downscale the kernel widened by n_in / n_out, every column
    renormalised to sum 1, columns whose sample falls outside the input
    zeroed; float32 steps in jax.image's order."""
    inv_scale = np.float32(1.0 / (n_out / n_in))
    kernel_scale = np.maximum(inv_scale, np.float32(1.0))
    sample = (np.arange(n_out, dtype=np.float32) + np.float32(0.5)) * inv_scale - np.float32(0.5)
    x = np.abs(sample[None, :] - np.arange(n_in, dtype=np.float32)[:, None]) / kernel_scale
    w = RESIZE_KERNELS[kernel](x)
    total = np.sum(w, axis=0, keepdims=True, dtype=np.float32)
    w = np.where(np.abs(total) > 1000.0 * float(np.finfo(np.float32).eps),
                 w / np.where(total != 0, total, np.float32(1.0)), np.float32(0.0))
    inside = (sample >= -0.5) & (sample <= n_in - 0.5)
    return np.where(inside[None, :], w, np.float32(0.0)).astype(np.float32)


def letterbox_image(img: torch.Tensor, new_unpad_wh: Tuple[int, int],
                    pads: Tuple[int, int, int, int], out_size: int = 640,
                    pad_value: float = 114.0) -> torch.Tensor:
    """An (H, W, 3) float image resized to new_unpad_wh as
    ``jax.image.resize(..., "linear")`` resizes it, then padded with
    ``pad_value`` by pads (top, bottom, left, right) -> (out_size, out_size,
    3). Only an axis whose length changes is resampled."""
    new_w, new_h = new_unpad_wh
    top, bottom, left, right = pads
    x = img
    for axis, n in ((0, new_h), (1, new_w)):
        if x.shape[axis] != n:
            w = torch.from_numpy(resize_weights(x.shape[axis], n)).to(x.device)
            x = torch.tensordot(x.movedim(axis, -1), w, dims=1).movedim(-1, axis)
    return torch.nn.functional.pad(x.permute(2, 0, 1), (left, right, top, bottom),
                                   value=pad_value).permute(1, 2, 0)
