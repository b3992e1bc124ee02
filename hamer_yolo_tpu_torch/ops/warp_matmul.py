"""Axis-aligned bilinear resampling as two banded f32 matmuls (port of
hamer_yolo_tpu/ops/warp_matmul.py).

out[y, x] = sum_s sum_t Ry[y, s] img[s, t] Rx[x, t], with at most two
nonzeros per row of Ry (out_h, H) and Rx (out_w, W): R[o, s] =
max(0, 1 - |s - src(o)|). Out-of-range rows are all zero (constant-0
border); a pad value is blended in as pad * (1 - coverage). The JAX package
leaves these products to XLA, so here they are plain f32 ``torch.matmul``
(TF32 is off for the whole package).

Batched forms: images (B, H, W, C) with one row of source coordinates per
(frame, view): src_x (B, V, out_w), src_y (B, V, out_h) -> (B, V, out_h,
out_w, C). V is 1 for the letterbox and the slot count for the crops.
"""
from __future__ import annotations

from typing import Tuple

import torch

from hamer_yolo_tpu_torch.geometry.affine import letterbox_geometry_traced

LETTERBOX_PAD = 114.0


def warpaffine_fixed_point_coords(a: torch.Tensor, b: torch.Tensor,
                                  o: torch.Tensor) -> torch.Tensor:
    """cv2.warpAffine (8U, INTER_LINEAR) source coordinate a*o + b on the
    1/128 interpolation-table grid, rounded to nearest."""
    return torch.round((a * o + b) * 128.0) / 128.0


def _interp_matrix(src_coords: torch.Tensor, src_size: int) -> torch.Tensor:
    """(..., out) float source coords -> (..., out, src_size) bilinear weights."""
    s = torch.arange(src_size, dtype=torch.float32, device=src_coords.device)
    return torch.clamp(1.0 - torch.abs(s - src_coords[..., None]), min=0.0)


def resample_axis_aligned(img: torch.Tensor, src_x: torch.Tensor, src_y: torch.Tensor,
                          pad_value: float = 0.0) -> torch.Tensor:
    """img (B, H, W, C), src_x (B, V, ow), src_y (B, V, oh) -> (B, V, oh, ow, C)."""
    B, H, W, C = img.shape
    V, oh, ow = src_y.shape[1], src_y.shape[2], src_x.shape[2]
    Ry = _interp_matrix(src_y, H)  # (B, V, oh, H)
    Rx = _interp_matrix(src_x, W)  # (B, V, ow, W)
    # H first, then W, as the JAX einsums contract. Written as einsums so
    # that both become one batched matmul per frame / per view: a plain
    # broadcasting matmul would expand the smaller operand across the
    # other's batch dims in memory first.
    tmp = torch.einsum("bvoh,bhk->bvok", Ry, img.reshape(B, H, W * C))
    out = torch.einsum("bvxw,bvowc->bvoxc", Rx, tmp.reshape(B, V, oh, W, C))
    if pad_value != 0.0:
        wy = torch.clamp(Ry.sum(dim=-1), 0.0, 1.0)[..., :, None]  # (B, V, oh, 1)
        wx = torch.clamp(Rx.sum(dim=-1), 0.0, 1.0)[..., None, :]  # (B, V, 1, ow)
        out = out + pad_value * (1.0 - (wy * wx)[..., None])
    return out


def crop_square_matmul(img: torch.Tensor, center: torch.Tensor, size_wh: torch.Tensor,
                       out_hw: Tuple[int, int]) -> torch.Tensor:
    """Crops of (w, h) boxes centred at ``center``: img (B, H, W, C),
    center (B, V, 2), size_wh (B, V, 2) -> (B, V, out_h, out_w, C).

    gen_trans_from_patch maps [center - s/2, center + s/2] onto [0, out], so
    output pixel o reads src = (o - out/2) (s / out) + center.
    """
    out_h, out_w = out_hw
    ox = torch.arange(out_w, dtype=torch.float32, device=img.device)
    oy = torch.arange(out_h, dtype=torch.float32, device=img.device)
    ax = size_wh[..., 0:1] / out_w
    ay = size_wh[..., 1:2] / out_h
    bx = center[..., 0:1] - (out_w / 2.0) * ax
    by = center[..., 1:2] - (out_h / 2.0) * ay
    src_x = warpaffine_fixed_point_coords(ax, bx, ox)
    src_y = warpaffine_fixed_point_coords(ay, by, oy)
    # uint8 output rounding: (acc + (1 << 21)) >> 22 == round half up
    return torch.floor(resample_axis_aligned(img, src_x, src_y) + 0.5)


def letterbox_matmul(img: torch.Tensor, orig_hw: torch.Tensor, out_size: int = 640
                     ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """cv2-exact rect letterbox, top-left in the square canvas, padded with
    LETTERBOX_PAD (YOLOv7's grey): img (B, Hb, Wb, C) bucket-padded frames,
    orig_hw (B, 2) -> (out (B, S, S, C), gain (B,), pad (B, 2))."""
    h, w = orig_hw[:, 0:1], orig_hw[:, 1:2]
    _, new_w, new_h, left, top, gain, pad = letterbox_geometry_traced(h, w, out_size)
    o = torch.arange(out_size, dtype=torch.float32, device=img.device)
    src_x = (o - left + 0.5) * (w / new_w) - 0.5
    src_y = (o - top + 0.5) * (h / new_h) - 0.5
    # Content coords clamp to the valid edge (cv2.resize replicates at the
    # border, and reads stay out of the bucket padding); the pad region
    # reads -2, a zero row weight, so the 114 blend fills it.
    neg = torch.full_like(src_x, -2.0)
    src_x = torch.where((o >= left) & (o < left + new_w),
                        torch.minimum(torch.clamp(src_x, min=0.0), w - 1.0), neg)
    src_y = torch.where((o >= top) & (o < top + new_h),
                        torch.minimum(torch.clamp(src_y, min=0.0), h - 1.0), neg)
    out = resample_axis_aligned(img, src_x[:, None], src_y[:, None], pad_value=LETTERBOX_PAD)
    # cv2.resize emits uint8: snap to the integer grid like the reference.
    return torch.round(out[:, 0]), gain[:, 0], pad[:, 0]
