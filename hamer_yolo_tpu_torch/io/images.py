"""cv2's uint8 bilinear resize in numpy, so that the host steps that the JAX
package gives to ``cv2.resize`` run on a machine without cv2 and give the
same bytes.

``resize_linear`` is ``cv2.resize(img, (w, h))`` (INTER_LINEAR) on uint8
images, as OpenCV computes it:
- an exact 2x downscale in both axes is INTER_AREA: (sum of the 2 x 2 block
  + 2) >> 2;
- otherwise source coordinates (d + 0.5) * (src / dst) - 0.5 in f32, split
  into an integer tap and a fraction f; along x a tap past either edge is
  clamped with f = 0, along y only the row index is clamped;
- the weights (1 - f) and f, each rounded to 1/2048 (11 bits);
- the horizontal pass in exact integers, then the vertical pass as OpenCV's
  vector code does it: ((a >> 4) * b0 >> 16) + ((c >> 4) * b1 >> 16), + 2,
  >> 2.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np

_COEF_ONE = 1 << 11  # INTER_RESIZE_COEF_SCALE


def _taps(dst: int, src: int, clamp_fraction: bool) -> Tuple[np.ndarray, ...]:
    """(tap 0, tap 1, weight 0, weight 1) of each output index along an axis."""
    f = ((np.arange(dst, dtype=np.float64) + 0.5) * (src / dst) - 0.5).astype(np.float32)
    s = np.floor(f).astype(np.int64)
    f = (f - s.astype(np.float32)).astype(np.float32)
    if clamp_fraction:
        edge = (s < 0) | (s >= src - 1)
        f[edge] = 0.0
        s = np.where(s < 0, 0, np.where(s >= src - 1, src - 1, s))
    w0 = np.round((np.float32(1.0) - f) * np.float32(_COEF_ONE)).astype(np.int64)
    w1 = np.round(f * np.float32(_COEF_ONE)).astype(np.int64)
    return np.clip(s, 0, src - 1), np.clip(s + 1, 0, src - 1), w0, w1


def resize_linear(img: np.ndarray, size_wh: Tuple[int, int]) -> np.ndarray:
    """cv2.resize(img, size_wh) with INTER_LINEAR, img (H, W, C) uint8."""
    w_out, h_out = size_wh
    h, w, c = img.shape
    src = img.astype(np.int64)
    if w == 2 * w_out and h == 2 * h_out:
        total = src[0::2, 0::2] + src[0::2, 1::2] + src[1::2, 0::2] + src[1::2, 1::2]
        return ((total + 2) >> 2).astype(np.uint8)
    x0, x1, a0, a1 = _taps(w_out, w, True)
    y0, y1, b0, b1 = _taps(h_out, h, False)
    rows = src[:, x0] * a0[None, :, None] + src[:, x1] * a1[None, :, None]  # (H, w_out, C)
    top, bottom = rows[y0] >> 4, rows[y1] >> 4
    out = (((top * b0[:, None, None]) >> 16) + ((bottom * b1[:, None, None]) >> 16) + 2) >> 2
    return np.clip(out, 0, 255).astype(np.uint8)


def letterbox_centered(img: np.ndarray, size: int, pad_value: int = 114) -> np.ndarray:
    """The JAX CLI's calibration letterbox: ``img`` resized by
    min(size / h, size / w) (sides rounded half to even), centred on a
    size x size canvas of ``pad_value``; uint8 in, uint8 out."""
    h, w = img.shape[:2]
    r = min(size / h, size / w)
    nh, nw = int(round(h * r)), int(round(w * r))
    canvas = np.full((size, size, img.shape[2]), pad_value, np.uint8)
    top, left = (size - nh) // 2, (size - nw) // 2
    canvas[top:top + nh, left:left + nw] = resize_linear(img, (nw, nh))
    return canvas
