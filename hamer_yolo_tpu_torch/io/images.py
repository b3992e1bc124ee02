"""cv2's uint8 host arithmetic in numpy (its bilinear resize and, below, its warps,
HSV conversions and affine solves), so that the host steps that the JAX
package gives to cv2 run on a machine without cv2 and give the
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


def letterbox_centered(img: np.ndarray, size: int) -> np.ndarray:
    """The JAX CLI's calibration letterbox: ``letterbox_numpy``'s image
    (its int(round(pad -+ 0.1)) split is (size - side) // 2 on every pad)."""
    return letterbox_numpy(img, size)[0]


# ---------------------------------------------------------------------------
# The rest of cv2's host arithmetic that the training loaders use
# ---------------------------------------------------------------------------
#
# Held to the cv2 that the JAX package's tests call (OpenCV 5.0.0, x86-64).
# Its warps (warpAffine / warpPerspective, INTER_LINEAR, constant border)
# compute in float32, not in the fixed point of OpenCV 4.x before 4.11:
# each row runs a SIMD body over the first w - w % WARP_LANES pixels and a
# scalar tail over the rest, and the two differ in where they fuse a
# multiply-add. HSV -> BGR likewise: a SIMD body over the first
# w - w % HSV_LANES pixels of a row that truncates to uint8, and a scalar
# tail that rounds. BGR -> HSV is table-driven integer arithmetic.

WARP_LANES = 16   # the warp kernels' unrolled SIMD width (2 x 8 float lanes)
HSV_LANES = 32    # HSV -> BGR's SIMD body
_F32 = np.float32


def _fma(a, b, c) -> np.ndarray:
    """float32 fused multiply-add, correctly rounded: a b is exact in
    float64, and so is the float64 sum unless its exponents part; rounding
    that sum to float32 can only go wrong where it lands exactly midway
    between two float32s, and there the sum's rounding error (Knuth's
    two-sum) decides."""
    p = np.multiply(a, b, dtype=np.float64)
    c = np.asarray(c, np.float64)
    s = p + c
    r = s.astype(_F32)
    mid = (s.view(np.uint64) & 0x1FFFFFFF) == 0x10000000  # on a float32 midpoint
    if mid.any():
        p, c, s = (np.broadcast_to(v, s.shape)[mid] for v in (p, c, s))
        bb = s - p
        err = (p - (s - bb)) + (c - bb)
        up = np.nextafter(s.astype(_F32), _F32(np.inf))
        down = np.nextafter(s.astype(_F32), _F32(-np.inf))
        # s is a midpoint: the float32 below or above it, by the sign of the error
        lo = np.where(down.astype(np.float64) < s, down, s.astype(_F32))
        lo = np.where(lo.astype(np.float64) > s, down, lo)
        hi = np.where(up.astype(np.float64) > s, up, s.astype(_F32))
        hi = np.where(hi.astype(np.float64) < s, up, hi)
        lo, hi = np.minimum(lo, hi), np.maximum(lo, hi)
        fixed = np.where(err > 0, hi, np.where(err < 0, lo, s.astype(_F32)))
        r = np.array(r, copy=True)
        r[mid] = fixed
    return r


def rotation_matrix_2d(center: Tuple[float, float], angle: float, scale: float) -> np.ndarray:
    """cv2.getRotationMatrix2D: (2, 3) float64, angle in degrees, the
    centre taken to float32 (a cv::Point2f)."""
    a = angle * (np.pi / 180)
    alpha, beta = np.cos(a) * scale, np.sin(a) * scale
    cx, cy = (float(np.float32(v)) for v in center)
    return np.array([[alpha, beta, (1 - alpha) * cx - beta * cy],
                     [-beta, alpha, beta * cx + (1 - alpha) * cy]], np.float64)


def affine_transform(src: np.ndarray, dst: np.ndarray) -> np.ndarray:
    """cv2.getAffineTransform: the 6 x 6 system of three point pairs solved
    as cv2.solve's LU does (partial pivoting, float64); (2, 3) float64."""
    a = np.zeros((6, 6))
    b = np.zeros(6)
    for i in range(3):
        a[2 * i, :2] = a[2 * i + 1, 3:5] = np.asarray(src[i], np.float64)
        a[2 * i, 2] = a[2 * i + 1, 5] = 1.0
        b[2 * i:2 * i + 2] = np.asarray(dst[i], np.float64)
    A, x = a.tolist(), b.tolist()
    for i in range(6):
        k = max(range(i, 6), key=lambda j: (abs(A[j][i]), -j))
        if k != i:
            A[i], A[k], x[i], x[k] = A[k], A[i], x[k], x[i]
        d = -1.0 / A[i][i]
        for j in range(i + 1, 6):
            alpha = A[j][i] * d
            for c in range(i + 1, 6):
                A[j][c] += alpha * A[i][c]
            x[j] += alpha * x[i]
    for i in range(5, -1, -1):
        s = x[i]
        for c in range(i + 1, 6):
            s -= A[i][c] * x[c]
        x[i] = s / A[i][i]
    return np.array(x, np.float64).reshape(2, 3)


def _invert_affine(m: np.ndarray) -> np.ndarray:
    """warpAffine's inverse of a forward (2, 3) map, as cv2 takes it (float64)."""
    m = np.asarray(m, np.float64).ravel().copy()
    d = m[0] * m[4] - m[1] * m[3]
    d = 1.0 / d if d != 0 else 0.0
    a11, a22 = m[4] * d, m[0] * d
    m[0], m[1], m[3], m[4] = a11, -m[1] * d, -m[3] * d, a22
    m[2], m[5] = -m[0] * m[2] - m[1] * m[5], -m[3] * m[2] - m[4] * m[5]
    return m


def _invert_3x3(s: np.ndarray) -> np.ndarray:
    """cv2.invert's closed form for a 3 x 3 float64 matrix (DECOMP_LU)."""
    s = np.asarray(s, np.float64)
    det = (s[0, 0] * (s[1, 1] * s[2, 2] - s[1, 2] * s[2, 1])
           - s[0, 1] * (s[1, 0] * s[2, 2] - s[1, 2] * s[2, 0])
           + s[0, 2] * (s[1, 0] * s[2, 1] - s[1, 1] * s[2, 0]))
    d = 1.0 / det
    return np.array([(s[1, 1] * s[2, 2] - s[1, 2] * s[2, 1]) * d,
                     (s[0, 2] * s[2, 1] - s[0, 1] * s[2, 2]) * d,
                     (s[0, 1] * s[1, 2] - s[0, 2] * s[1, 1]) * d,
                     (s[1, 2] * s[2, 0] - s[1, 0] * s[2, 2]) * d,
                     (s[0, 0] * s[2, 2] - s[0, 2] * s[2, 0]) * d,
                     (s[0, 2] * s[1, 0] - s[0, 0] * s[1, 2]) * d,
                     (s[1, 0] * s[2, 1] - s[1, 1] * s[2, 0]) * d,
                     (s[0, 1] * s[2, 0] - s[0, 0] * s[2, 1]) * d,
                     (s[0, 0] * s[1, 1] - s[0, 1] * s[1, 0]) * d])


def _sample_linear(img: np.ndarray, sx: np.ndarray, sy: np.ndarray, border: int) -> np.ndarray:
    """Bilinear taps at float32 source coordinates (H, W), the weights
    sx - floor(sx) and sy - floor(sy), a tap outside the image the border
    value; the two horizontal lerps and the vertical one as fused
    multiply-adds, rounded half to even into uint8."""
    h, w, c = img.shape
    x0, y0 = np.floor(sx), np.floor(sy)
    ax = (sx - x0).astype(_F32)[..., None]
    ay = (sy - y0).astype(_F32)[..., None]
    # a one-pixel frame of the border value: every tap outside the image
    # clips into it
    framed = np.full((h + 2, w + 2, c), border, np.uint8)
    framed[1:-1, 1:-1] = img
    flat = framed.reshape(-1, c)
    xa = np.clip(x0, -1, w).astype(np.int64) + 1
    xb = np.clip(x0 + 1, -1, w).astype(np.int64) + 1
    ya = np.clip(y0, -1, h).astype(np.int64) * (w + 2) + (w + 2)
    yb = np.clip(y0 + 1, -1, h).astype(np.int64) * (w + 2) + (w + 2)
    p00, p01 = flat[ya + xa].astype(_F32), flat[ya + xb].astype(_F32)
    p10, p11 = flat[yb + xa].astype(_F32), flat[yb + xb].astype(_F32)
    top = _fma(ax, p01 - p00, p00)
    bottom = _fma(ax, p11 - p10, p10)
    return np.clip(np.rint(_fma(ay, bottom - top, top)), 0, 255).astype(np.uint8)


def _grid(size_wh: Tuple[int, int]) -> Tuple[np.ndarray, np.ndarray, int]:
    """(x (1, w), y (h, 1), the first column of the scalar tail)."""
    w, h = size_wh
    return np.arange(w, dtype=_F32)[None, :], np.arange(h, dtype=_F32)[:, None], w - w % WARP_LANES


def _source(a, b, c, xs, ys, tail) -> np.ndarray:
    """One source coordinate of every output pixel, a x + b y + c: the SIMD
    body's fma(a, x, f32(y b) + c), the scalar tail's fma(x, a, y b) + c."""
    yb = (ys * b).astype(_F32)
    out = _fma(a, xs, yb + c)
    if tail < xs.shape[1]:
        out[:, tail:] = (_fma(xs[:, tail:], a, yb) + c).astype(_F32)
    return out


def warp_affine_linear(img: np.ndarray, m: np.ndarray, size_wh: Tuple[int, int],
                       border_value=0) -> np.ndarray:
    """cv2.warpAffine(img, m, size_wh, flags=INTER_LINEAR,
    borderValue=(border_value,) * 3) on an (H, W, C) uint8 image: the inverse map
    in float64, taken to float32, the source coordinates as ``_source``."""
    mi = _invert_affine(m).astype(_F32)
    xs, ys, tail = _grid(size_wh)
    return _sample_linear(img, _source(mi[0], mi[1], mi[2], xs, ys, tail),
                          _source(mi[3], mi[4], mi[5], xs, ys, tail), border_value)


def warp_perspective_linear(img: np.ndarray, m: np.ndarray, size_wh: Tuple[int, int],
                            border_value=0) -> np.ndarray:
    """cv2.warpPerspective(img, m, size_wh, flags=INTER_LINEAR,
    borderValue=(border_value,) * 3) on an (H, W, C) uint8 image: cv2.invert's closed-form inverse, taken to
    float32; each of x', y', w' as ``_source``, then x' / w' and y' / w'
    (true division)."""
    mi = _invert_3x3(m).astype(_F32)
    xs, ys, tail = _grid(size_wh)
    w = _source(mi[6], mi[7], mi[8], xs, ys, tail)
    sx = (_source(mi[0], mi[1], mi[2], xs, ys, tail) / w).astype(_F32)
    sy = (_source(mi[3], mi[4], mi[5], xs, ys, tail) / w).astype(_F32)
    return _sample_linear(img, sx, sy, border_value)


_HSV_SHIFT = 12


def _hsv_tables() -> Tuple[np.ndarray, np.ndarray]:
    i = np.arange(1, 256, dtype=np.float64)
    sdiv = np.zeros(256, np.int64)
    hdiv = np.zeros(256, np.int64)
    sdiv[1:] = np.rint((255 << _HSV_SHIFT) / i)
    hdiv[1:] = np.rint((180 << _HSV_SHIFT) / (6.0 * i))
    return sdiv, hdiv


def bgr_to_hsv(img: np.ndarray) -> np.ndarray:
    """cv2.cvtColor(img, COLOR_BGR2HSV) on uint8: H in 0..179 by cv2's
    division tables in 12-bit fixed point (exact on all 2^24 colours)."""
    sdiv, hdiv = _hsv_tables()
    x = img.astype(np.int64)
    b, g, r = x[..., 0], x[..., 1], x[..., 2]
    v = np.maximum(np.maximum(b, g), r)
    diff = v - np.minimum(np.minimum(b, g), r)
    half = 1 << (_HSV_SHIFT - 1)
    s = (diff * sdiv[v] + half) >> _HSV_SHIFT
    h = np.where(v == r, g - b, np.where(v == g, b - r + 2 * diff, r - g + 4 * diff))
    h = (h * hdiv[diff] + half) >> _HSV_SHIFT
    h = h + np.where(h < 0, 180, 0)
    return np.stack([h, s, v], axis=-1).astype(np.uint8)


_HSV_SECTORS = np.array([[1, 3, 0], [1, 0, 2], [3, 0, 1], [0, 2, 1], [0, 1, 3], [2, 1, 0]])


def hsv_to_bgr(img: np.ndarray) -> np.ndarray:
    """cv2.cvtColor(img, COLOR_HSV2BGR) on uint8, through float32: s and v
    times f32(1 / 255), h times f32(6 / 180) modulo 6 split into a sector and
    its fraction f, the four values v, v (1 - s), v fma(-s, f, 1) and
    v fma(-s, 1 - f, 1), times 255; the SIMD body of each row truncates them
    into uint8, the scalar tail rounds them (half to even)."""
    h = img[..., 0].astype(_F32) * _F32(6.0 / 180)
    s = img[..., 1].astype(_F32) * _F32(1.0 / 255)
    v = img[..., 2].astype(_F32) * _F32(1.0 / 255)
    h = np.fmod(h, _F32(6.0)).astype(_F32)
    sector = np.floor(h).astype(np.int64)
    f = (h - sector).astype(_F32)
    outside = (sector < 0) | (sector >= 6)
    sector, f = np.where(outside, 0, sector), np.where(outside, _F32(0), f)
    tab = np.stack([v, (v * (_F32(1) - s)).astype(_F32), (v * _fma(-s, f, _F32(1))).astype(_F32),
                    (v * _fma(-s, (_F32(1) - f).astype(_F32), _F32(1))).astype(_F32)], axis=-1)
    bgr = np.take_along_axis(tab, _HSV_SECTORS[sector], axis=-1)
    bgr = np.where((img[..., 1] == 0)[..., None], v[..., None], bgr)
    scaled = (bgr * _F32(255)).astype(_F32)
    w = img.shape[1]
    body = (np.arange(w) < w - w % HSV_LANES)[None, :, None]
    return np.clip(np.where(body, np.trunc(scaled), np.rint(scaled)), 0, 255).astype(np.uint8)


def letterbox_params(shape_hw: Tuple[int, int], new_shape: int = 640, stride: int = 32,
                     auto: bool = False, scaleup: bool = True):
    """The letterbox's geometry on the host: (ratio, (new_w, new_h) unpadded,
    (dw, dh) half-pads, (top, bottom, left, right) pads), the reference's
    int(round(d -+ 0.1)) split; ``auto`` pads to a multiple of ``stride``."""
    h, w = shape_hw
    r = min(new_shape / h, new_shape / w)
    if not scaleup:
        r = min(r, 1.0)
    new_unpad = (int(round(w * r)), int(round(h * r)))
    dw, dh = new_shape - new_unpad[0], new_shape - new_unpad[1]
    if auto:
        dw, dh = dw % stride, dh % stride
    dw /= 2
    dh /= 2
    top, bottom = int(round(dh - 0.1)), int(round(dh + 0.1))
    left, right = int(round(dw - 0.1)), int(round(dw + 0.1))
    return r, new_unpad, (dw, dh), (top, bottom, left, right)


def letterbox_numpy(img: np.ndarray, new_shape: int = 640, stride: int = 32, auto: bool = False):
    """The JAX package's host letterbox (geometry/affine.letterbox_numpy):
    cv2's resize by min(S / h, S / w) to int(round()) sides, then a constant
    114 border split as ``letterbox_params`` splits it; (padded uint8 image,
    ratio, (dw, dh))."""
    r, new_unpad, (dw, dh), (top, bottom, left, right) = letterbox_params(
        img.shape[:2], new_shape, stride, auto)
    if (img.shape[1], img.shape[0]) != new_unpad:
        img = resize_linear(img, new_unpad)
    out = np.full((img.shape[0] + top + bottom, img.shape[1] + left + right, img.shape[2]), 114,
                  np.uint8)
    out[top:top + img.shape[0], left:left + img.shape[1]] = img
    return out, r, (dw, dh)



# ---------------------------------------------------------------------------
# The nearest warps and Rodrigues of the RGB-D loaders
# ---------------------------------------------------------------------------
#
# cv2 5.0's INTER_NEAREST warps take the source coordinates of its linear
# warps (``_source``, float32, the same SIMD body and scalar tail) and round
# each half to even (cvRound); the value is copied as it is, whatever the
# dtype. A scalar borderValue is cv::Scalar(v, 0, 0, 0): a pixel outside the
# image gets v in its first channel and 0 in the others.

def _sample_nearest(img: np.ndarray, sx: np.ndarray, sy: np.ndarray,
                    border: float) -> np.ndarray:
    h, w = img.shape[:2]
    big = _F32(2 ** 30)  # cvRound saturates; anything this far is outside
    ix = np.rint(np.clip(np.nan_to_num(sx, nan=-big), -big, big)).astype(np.int64)
    iy = np.rint(np.clip(np.nan_to_num(sy, nan=-big), -big, big)).astype(np.int64)
    inside = (ix >= 0) & (ix < w) & (iy >= 0) & (iy < h)
    out = img[np.clip(iy, 0, h - 1), np.clip(ix, 0, w - 1)]
    fill = np.zeros(img.shape[2:], img.dtype)
    fill.reshape(-1)[:1] = border
    if img.ndim == 2:
        return np.where(inside, out, fill)
    return np.where(inside[..., None], out, fill)


def warp_affine_nearest(img: np.ndarray, m: np.ndarray, size_wh: Tuple[int, int],
                        border_value: float = 0.0) -> np.ndarray:
    """cv2.warpAffine(img, m, size_wh, flags=INTER_NEAREST,
    borderMode=BORDER_CONSTANT, borderValue=border_value) on an (H, W) or
    (H, W, C) image of any dtype."""
    mi = _invert_affine(m).astype(_F32)
    xs, ys, tail = _grid(size_wh)
    return _sample_nearest(img, _source(mi[0], mi[1], mi[2], xs, ys, tail),
                           _source(mi[3], mi[4], mi[5], xs, ys, tail), border_value)


def warp_perspective_nearest(img: np.ndarray, m: np.ndarray, size_wh: Tuple[int, int],
                             border_value: float = 0.0) -> np.ndarray:
    """cv2.warpPerspective(img, m, size_wh, flags=INTER_NEAREST,
    borderMode=BORDER_CONSTANT, borderValue=border_value) on an (H, W) or
    (H, W, C) image of any dtype: x' / w' and y' / w' as
    ``warp_perspective_linear`` takes them."""
    mi = _invert_3x3(m).astype(_F32)
    xs, ys, tail = _grid(size_wh)
    w = _source(mi[6], mi[7], mi[8], xs, ys, tail)
    with np.errstate(divide="ignore", invalid="ignore"):
        sx = (_source(mi[0], mi[1], mi[2], xs, ys, tail) / w).astype(_F32)
        sy = (_source(mi[3], mi[4], mi[5], xs, ys, tail) / w).astype(_F32)
    return _sample_nearest(img, sx, sy, border_value)


def rodrigues(rvec) -> np.ndarray:
    """cv2.Rodrigues(rvec)[0]: the (3, 3) float64 rotation of an axis-angle
    vector, cos(t) I + (1 - cos(t)) r r^T + sin(t) [r]x with r the unit axis,
    in cv2's order of operations."""
    x, y, z = (float(v) for v in np.asarray(rvec, np.float64).reshape(3))
    theta = np.sqrt(x * x + y * y + z * z)
    if theta < np.finfo(np.float64).eps:
        return np.eye(3)
    c, s = np.cos(theta), np.sin(theta)
    c1 = 1.0 - c
    it = 1.0 / theta
    x, y, z = x * it, y * it, z * it
    rrt = np.array([[x * x, x * y, x * z], [x * y, y * y, y * z], [x * z, y * z, z * z]])
    r_x = np.array([[0.0, -z, y], [z, 0.0, -x], [-y, x, 0.0]])
    return c * np.eye(3) + c1 * rrt + s * r_x
