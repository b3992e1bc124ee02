"""W8A8 int8 convolutions (port of the int8 branch of
hamer_yolo_tpu/core/nn.py:conv2d), which ``nn.conv2d`` takes where a conv's
"w" is a dict {"q": int8 (O, C / groups, kh, kw), "scale": f32 (O,)}, as
core/quant.quantize_yolo_params makes it; "sx", an f32 scalar, is the
calibrated static activation scale (core/quant.calibrate_yolo_act_scales).

JAX's three routes, chosen as JAX chooses them:
- 1x1, groups 1, no padding: one GEMM over the (strided) pixels, with the
  static scale "sx" where the conv has one, else a dynamic scale per pixel
  (absmax / 127, floor 1e-8); dequantized (acc * sx) * scale;
- spatial with "sx", groups 1: quantized before padding, so the border is an
  exact int8 zero; JAX sums kh * kw shifted GEMMs, here one GEMM over the
  kh * kw shifted slices side by side (int32 sums are exact, so the same
  numbers); dequantized (acc * sx) * scale;
- otherwise (grouped convs, with or without "sx", or a spatial conv without
  one): a dynamic per-tensor scale and one int8 convolution, computed as an
  f64 product of the int8 values' patches per group (exact in any order:
  every partial sum is an integer below 2^53); dequantized acc * (sx *
  scale).
Quantizing rounds half to even in the activation's dtype, clip(round(x /
sx), -127, 127), and a division by the constant 127 is the product with its
f32 reciprocal, as JAX's compiled program computes it (ROADMAP F8). The
result is cast to x's dtype, then the bias is added in x's dtype.

The int8 products run on ``torch._int_mm`` (the card's int8 tensor cores;
exact int32 sums): on the card it needs more than 16 rows and K and N that
are multiples of 8, so the rows, K and N are padded with zeros (exact) where
they fall short. The GEMM's weight, K-major and padded, is made once per
weight tensor (``nn.derived``).

``record_conv_absmax`` is the calibration hook (JAX's ``_CONV_CALIB``): inside
it every int8 conv records the largest |x| of its input, keyed by the conv's
int8 weight tensor. It reads the value back to the host, so it runs eagerly,
never inside a captured graph. JAX calibrates eagerly, and eager JAX divides
by 127 where its compiled programs multiply by the reciprocal, so inside the
hook the dynamic scales divide (the statistics then match JAX's).
"""
from __future__ import annotations

import contextlib
from typing import Any, Dict, Iterator, Optional, Tuple

import torch
import torch.nn.functional as F

from hamer_yolo_tpu_torch.core import nn
from hamer_yolo_tpu_torch.ops.int8_matmul import RECIP_127

_RECORDER: Optional[Dict[torch.Tensor, float]] = None


@contextlib.contextmanager
def record_conv_absmax() -> Iterator[Dict[torch.Tensor, float]]:
    """Within the block, every int8 conv records max |x| of its input (the
    running maximum over calls) in the yielded dict, keyed by its "q" tensor."""
    global _RECORDER
    prev, _RECORDER = _RECORDER, {}
    try:
        yield _RECORDER
    finally:
        _RECORDER = prev


def _quantize(x: torch.Tensor, sx: torch.Tensor) -> torch.Tensor:
    """clip(round(x / sx), -127, 127) as int8, in x's dtype."""
    return torch.clamp(torch.round(x / sx.to(x.dtype)), -127, 127).to(torch.int8)


def _dynamic_scale(x: torch.Tensor, dim=None) -> torch.Tensor:
    """max(absmax / 127, 1e-8) in x's dtype, per row (``dim`` -1) or per
    tensor (``dim`` None); / 127 as compiled JAX computes it, or as eager JAX
    does inside record_conv_absmax."""
    a = torch.abs(x)
    absmax = torch.amax(a) if dim is None else torch.amax(a, dim=dim, keepdim=True)
    scaled = absmax / 127.0 if _RECORDER is not None else (absmax.float() * RECIP_127).to(x.dtype)
    return torch.clamp(scaled, min=nn.weak_scalar(1e-8, x.dtype))


def _pad_to(n: int, m: int) -> int:
    return -(-n // m) * m


def _gemm_weight(q: torch.Tensor) -> torch.Tensor:
    """The (K, N) int8 GEMM operand of an (O, C, kh, kw) weight, K in (dy, dx,
    c) order; on the card a column-major view of an (N8, K8) copy, padded
    with zero rows and columns to multiples of 8."""
    O, C, kh, kw = q.shape
    w = q.permute(0, 2, 3, 1).reshape(O, kh * kw * C)
    if q.is_cuda:
        w = F.pad(w, (0, _pad_to(w.shape[1], 8) - w.shape[1], 0, _pad_to(O, 8) - O))
    return w.contiguous().t()


def int_mm(a: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    """(M, K) int8 times the GEMM operand of the conv weight ``q`` -> (M, O)
    int32, exact, on ``torch._int_mm``."""
    w = nn.derived(q, "int8_conv_gemm", lambda: _gemm_weight(q))
    M, K = a.shape
    if a.is_cuda:
        a = F.pad(a, (0, w.shape[0] - K, 0, max(17 - M, 0)))
    return torch._int_mm(a.contiguous(), w)[:M, :q.shape[0]]


def int8_conv2d(p: nn.Params, x: torch.Tensor, stride: Tuple[int, int], padding: Any,
                groups: int) -> torch.Tensor:
    """The int8 conv of ``p`` ({"w": {"q", "scale"}, "sx"?, "b"?}) on NHWC x,
    before the bias: (B, H', W', O) in x's dtype."""
    q, scale = p["w"]["q"], p["w"]["scale"]
    O, _, kh, kw = q.shape
    if _RECORDER is not None:
        if torch.cuda.is_available() and torch.cuda.is_current_stream_capturing():
            raise RuntimeError("conv calibration must run eagerly, not in a captured graph")
        _RECORDER[q] = max(_RECORDER.get(q, 0.0), float(torch.amax(torch.abs(x))))
    B, H, W, C = x.shape
    sh, sw = stride
    pads = nn.resolve_padding(padding, (H, W), (kh, kw), stride)
    sx_static = p.get("sx")
    if kh == kw == 1 and groups == 1 and pads == [(0, 0), (0, 0)]:
        xs = x[:, ::sh, ::sw, :]
        Ho, Wo = xs.shape[1:3]
        x2 = xs.reshape(-1, C)
        sx = sx_static.float() if sx_static is not None else _dynamic_scale(x2, -1)
        acc = int_mm(_quantize(x2, sx), q)
        y = (acc.float() * sx.float() * scale).to(x.dtype)
        return y.reshape(B, Ho, Wo, O)
    if sx_static is not None and groups == 1:
        (pt, pb), (pl, pr) = pads
        Ho = (H + pt + pb - kh) // sh + 1
        Wo = (W + pl + pr - kw) // sw + 1
        sx = sx_static.float()
        qx = F.pad(_quantize(x, sx), (0, 0, pl, pr, pt, pb))
        cols = torch.cat([qx[:, dy:dy + (Ho - 1) * sh + 1:sh, dx:dx + (Wo - 1) * sw + 1:sw, :]
                          for dy in range(kh) for dx in range(kw)], dim=-1)
        acc = int_mm(cols.reshape(B * Ho * Wo, kh * kw * C), q)
        return (acc.float() * sx * scale).to(x.dtype).reshape(B, Ho, Wo, O)
    sx = _dynamic_scale(x)
    (pt, pb), (pl, pr) = pads
    qx = F.pad(_quantize(x, sx).permute(0, 3, 1, 2).double(), (pl, pr, pt, pb))
    Ho = (qx.shape[2] - kh) // sh + 1
    Wo = (qx.shape[3] - kw) // sw + 1
    cols = F.unfold(qx, (kh, kw), stride=stride).reshape(B, groups, -1, Ho * Wo)
    wg = nn.derived(q, "int8_conv_f64", lambda: q.double().reshape(groups, O // groups, -1))
    acc = torch.einsum("gok,bgkl->bgol", wg, cols).reshape(B, O, Ho, Wo)
    y = acc.float().permute(0, 2, 3, 1) * (sx.float() * scale)
    return y.to(x.dtype)
