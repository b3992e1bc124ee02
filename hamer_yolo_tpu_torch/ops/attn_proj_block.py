"""Kernel K3: the int8 ViT attention block with static scales, from the
tokens to the residual sum (port of
hamer_yolo_tpu/ops/attention_pallas.py:fused_int8_attn_proj_block):

  LN -> int8 quantize (sx_qkv) -> int8 qkv GEMM (int32) -> acc * (sq * sw)
  + b -> bf16 qkv -> per-head softmax attention -> * (1 / sx_proj), int8
  -> int8 proj GEMM -> (acc * sp) * pw + pb -> token dtype -> + tok.

On the card it is four launches: the quantize and the qkv GEMM of
``csrc/int8_gemm.cu``, the attention of ``csrc/short_attention.cu`` with its
int8 epilogue on views of the qkv buffer, and the proj GEMM with the
residual epilogue. The bf16 qkv (B*N, 3D) and the int8 attention output
(B*N, D) go through device memory between them, where the TPU kernel keeps
them in VMEM; one launch that keeps them on chip is later work.

JAX's two switches of this kernel, off by default there and here, pick the
attention launch's form (``softmax`` and ``attn_math``, read from
HYT_SOFTMAX and HYT_ATTN_MATH by core/quant.py): "exp2" and "exp2p" run the
attention kernel of ``csrc/short_attention.cu`` built with that flavour, the
int8 products a quantize pre-pass and an attention kernel of their own
(wgmma s8 on the pre-pass's int8 tiles); both in
``csrc/attention_flavours.cu`` (plain version:
ops/short_attention.flavoured_attention_ref).
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from hamer_yolo_tpu_torch.ops import cuda_build
from hamer_yolo_tpu_torch.ops import int8_matmul as im
from hamer_yolo_tpu_torch.ops.attn_block_int8 import attention_ref as _attention_ref
from hamer_yolo_tpu_torch.ops.attn_block_int8 import launch_ln_qkv_attention
from hamer_yolo_tpu_torch.ops.attn_block_int8 import qkv_ref as _qkv_ref


def _proj_ref(aq: torch.Tensor, tok, wp, pscale, pbias, sx_proj) -> torch.Tensor:
    """int8 proj GEMM -> (acc * sp) * pw + pb -> token dtype -> + tok."""
    out = im.int8_gemm_ref(aq, wp, im.EPI_PROJ, pscale, pbias, s=sx_proj,
                           res=tok.reshape(aq.shape[0], -1), out_dtype=tok.dtype)
    return out.reshape(tok.shape)


def fused_int8_attn_proj_block_ref(tok: torch.Tensor, wq: torch.Tensor, wscale: torch.Tensor,
                                   bias: Optional[torch.Tensor], ln_scale: torch.Tensor,
                                   ln_bias: torch.Tensor, sx_qkv, sx_proj, wp: torch.Tensor,
                                   pscale: torch.Tensor, pbias: Optional[torch.Tensor],
                                   num_heads: int, softmax: str = "exp",
                                   attn_math: str = "bf16") -> torch.Tensor:
    """Plain version of K3 (_attn_proj_block_kernel)."""
    qkv = _qkv_ref(tok, wq, wscale, bias, ln_scale, ln_bias, sx_qkv)
    aq = _attention_ref(qkv, tok.shape[0], num_heads, sx_proj, softmax, attn_math)
    return _proj_ref(aq, tok, wp, pscale, pbias, sx_proj)


def fused_int8_attn_proj_block_steps(tok, wq, wscale, bias, ln_scale, ln_bias, sx_qkv, sx_proj,
                                     wp, pscale, pbias, num_heads, softmax: str = "exp",
                                     attn_math: str = "bf16"):
    """K3's three intermediate results (qkv (B*N, 3D) bf16, the attention
    output aq (B*N, D) int8, the output (B, N, K)), for the checks: on CUDA
    tensors from the kernels (no launch counted), on CPU tensors from the
    plain version."""
    if tok.device.type == "cpu":
        qkv = _qkv_ref(tok, wq, wscale, bias, ln_scale, ln_bias, sx_qkv)
        aq = _attention_ref(qkv, tok.shape[0], num_heads, sx_proj, softmax, attn_math)
        return qkv, aq, _proj_ref(aq, tok, wp, pscale, pbias, sx_proj)
    return _launch(tok, wq, wscale, bias, ln_scale, ln_bias, sx_qkv, sx_proj, wp, pscale, pbias,
                   num_heads, softmax, attn_math)


def fused_int8_attn_proj_block(tok: torch.Tensor, wq: torch.Tensor, wscale: torch.Tensor,
                               bias: Optional[torch.Tensor], ln_scale: torch.Tensor,
                               ln_bias: torch.Tensor, sx_qkv, sx_proj, wp: torch.Tensor,
                               pscale: torch.Tensor, pbias: Optional[torch.Tensor],
                               num_heads: int, softmax: str = "exp",
                               attn_math: str = "bf16") -> torch.Tensor:
    """tok + proj(attn(LN(tok))) of the int8 ViT with both static scales,
    the JAX signature: tok (B, N, K) bf16/f32; wq (K, 3D) and wp (D, K) int8
    in the (in, out) layout, their per-channel scales and biases; ln
    vectors (K,); sx_qkv, sx_proj scalars. Returns (B, N, K) in tok.dtype.

    ``softmax`` ("exp", "exp2", "exp2p"; JAX's HYT_SOFTMAX) and ``attn_math``
    ("bf16", "int8"; HYT_ATTN_MATH) pick the attention step's form
    (short_attention.flavoured_attention_ref).

    CPU tensors take the plain version. CUDA tensors launch the four kernels
    of the module docstring (five under the int8 products, whose attention
    step is a quantize pre-pass and the attention launch): K, 3D and the head
    width multiples of 16 and 8, any N; anything else raises.
    """
    cuda_build.refuse_grad("fused_int8_attn_proj_block", tok, wq, wscale, bias, ln_scale,
                           ln_bias, sx_qkv, sx_proj, wp, pscale, pbias)
    if tok.device.type == "cpu":
        return fused_int8_attn_proj_block_ref(tok, wq, wscale, bias, ln_scale, ln_bias, sx_qkv,
                                              sx_proj, wp, pscale, pbias, num_heads, softmax,
                                              attn_math)
    out = _launch(tok, wq, wscale, bias, ln_scale, ln_bias, sx_qkv, sx_proj, wp, pscale, pbias,
                  num_heads, softmax, attn_math)[2]
    fused_int8_attn_proj_block.launches += 1
    if (softmax, attn_math) != ("exp", "bf16"):
        key = variant_name(softmax, attn_math)
        variants = fused_int8_attn_proj_block.variant_launches
        variants[key] = variants.get(key, 0) + 1
    return out


fused_int8_attn_proj_block.launches = 0
# the launches under another softmax flavour or attention products, by
# variant_name (counted in ``launches`` too)
fused_int8_attn_proj_block.variant_launches = {}


def variant_name(softmax: str, attn_math: str) -> str:
    """A non-default form of K3 by name: "exp2", "exp2p", "int8" or
    "int8 exp2" (int8 products with exp2p are int8 with exp2, as in JAX)."""
    if attn_math == "int8":
        return "int8 exp2" if softmax in ("exp2", "exp2p") else "int8"
    return softmax


def _launch(tok, wq, wscale, bias, ln_scale, ln_bias, sx_qkv, sx_proj, wp, pscale, pbias,
            num_heads, softmax="exp", attn_math="bf16"):
    what = "fused_int8_attn_proj_block"
    B, N, K = tok.shape
    if wp.shape != (wq.shape[1] // 3, K):
        raise ValueError(f"{what}: unsupported shapes wq {tuple(wq.shape)}, wp "
                         f"{tuple(wp.shape)}, heads {num_heads}")
    sp = im._device_scale(sx_proj, tok.device, what)
    x2, qkv, aq = launch_ln_qkv_attention(tok, wq, wscale, bias, ln_scale, ln_bias, sx_qkv, sp,
                                          num_heads, what, softmax, attn_math)
    out = torch.empty_like(x2)
    im.int8_gemm(aq, wp, im.EPI_PROJ, out, pscale, pbias, s=sp, res=x2, what=what)
    return qkv, aq, out.reshape(B, N, K)


# K3 against its plain version on the card. End to end (the output against
# the plain version's): each row of the proj GEMM's input is 1280 quantized
# attention outputs, and a softmax sum taken in another order flips one of
# them far more often than an LN flips a GEMM input. Readings of
# chip_smoke.py on an H100 at ViT-H shapes: 0.6-9.2% of rows, errors at most
# 0.051 of the mean magnitude (a bf16 residual sum rounds at 1/128 of
# itself). A limit that loose could hide a fault confined to one crop (1/16
# of the rows), so check_against_plain also holds each launch's result to
# the plain version of that step on the kernel's own input of the step, where
# no flip carries over from an earlier step: qkv and the output at the
# bf16 limits of ops/int8_matmul.py (at least one row allowed, for the tiny
# shapes), the int8 attention output at +-1 on at most 1% of elements. A
# wrong crop, tile or head then moves 1/16 of the rows or more (or an int8
# value by more than 1) in the step at fault. tests/test_torch_int8_kernels.py
# ::TestLimits holds the limits to both sides: a plain version with its
# softmax in f64 passes, one with p left unrounded before p.v fails, and so
# does one crop whose proj output is left out.
MAX_FRAC_ROWS_FLIPPED = 0.15
# Under the int8 attention products (HYT_ATTN_MATH=int8) the attention step's
# int8 output is held by another bound: p is quantized at 1/127, so a p that
# sits within an ulp of a rounding midpoint (the softmax sum taken in another
# order) moves its output row by vi * sv / 127 / sx_proj, up to sv / sx_proj
# int8 steps with sv the head's v scale: an H100 at ViT-H shapes read 3 steps
# on 1.5e-5 of elements (3 = 1 + sv / sx_proj rounded up there). The limit is
# therefore 1 + ceil(max sv / sx_proj) steps on at most 1% of elements
# (int8_products_steps); a wrong head or tile moves 1/16 of them or more.
# End to end the plain version's qkv also differs from the kernel's by bf16
# flips on a few rows, and the int8 products quantize each head by its
# absmax: a flip of a head's largest element moves its scale and can flip
# many of its int8 values at once, so the error carried from the qkv step
# spans those steps too. The end-to-end error limit is therefore
# ops/int8_matmul's MAX_ERR_OVER_MEAN times the steps (end_to_end_limit; an
# H100 read 0.118 of the mean magnitude on random tokens with the attention
# step bit-equal on the kernel's own qkv, against 0.3 at 3 steps). The steps
# grow with the head's v range against the static proj scale, without a
# bound of the data's own (a flat softmax averages v far below its range), so
# they are capped at MAX_INT8_PRODUCTS_STEPS: beyond it one rounding flip of
# p moves an output further than the check can tell from a fault, and
# int8_products_steps raises rather than pass such data.
# tests/test_torch_kernel_flavours.py::TestLimits holds the step's limit and
# the end-to-end one to both sides: a plain version with its softmax in f64
# passes, one that leaves p unrounded fails, and so does one crop whose proj
# output is left out (end to end, the test's readings at 7 steps: the f64
# softmax 0.0 of the mean, p unrounded 0.172 with every row beyond one
# rounding, the dropped crop 5.48).
MAX_INT8_PRODUCTS_STEPS = 8


def int8_products_steps(qkv: torch.Tensor, B: int, num_heads: int, sx_proj) -> int:
    """The int8 products' attention-step limit, in int8 steps, from the v
    heads of ``qkv`` (B*N, 3D) and the static proj scale; raises past
    MAX_INT8_PRODUCTS_STEPS."""
    hd = qkv.shape[1] // 3 // num_heads
    v = qkv.reshape(B, -1, 3, num_heads, hd)[:, :, 2].float()
    sv = float(torch.amax(torch.abs(v), dim=(1, 3)).max()) * im.RECIP_127
    steps = 1 + int(np.ceil(sv / float(im._as_scale(sx_proj, qkv.device))))
    if steps > MAX_INT8_PRODUCTS_STEPS:
        raise ValueError(f"K3 (int8 products): a rounding flip of p moves the attention output "
                         f"by up to {steps} int8 steps (v scale {sv:.4g} against sx_proj), "
                         f"past the {MAX_INT8_PRODUCTS_STEPS} the check can hold")
    return steps


def end_to_end_limit(steps: int) -> float:
    """The end-to-end limit on the max error over the mean magnitude when an
    attention-step flip may span ``steps`` int8 steps."""
    return im.MAX_ERR_OVER_MEAN * steps


def check_against_plain(steps, tok, wq, wscale, bias, ln_scale, ln_bias, sx_qkv, sx_proj, wp,
                        pscale, pbias, num_heads, softmax: str = "exp",
                        attn_math: str = "bf16") -> dict:
    """Raise unless K3's intermediate results ``steps`` (as
    fused_int8_attn_proj_block_steps returns them under ``softmax`` and
    ``attn_math``) agree with the plain version to the limits above; returns
    the readings (the end-to-end ones unprefixed)."""
    qkv, aq, out = steps
    rows = max(im.MAX_FRAC_ROWS_FLIPPED, 1.0 / qkv.shape[0])
    what = _what(softmax, attn_math)
    steps = 1
    if attn_math == "int8":
        steps = int8_products_steps(qkv, tok.shape[0], num_heads, sx_proj)
    r = {}
    for name, got, ref in (
            ("qkv", qkv, _qkv_ref(tok, wq, wscale, bias, ln_scale, ln_bias, sx_qkv)),
            ("attention", aq, _attention_ref(qkv, tok.shape[0], num_heads, sx_proj, softmax,
                                             attn_math)),
            ("proj", out, _proj_ref(aq, tok, wp, pscale, pbias, sx_proj))):
        if name == "attention" and attn_math == "int8":
            step = _check_int8_steps(got, ref, steps, what)
        else:
            step = im.check_against_plain(got, ref, f"{what}'s {name} step", rows)
        r.update({f"{name}_{k}": v for k, v in step.items()})
    return {**check_end_to_end(out, tok, wq, wscale, bias, ln_scale, ln_bias, sx_qkv, sx_proj,
                               wp, pscale, pbias, num_heads, softmax, attn_math, steps), **r}


def _what(softmax: str, attn_math: str) -> str:
    return "K3" if (softmax, attn_math) == ("exp", "bf16") else \
        f"K3 ({variant_name(softmax, attn_math)})"


def check_end_to_end(out, tok, wq, wscale, bias, ln_scale, ln_bias, sx_qkv, sx_proj, wp, pscale,
                     pbias, num_heads, softmax: str = "exp", attn_math: str = "bf16",
                     steps: int = 1) -> dict:
    """Raise unless K3's output ``out`` agrees with the plain version's to the
    end-to-end limits above, an attention-step flip spanning ``steps`` int8
    steps; returns the readings."""
    what = _what(softmax, attn_math)
    ref = fused_int8_attn_proj_block_ref(tok, wq, wscale, bias, ln_scale, ln_bias, sx_qkv,
                                         sx_proj, wp, pscale, pbias, num_heads, softmax,
                                         attn_math)
    return im.check_against_plain(out, ref, what, MAX_FRAC_ROWS_FLIPPED, end_to_end_limit(steps))


def _check_int8_steps(got: torch.Tensor, ref: torch.Tensor, steps: int, what: str) -> dict:
    d = (got.to(torch.int32) - ref.to(torch.int32)).abs()
    r = {"max_abs_err": float(d.max()), "frac_flipped": float((d > 0).float().mean()),
         "limit_steps": steps}
    if r["max_abs_err"] > steps or r["frac_flipped"] > im.MAX_FRAC_INT8_FLIPPED:
        raise AssertionError(f"{what}'s attention step disagrees with its plain version: {r} "
                             f"(limits: {steps} int8 steps on at most "
                             f"{im.MAX_FRAC_INT8_FLIPPED} of elements)")
    return r
