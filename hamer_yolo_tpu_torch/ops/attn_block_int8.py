"""Kernel K6: the int8 ViT attention block with static scales, from the
tokens to the quantized attention output (port of
hamer_yolo_tpu/ops/attention_pallas.py:fused_int8_attn_block):

  LN -> int8 quantize (sx_qkv) -> int8 qkv GEMM (int32) -> acc * (sq * sw)
  + b -> bf16 qkv -> per-head softmax attention -> * (1 / sx_proj), int8.

It is K3 (ops/attn_proj_block.py) up to the attention output; the proj GEMM
follows outside as ``int8_dot_prequant`` (a plain product in the JAX package
too). On the card it is three launches: the quantize and the qkv GEMM of
``csrc/int8_gemm.cu`` and the attention of ``csrc/short_attention.cu`` with
its int8 epilogue on views of the qkv buffer. The bf16 qkv (B*N, 3D) goes
through device memory between them, where the TPU kernel keeps it in VMEM;
one launch that keeps it on chip is later work. K3 makes the same three
launches (``launch_ln_qkv_attention``) before its proj GEMM; neither wrapper
calls the other. JAX's ``group`` (crops per grid step) is a TPU tile knob,
bit-identical across values, and is not carried over.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from hamer_yolo_tpu_torch.ops import cuda_build
from hamer_yolo_tpu_torch.ops import int8_matmul as im
from hamer_yolo_tpu_torch.ops.short_attention import (flavoured_attention_ref,
                                                       fused_short_attention_ref, launch_attention)


def qkv_ref(tok, wq, wscale, bias, ln_scale, ln_bias, sx_qkv) -> torch.Tensor:
    """LN -> quantize -> int8 qkv GEMM -> acc * (sq * sw) + b -> bf16 (B*N, 3D)."""
    B, N, K = tok.shape
    sq = im._as_scale(sx_qkv, tok.device)
    x = im.layer_norm_f32(tok.reshape(B * N, K).float(), ln_scale, ln_bias)
    return im.int8_gemm_ref(im.quantize_rows_ref(x, sq), wq, im.EPI_DEQ_FOLD, wscale, bias, s=sq)


def attention_ref(qkv: torch.Tensor, B: int, num_heads: int, sx_proj, softmax: str = "exp",
                  attn_math: str = "bf16") -> torch.Tensor:
    """(B*N, 3D) bf16 -> softmax attention per head -> * (1 / sx_proj), int8
    (B*N, D): K7's plain version with its int8 epilogue, or under another
    softmax flavour or int8 attention products K3's
    (short_attention.flavoured_attention_ref)."""
    hd = qkv.shape[1] // 3 // num_heads
    heads = qkv.reshape(B, -1, 3, num_heads, hd).permute(2, 0, 3, 1, 4)  # (3, B, h, N, hd)
    s = im._as_scale(sx_proj, qkv.device)
    if softmax == "exp" and attn_math == "bf16":
        aq = fused_short_attention_ref(heads[0], heads[1], heads[2], out_scale=s)
    else:
        aq = flavoured_attention_ref(heads[0], heads[1], heads[2], s, softmax, attn_math)
    return aq.transpose(1, 2).reshape(qkv.shape[0], num_heads * hd)


def fused_int8_attn_block_ref(tok: torch.Tensor, wq: torch.Tensor, wscale: torch.Tensor,
                              bias: Optional[torch.Tensor], ln_scale: torch.Tensor,
                              ln_bias: torch.Tensor, sx_qkv, sx_proj,
                              num_heads: int) -> torch.Tensor:
    """Plain version of K6 (_attn_block_kernel)."""
    B, N, _ = tok.shape
    qkv = qkv_ref(tok, wq, wscale, bias, ln_scale, ln_bias, sx_qkv)
    return attention_ref(qkv, B, num_heads, sx_proj).reshape(B, N, -1)


def launch_ln_qkv_attention(tok, wq, wscale, bias, ln_scale, ln_bias, sx_qkv, sp, num_heads,
                            what: str, softmax: str = "exp", attn_math: str = "bf16"
                            ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The three launches K6 and K3 share, on CUDA tokens (B, N, K): LN +
    static quantize, the int8 qkv GEMM with the folded dequant -> bf16, the
    attention with the int8 epilogue by the device scale ``sp`` (under K3's
    ``softmax`` and ``attn_math``). Returns the aligned token rows (B*N, K),
    qkv (B*N, 3D) bf16 and aq (B*N, D) int8."""
    if tok.device.type != "cuda":
        raise ValueError(f"{what}: unsupported device {tok.device}")
    B, N, K = tok.shape
    td = wq.shape[1]
    hd = td // 3 // num_heads
    D = num_heads * hd
    if td != 3 * D:
        raise ValueError(f"{what}: unsupported shapes wq {tuple(wq.shape)}, heads {num_heads}")
    dev = tok.device
    x2 = cuda_build.aligned16(tok.reshape(B * N, K))
    xq, _, sq = im.quantize_rows(x2, "ln", ln_scale, ln_bias, sx_qkv, what)
    qkv = torch.empty((B * N, td), dtype=torch.bfloat16, device=dev)
    im.int8_gemm(xq, wq, im.EPI_DEQ_FOLD, qkv, wscale, bias, s=sq, what=what)
    heads = qkv.reshape(B, N, 3, num_heads, hd).permute(2, 0, 3, 1, 4)  # (3, B, h, N, hd)
    aq = torch.empty((B * N, D), dtype=torch.int8, device=dev)
    launch_attention(heads[0], heads[1], heads[2],
                     aq.reshape(B, N, num_heads, hd).transpose(1, 2), sp, what, softmax, attn_math)
    return x2, qkv, aq


def fused_int8_attn_block_steps(tok, wq, wscale, bias, ln_scale, ln_bias, sx_qkv, sx_proj,
                                num_heads):
    """K6's two results (qkv (B*N, 3D) bf16, the output aq (B*N, D) int8), for
    the checks: on CUDA tensors from the kernels (no launch counted), on CPU
    tensors from the plain version."""
    if tok.device.type == "cpu":
        qkv = qkv_ref(tok, wq, wscale, bias, ln_scale, ln_bias, sx_qkv)
        return qkv, attention_ref(qkv, tok.shape[0], num_heads, sx_proj)
    what = "fused_int8_attn_block"
    sp = im._device_scale(sx_proj, tok.device, what)
    return launch_ln_qkv_attention(tok, wq, wscale, bias, ln_scale, ln_bias, sx_qkv, sp,
                                   num_heads, what)[1:]


def fused_int8_attn_block(tok: torch.Tensor, wq: torch.Tensor, wscale: torch.Tensor,
                          bias: Optional[torch.Tensor], ln_scale: torch.Tensor,
                          ln_bias: torch.Tensor, sx_qkv, sx_proj, num_heads: int) -> torch.Tensor:
    """attn(LN(tok)) of the int8 ViT with both static scales, quantized for
    the proj GEMM, the JAX signature: tok (B, N, K) bf16/f32; wq (K, 3D) int8
    in the (in, out) layout, wscale (3D,), bias (3D,) or None; ln vectors
    (K,); sx_qkv, sx_proj scalars. Returns (B, N, D) int8; consume it with
    ops.int8_matmul.int8_dot_prequant.

    CPU tensors take the plain version. CUDA tensors launch the three kernels
    of the module docstring: K and 3D multiples of 16, the head width of 8
    (any N); anything else raises.
    """
    cuda_build.refuse_grad("fused_int8_attn_block", tok, wq, wscale, bias, ln_scale, ln_bias,
                           sx_qkv, sx_proj)
    if tok.device.type == "cpu":
        return fused_int8_attn_block_ref(tok, wq, wscale, bias, ln_scale, ln_bias, sx_qkv,
                                         sx_proj, num_heads)
    aq = fused_int8_attn_block_steps(tok, wq, wscale, bias, ln_scale, ln_bias, sx_qkv, sx_proj,
                                     num_heads)[1]
    fused_int8_attn_block.launches += 1
    return aq.reshape(tok.shape[0], tok.shape[1], -1)


fused_int8_attn_block.launches = 0


# K6 against its plain version on the card. Each launch is held to the plain
# version of its step on the kernel's own input of the step, at K3's limits
# for these steps (ops/attn_proj_block.py): qkv at the bf16 limits of
# ops/int8_matmul.py (at least one row allowed, for the tiny shapes), the int8
# output at +-1 on at most 1% of elements. End to end (the output against the
# plain version run from the tokens) a qkv element that rounds to the
# neighbouring bf16 value moves a logit or a v term, and with it int8 outputs
# by more than one step: an H100 at ViT-H shapes read 2 steps at most, on
# 5.6e-4 of elements. The end-to-end limit is therefore a few steps on the
# same share of elements; a wrong crop, tile or head is off by tens of steps
# on 1/16 of them or more, and is caught in its step besides.
MAX_INT8_STEPS_END_TO_END = 4


def check_against_plain(steps, tok, wq, wscale, bias, ln_scale, ln_bias, sx_qkv, sx_proj,
                        num_heads) -> dict:
    """Raise unless K6's results ``steps`` (as fused_int8_attn_block_steps
    returns them) agree with the plain version to the limits above; returns
    the readings (the end-to-end ones unprefixed)."""
    qkv, aq = steps
    rows = max(im.MAX_FRAC_ROWS_FLIPPED, 1.0 / qkv.shape[0])
    r = {}
    for name, got, ref in (
            ("qkv", qkv, qkv_ref(tok, wq, wscale, bias, ln_scale, ln_bias, sx_qkv)),
            ("attention", aq, attention_ref(qkv, tok.shape[0], num_heads, sx_proj))):
        step = im.check_against_plain(got, ref, f"K6's {name} step", rows)
        r.update({f"{name}_{k}": v for k, v in step.items()})
    ref = fused_int8_attn_block_ref(tok, wq, wscale, bias, ln_scale, ln_bias, sx_qkv, sx_proj,
                                    num_heads)
    d = (aq.to(torch.int32) - ref.reshape(aq.shape).to(torch.int32)).abs()
    end = {"max_abs_err": float(d.max()), "frac_flipped": float((d > 0).float().mean())}
    if (end["max_abs_err"] > MAX_INT8_STEPS_END_TO_END
            or end["frac_flipped"] > im.MAX_FRAC_INT8_FLIPPED):
        raise AssertionError(f"K6 disagrees with its plain version: {end} (limits: "
                             f"{MAX_INT8_STEPS_END_TO_END} int8 steps, on at most "
                             f"{im.MAX_FRAC_INT8_FLIPPED} of elements)")
    return {**end, **r}
