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
them in VMEM; one launch that keeps them on chip is later work. Only the
"exp" softmax and bf16 attention products are ported (JAX's exp2/exp2p and
int8 attention-math flavours are off by default there).
"""
from __future__ import annotations

from typing import Optional

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
                                   num_heads: int) -> torch.Tensor:
    """Plain version of K3 (_attn_proj_block_kernel, "exp" / "bf16")."""
    qkv = _qkv_ref(tok, wq, wscale, bias, ln_scale, ln_bias, sx_qkv)
    aq = _attention_ref(qkv, tok.shape[0], num_heads, sx_proj)
    return _proj_ref(aq, tok, wp, pscale, pbias, sx_proj)


def fused_int8_attn_proj_block_steps(tok, wq, wscale, bias, ln_scale, ln_bias, sx_qkv, sx_proj,
                                     wp, pscale, pbias, num_heads):
    """K3's three intermediate results (qkv (B*N, 3D) bf16, the attention
    output aq (B*N, D) int8, the output (B, N, K)), for the checks: on CUDA
    tensors from the kernels (no launch counted), on CPU tensors from the
    plain version."""
    if tok.device.type == "cpu":
        qkv = _qkv_ref(tok, wq, wscale, bias, ln_scale, ln_bias, sx_qkv)
        aq = _attention_ref(qkv, tok.shape[0], num_heads, sx_proj)
        return qkv, aq, _proj_ref(aq, tok, wp, pscale, pbias, sx_proj)
    return _launch(tok, wq, wscale, bias, ln_scale, ln_bias, sx_qkv, sx_proj, wp, pscale, pbias,
                   num_heads)


def fused_int8_attn_proj_block(tok: torch.Tensor, wq: torch.Tensor, wscale: torch.Tensor,
                               bias: Optional[torch.Tensor], ln_scale: torch.Tensor,
                               ln_bias: torch.Tensor, sx_qkv, sx_proj, wp: torch.Tensor,
                               pscale: torch.Tensor, pbias: Optional[torch.Tensor],
                               num_heads: int) -> torch.Tensor:
    """tok + proj(attn(LN(tok))) of the int8 ViT with both static scales,
    the JAX signature: tok (B, N, K) bf16/f32; wq (K, 3D) and wp (D, K) int8
    in the (in, out) layout, their per-channel scales and biases; ln
    vectors (K,); sx_qkv, sx_proj scalars. Returns (B, N, K) in tok.dtype.

    CPU tensors take the plain version. CUDA tensors launch the four kernels
    of the module docstring: K, 3D and the head width multiples of 16 and 8
    (any N: the attention pads N in shared memory); anything else raises.
    """
    cuda_build.refuse_grad("fused_int8_attn_proj_block", tok, wq, wscale, bias, ln_scale,
                           ln_bias, sx_qkv, sx_proj, wp, pscale, pbias)
    if tok.device.type == "cpu":
        return fused_int8_attn_proj_block_ref(tok, wq, wscale, bias, ln_scale, ln_bias, sx_qkv,
                                              sx_proj, wp, pscale, pbias, num_heads)
    out = _launch(tok, wq, wscale, bias, ln_scale, ln_bias, sx_qkv, sx_proj, wp, pscale, pbias,
                  num_heads)[2]
    fused_int8_attn_proj_block.launches += 1
    return out


fused_int8_attn_proj_block.launches = 0


def _launch(tok, wq, wscale, bias, ln_scale, ln_bias, sx_qkv, sx_proj, wp, pscale, pbias,
            num_heads):
    what = "fused_int8_attn_proj_block"
    B, N, K = tok.shape
    if wp.shape != (wq.shape[1] // 3, K):
        raise ValueError(f"{what}: unsupported shapes wq {tuple(wq.shape)}, wp "
                         f"{tuple(wp.shape)}, heads {num_heads}")
    sp = im._device_scale(sx_proj, tok.device, what)
    x2, qkv, aq = launch_ln_qkv_attention(tok, wq, wscale, bias, ln_scale, ln_bias, sx_qkv, sp,
                                          num_heads, what)
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


def check_against_plain(steps, tok, wq, wscale, bias, ln_scale, ln_bias, sx_qkv, sx_proj, wp,
                        pscale, pbias, num_heads) -> dict:
    """Raise unless K3's intermediate results ``steps`` (as
    fused_int8_attn_proj_block_steps returns them) agree with the plain
    version to the limits above; returns the readings (the end-to-end ones
    unprefixed)."""
    qkv, aq, out = steps
    rows = max(im.MAX_FRAC_ROWS_FLIPPED, 1.0 / qkv.shape[0])
    r = {}
    for name, got, ref in (
            ("qkv", qkv, _qkv_ref(tok, wq, wscale, bias, ln_scale, ln_bias, sx_qkv)),
            ("attention", aq, _attention_ref(qkv, tok.shape[0], num_heads, sx_proj)),
            ("proj", out, _proj_ref(aq, tok, wp, pscale, pbias, sx_proj))):
        step = im.check_against_plain(got, ref, f"K3's {name} step", rows)
        r.update({f"{name}_{k}": v for k, v in step.items()})
    return {**im.check_against_plain(out, fused_int8_attn_proj_block_ref(
        tok, wq, wscale, bias, ln_scale, ln_bias, sx_qkv, sx_proj, wp, pscale, pbias,
        num_heads), "K3", MAX_FRAC_ROWS_FLIPPED), **r}
