"""Kernel K2: exact-bf16 fused LN + QKV GEMM + softmax attention (pre-proj).

Port of the TPU kernel
hamer_yolo_tpu/ops/attention_pallas.py:fused_bf16_attn_block, in two
launches: LN + QKV GEMM (``csrc/attn_block.cu``), then attention per (query
tile, head, crop) on views of the qkv buffer (``csrc/short_attention.cu``,
the kernel K3 and K7 launch too). The proj linear stays outside, as in JAX.
"""
from __future__ import annotations

from typing import Optional

import torch

from hamer_yolo_tpu_torch.core.nn import weak_scalar
from hamer_yolo_tpu_torch.ops import cuda_build
from hamer_yolo_tpu_torch.ops.short_attention import launch_attention

TOKEN_DTYPES = (torch.bfloat16, torch.float32)  # what the kernel reads and writes


def fused_bf16_attn_block_ref(tok: torch.Tensor, w: torch.Tensor, bias: Optional[torch.Tensor],
                              ln_scale: torch.Tensor, ln_bias: torch.Tensor,
                              num_heads: int) -> torch.Tensor:
    """Plain version of K2, rounding where the TPU kernel rounds.

    tok (B, N, K) any float dtype; w (K, 3D); bias (3D,); ln_scale, ln_bias
    (K,). Returns (B, N, D) in tok.dtype.
    """
    B, N, K = tok.shape
    td = w.shape[1]
    hd = td // 3 // num_heads
    D = num_heads * hd
    x = tok.float()
    mu = x.mean(dim=-1, keepdim=True)
    var = torch.square(x - mu).mean(dim=-1, keepdim=True)
    x = (x - mu) * torch.rsqrt(var + 1e-6)
    x = x * ln_scale.float() + ln_bias.float()
    # bf16 x bf16 products are exact in f32, so an f32 product of the
    # bf16-rounded operands is the bf16 GEMM with f32 accumulation.
    qkv = x.to(torch.bfloat16).float() @ w.to(torch.bfloat16).float()
    if bias is not None:
        qkv = qkv + bias.float()
    qkv = qkv.to(torch.bfloat16).float().reshape(B, N, 3, num_heads, hd)
    # bf16 q times hd^-0.5, which JAX's weak typing rounds to bf16 first
    q = (qkv[:, :, 0] * weak_scalar(hd ** -0.5, torch.bfloat16)).to(torch.bfloat16).float()
    k, v = qkv[:, :, 1], qkv[:, :, 2]
    logits = torch.einsum("bnhd,bmhd->bhnm", q, k)
    m = torch.amax(logits, dim=-1, keepdim=True)
    e = torch.exp(logits - m)
    p = e * (1.0 / torch.sum(e, dim=-1, keepdim=True))
    p = p.to(torch.bfloat16).float()
    out = torch.einsum("bhnm,bmhd->bnhd", p, v).reshape(B, N, D)
    return out.to(tok.dtype)


def fused_bf16_attn_block(tok: torch.Tensor, w: torch.Tensor, bias: Optional[torch.Tensor],
                          ln_scale: torch.Tensor, ln_bias: torch.Tensor,
                          num_heads: int) -> torch.Tensor:
    """K2 with the JAX signature: tok (B, N, K), w (K, 3D) as in JAX's
    (in, out) linear layout, bias (3D,), LN scale/bias (K,) -> (B, N, D).

    CPU tensors take the plain version. CUDA tensors launch
    ``csrc/attn_block.cu`` and ``csrc/short_attention.cu``: bf16 or f32
    tokens (the output has their dtype, as in JAX), any N, K and the head
    width multiples of 8; anything else raises.
    """
    if tok.device.type == "cpu":
        return fused_bf16_attn_block_ref(tok, w, bias, ln_scale, ln_bias, num_heads)
    if tok.device.type != "cuda":
        raise ValueError(f"fused_bf16_attn_block: unsupported device {tok.device}")
    B, N, K = tok.shape
    td = w.shape[-1]
    hd = td // 3 // num_heads
    D = num_heads * hd
    if tok.dtype not in TOKEN_DTYPES:
        raise ValueError(f"fused_bf16_attn_block: the kernel takes bf16 or f32 tokens, "
                         f"got {tok.dtype}")
    if (w.shape != (K, td) or td != 3 * D or K % 8 or hd % 8
            or ln_scale.shape != (K,) or ln_bias.shape != (K,)
            or (bias is not None and bias.shape != (td,))):
        raise ValueError(f"fused_bf16_attn_block: unsupported shapes tok {tuple(tok.shape)}, "
                         f"w {tuple(w.shape)}, heads {num_heads}, LN {tuple(ln_scale.shape)}, "
                         f"{tuple(ln_bias.shape)}, bias "
                         f"{None if bias is None else tuple(bias.shape)}")
    if any(t is not None and t.device != tok.device for t in (w, bias, ln_scale, ln_bias)):
        raise ValueError(f"fused_bf16_attn_block: every tensor must be on {tok.device}")
    lib = cuda_build.load("attn_block.cu")
    dev = tok.device
    tok = cuda_build.aligned16(tok)
    w16 = cuda_build.aligned16(w.to(torch.bfloat16))
    b32 = (bias if bias is not None else torch.zeros(td, device=dev)).to(torch.float32).contiguous()
    g32 = ln_scale.to(torch.float32).contiguous()
    bt32 = ln_bias.to(torch.float32).contiguous()
    qkv = torch.empty((B * N, td), dtype=torch.bfloat16, device=dev)
    out = torch.empty((B, N, D), dtype=tok.dtype, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        cuda_build.check(lib.hyt_ln_qkv(tok.data_ptr(), int(tok.dtype == torch.float32),
                                        w16.data_ptr(), b32.data_ptr(), g32.data_ptr(),
                                        bt32.data_ptr(), qkv.data_ptr(), B * N, K, td, stream),
                         "fused_bf16_attn_block: ln_qkv_kernel")
    heads = qkv.reshape(B, N, 3, num_heads, hd).permute(2, 0, 3, 1, 4)  # (3, B, h, N, hd)
    launch_attention(heads[0], heads[1], heads[2],
                     out.reshape(B, N, num_heads, hd).transpose(1, 2), None,
                     "fused_bf16_attn_block")
    fused_bf16_attn_block.launches += 1
    return out


fused_bf16_attn_block.launches = 0

# How far K2 may sit from its twin. Both round at the same points, so they
# differ only where an f32 sum taken in another order lands on the other side
# of a bf16 rounding (LN statistics, the QKV GEMM, the softmax sum, p.v).
# Most such flips move an output by one bf16 ulp; a flipped q, k or v element
# moves a logit and can flip several p's, so a few outputs move by several
# ulps of the terms they sum (of |twin|, or of the output's mean magnitude
# where the sum cancels towards 0). The twin with its sums taken in f64 sits
# at most 3 such ulps away, with <= 1.3% of elements beyond 1 ulp of their own
# |twin| and <= 5.2% of bf16 elements differing at all (B 2, N 96-192,
# K 192-1280); the kernel on an H100 read up to 4.75 such ulps (bf16 and f32
# tokens at ViT-H shapes). Leaving out any one rounding point (LN output, the bf16
# scale, q * scale, p) puts >= 3.4% of elements beyond 1 ulp and makes >= 14%
# of bf16 elements differ: those two shares are what catch it, and
# tests/test_torch_attn_block.py holds the limits to both sides. The
# per-element limit catches a wrong row or tile, which is off by far more.
MAX_ULPS = 8.0             # of max(|twin|, mean |twin|), every element
MAX_FRAC_OVER_1ULP = 0.02  # share of elements beyond 1 ulp of their own |twin|
MAX_FRAC_DIFFERING = 0.08  # bf16 outputs: share of elements that differ at all


def _bf16_ulp(mag: torch.Tensor) -> torch.Tensor:
    _, e = torch.frexp(mag)
    return torch.ldexp(torch.ones_like(mag), e - 8)  # 2^(floor(log2 mag) - 7)


def check_against_twin(got: torch.Tensor, ref: torch.Tensor) -> dict:
    """Raise unless K2's output ``got`` agrees with its twin's ``ref`` to the
    limits above; returns the readings."""
    err = (got.float() - ref.float()).abs()
    mag = ref.float().abs()
    r = {"max_ulps": float((err / _bf16_ulp(torch.maximum(mag, mag.mean()))).max()),
         "frac_over_1ulp": float((err > _bf16_ulp(mag)).float().mean()),
         "frac_differing": float((err > 0).float().mean()),
         "max_abs_err": float(err.max())}
    bad = [f"max_ulps {r['max_ulps']:.4g} > {MAX_ULPS}"] if r["max_ulps"] > MAX_ULPS else []
    if r["frac_over_1ulp"] > MAX_FRAC_OVER_1ULP:
        bad.append(f"frac_over_1ulp {r['frac_over_1ulp']:.4g} > {MAX_FRAC_OVER_1ULP}")
    if got.dtype == torch.bfloat16 and r["frac_differing"] > MAX_FRAC_DIFFERING:
        bad.append(f"frac_differing {r['frac_differing']:.4g} > {MAX_FRAC_DIFFERING}")
    if bad:
        raise AssertionError("K2 disagrees with its twin: " + ", ".join(bad)
                             + f" (readings {r})")
    return r
