"""Kernel K2: exact-bf16 fused LN + QKV GEMM + softmax attention (pre-proj).

Port of the TPU kernel
hamer_yolo_tpu/ops/attention_pallas.py:fused_bf16_attn_block, in three
launches: the LN rows, the QKV GEMM on Hopper's wgmma fed by a TMA ring
(both ``csrc/attn_block.cu``), then attention per (query tile, head, crop)
on views of the qkv buffer (``csrc/short_attention.cu``, the kernel K3 and
K7 launch too). The proj linear stays outside, as in JAX. The GEMM reads
the weight as bf16 in JAX's (K, 3D) layout; ``bf16_weight`` makes that copy
and its TMA map once per weight tensor.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from hamer_yolo_tpu_torch.core import nn
from hamer_yolo_tpu_torch.ops import cuda_build, torch_ops
from hamer_yolo_tpu_torch.ops.short_attention import launch_attention

TOKEN_DTYPES = (torch.bfloat16, torch.float32)  # what the kernel reads and writes


def fused_bf16_attn_block_ref(tok: torch.Tensor, w: torch.Tensor, bias: Optional[torch.Tensor],
                              ln_scale: torch.Tensor, ln_bias: torch.Tensor,
                              num_heads: int) -> torch.Tensor:
    """Plain version of K2, rounding where the TPU kernel rounds.

    tok (B, N, K) any float dtype; w (K, 3D); bias (3D,); ln_scale, ln_bias
    (K,). Returns (B, N, D) in tok.dtype.
    """
    B, N, _ = tok.shape
    qkv = ln_qkv_ref(tok, w, bias, ln_scale, ln_bias).reshape(B, N, -1)
    return attention_ref(qkv, num_heads, tok.dtype)


def attention_ref(qkv: torch.Tensor, num_heads: int, out_dtype: torch.dtype) -> torch.Tensor:
    """Plain version of K2's attention: bf16 qkv (B, N, 3D) as the QKV GEMM
    writes it -> (B, N, D) in ``out_dtype``, rounding where the TPU kernel
    rounds."""
    B, N, td = qkv.shape
    hd = td // 3 // num_heads
    qkv = qkv.float().reshape(B, N, 3, num_heads, hd)
    # bf16 q times hd^-0.5, which JAX's weak typing rounds to bf16 first
    q = (qkv[:, :, 0] * nn.weak_scalar(hd ** -0.5, torch.bfloat16)).to(torch.bfloat16).float()
    k, v = qkv[:, :, 1], qkv[:, :, 2]
    logits = torch.einsum("bnhd,bmhd->bhnm", q, k)
    m = torch.amax(logits, dim=-1, keepdim=True)
    e = torch.exp(logits - m)
    p = e * (1.0 / torch.sum(e, dim=-1, keepdim=True))
    p = p.to(torch.bfloat16).float()
    out = torch.einsum("bhnm,bmhd->bnhd", p, v).reshape(B, N, num_heads * hd)
    return out.to(out_dtype)


def ln_qkv_ref(x: torch.Tensor, w: torch.Tensor, bias: Optional[torch.Tensor],
               ln_scale: torch.Tensor, ln_bias: torch.Tensor) -> torch.Tensor:
    """Plain version of ``ln_qkv`` (K2's LN and QKV GEMM): x (..., K) ->
    bf16 (..., 3D), rounding where the TPU kernel rounds."""
    x = x.float()
    mu = x.mean(dim=-1, keepdim=True)
    var = torch.square(x - mu).mean(dim=-1, keepdim=True)
    x = (x - mu) * torch.rsqrt(var + 1e-6)
    x = x * ln_scale.float() + ln_bias.float()
    # bf16 x bf16 products are exact in f32, so an f32 product of the
    # bf16-rounded operands is the bf16 GEMM with f32 accumulation.
    qkv = x.to(torch.bfloat16).float() @ w.to(torch.bfloat16).float()
    if bias is not None:
        qkv = qkv + bias.float()
    return qkv.to(torch.bfloat16)


def fused_bf16_attn_block(tok: torch.Tensor, w: torch.Tensor, bias: Optional[torch.Tensor],
                          ln_scale: torch.Tensor, ln_bias: torch.Tensor,
                          num_heads: int) -> torch.Tensor:
    """K2 with the JAX signature: tok (B, N, K), w (K, 3D) as in JAX's
    (in, out) linear layout, bias (3D,), LN scale/bias (K,) -> (B, N, D).

    CPU tensors take the plain version. CUDA tensors launch
    ``csrc/attn_block.cu`` and ``csrc/short_attention.cu``: bf16 or f32
    tokens (the output has their dtype, as in JAX), any B and N, K and the
    head width multiples of 8, heads up to 128 wide; anything else raises.
    Traced (torch.export), it is the operator ``hyt_port::fused_bf16_attn_block``
    (ops/torch_ops.py), on any device.
    """
    cuda_build.refuse_grad("fused_bf16_attn_block", tok, w, bias, ln_scale, ln_bias)
    if torch.compiler.is_compiling():
        return torch_ops.fused_bf16_attn_block(tok, w, bias, ln_scale, ln_bias, num_heads)
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
    qkv = ln_qkv(tok.reshape(B * N, K), w, bias, ln_scale, ln_bias)
    out = torch.empty((B, N, D), dtype=tok.dtype, device=tok.device)
    heads = qkv.reshape(B, N, 3, num_heads, hd).permute(2, 0, 3, 1, 4)  # (3, B, h, N, hd)
    launch_attention(heads[0], heads[1], heads[2],
                     out.reshape(B, N, num_heads, hd).transpose(1, 2), None,
                     "fused_bf16_attn_block")
    fused_bf16_attn_block.launches += 1
    return out


def ln_qkv(x: torch.Tensor, w: torch.Tensor, bias: Optional[torch.Tensor],
           ln_scale: torch.Tensor, ln_bias: torch.Tensor) -> torch.Tensor:
    """K2's first two launches on CUDA tensors: x (M, K) bf16 or f32 ->
    qkv (M, 3D) bf16 = bf16(bf16(LN(x)) @ bf16(w) + bias), the LN rows and
    the QKV GEMM of ``csrc/attn_block.cu``. Shapes and devices as
    ``fused_bf16_attn_block`` checks them."""
    lib = cuda_build.load("attn_block.cu")
    dev = x.device
    M, K = x.shape
    td = w.shape[1]
    x = cuda_build.aligned16(x)
    wmap = _bf16_weight(w)[1]
    b32 = _f32(bias) if bias is not None else _zeros(w)
    g32, bt32 = _f32(ln_scale), _f32(ln_bias)
    xhat = torch.empty((M, K), dtype=torch.bfloat16, device=dev)  # the LN output
    qkv = torch.empty((M, td), dtype=torch.bfloat16, device=dev)
    idx = x.get_device()
    with torch.cuda.device(idx):  # an index: less host work than a device
        stream = torch.cuda.current_stream(idx).cuda_stream
        cuda_build.check(lib.hyt_ln_qkv(x.data_ptr(), int(x.dtype == torch.float32),
                                        ctypes.addressof(wmap), b32.data_ptr(), g32.data_ptr(),
                                        bt32.data_ptr(), xhat.data_ptr(), qkv.data_ptr(), M, K, td,
                                        stream),
                         "fused_bf16_attn_block: qkv_gemm_kernel")
    return qkv


def bf16_weight(w: torch.Tensor) -> torch.Tensor:
    """The bf16, contiguous, 16-byte aligned copy of K2's (K, 3D) weight
    ``w``, made once per weight tensor (``core.nn.cast_weight``, which counts
    the casts in ``cast_weight.casts``) and kept, with its TMA map on the
    card, while ``w`` lives unchanged."""
    return _bf16_weight(w)[0]


def _bf16_weight(w: torch.Tensor):
    """(bf16_weight(w), its TMA map: 128 bytes of host memory, or None for a
    CPU weight)."""
    if w.dim() != 2 or not w.is_floating_point():
        raise ValueError(f"bf16_weight: a float (K, N) weight, got {w.dtype} {tuple(w.shape)}")

    def make():
        w16 = cuda_build.aligned16(nn.cast_weight(w, torch.bfloat16))
        wmap = None
        if w16.is_cuda:
            wmap = ctypes.create_string_buffer(128)
            with torch.cuda.device(w16.get_device()):
                cuda_build.check(cuda_build.load("attn_block.cu").hyt_k2_weight_map(
                    w16.data_ptr(), w16.shape[0], w16.shape[1], ctypes.addressof(wmap)),
                    "bf16_weight: the weight's TMA map")
        return w16, wmap

    return nn.derived(w, "k2_bf16", make)


def _f32(v: torch.Tensor) -> torch.Tensor:
    """A (K,) or (3D,) vector as contiguous, 16-byte aligned f32."""
    return cuda_build.aligned16(v.to(torch.float32))


def _zeros(w: torch.Tensor) -> torch.Tensor:
    """The zero bias of a weight without one, made once per weight."""
    return nn.derived(w, "k2_zero_bias",
                      lambda: torch.zeros(w.shape[1], dtype=torch.float32, device=w.device))


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


def twin_readings(got: torch.Tensor, ref: torch.Tensor) -> dict:
    """How far K2's output ``got`` sits from its twin's ``ref``, in the
    measures the limits above bound."""
    err = (got.float() - ref.float()).abs()
    mag = ref.float().abs()
    return {"max_ulps": float((err / _bf16_ulp(torch.maximum(mag, mag.mean()))).max()),
            "frac_over_1ulp": float((err > _bf16_ulp(mag)).float().mean()),
            "frac_differing": float((err > 0).float().mean()),
            "max_abs_err": float(err.max())}


def check_against_twin(got: torch.Tensor, ref: torch.Tensor) -> dict:
    """Raise unless K2's output ``got`` agrees with its twin's ``ref`` to the
    limits above; returns the readings."""
    r = twin_readings(got, ref)
    bad = [f"max_ulps {r['max_ulps']:.4g} > {MAX_ULPS}"] if r["max_ulps"] > MAX_ULPS else []
    if r["frac_over_1ulp"] > MAX_FRAC_OVER_1ULP:
        bad.append(f"frac_over_1ulp {r['frac_over_1ulp']:.4g} > {MAX_FRAC_OVER_1ULP}")
    if got.dtype == torch.bfloat16 and r["frac_differing"] > MAX_FRAC_DIFFERING:
        bad.append(f"frac_differing {r['frac_differing']:.4g} > {MAX_FRAC_DIFFERING}")
    if bad:
        raise AssertionError("K2 disagrees with its twin: " + ", ".join(bad)
                             + f" (readings {r})")
    return r
