"""Kernels K5, K4 and K10: the fused W8A8 int8 GEMMs of the int8 ViT (port of
hamer_yolo_tpu/ops/int8_matmul.py).

- K5 ``fused_int8_matmul``: an f32 [ln | gelu | gelu_poly | id] prologue,
  a per-row dynamic (or static) int8 quantize, the int8 GEMM with int32
  sums, and the per-channel dequant + bias.
- K4 ``fused_int8_mlp_block``: tok + fc2(GELU(fc1(LN(tok)))) with static
  scales: LN -> quantize (sx1) -> fc1 -> dequant -> GELU -> quantize (sx2)
  -> int8 (M, H); then fc2 -> dequant -> + residual in f32.
- K10 ``fused_int8_mlp_block1``: K4 in one launch, H taken in chunks with
  the fc2 partial sums added in int32, bit-identical to K4.

All run on ``csrc/int8_gemm.cu``: a quantize-rows launch (prologue and
quantize, one warp per row) and an int8 GEMM launch (wgmma s8 fed by TMA,
dequant epilogue); K4 is one quantize launch and two GEMMs; K10 is one launch
of its own kernel there, on a thread-block cluster per 64 token rows that
splits fc2's columns over its CTAs and shares each GELU chunk through
distributed shared memory (``mlp1_cluster`` chooses its size). The GEMM and
K10 read each weight K-major: ``kmajor_weight`` makes that (N, K) copy once
per weight, with its TMA map, and counts the copies it makes;
``core/quant.quantize_vit_params`` makes them when it quantizes on
the card, any other int8 weight gets its copy at its first launch. Each
``*_ref`` function is the plain version, in the f32 op order of its TPU
kernel, which the CPU takes and the card's checks compare against;
``int8_gemm_ref`` is that of one GEMM launch.

K5 has two forms, as JAX's ``fused_int8_matmul`` has. Up to
``FUSED_GEMM_MAX_M`` rows (the flat M of a call: the port has no vmap, so its
M is the collapsed one that JAX's custom_vmap rule decides on), or under
``force="pallas"``, the TPU kernel's f32 arithmetic above. Above it, or under
``force="xla"``, JAX's inline XLA chain (``_xla_chain``), whose arithmetic
differs: the prologue, the absmax and the quantize division in the tokens'
dtype, and the dequant ``acc * (sx * sw) + b`` in f32 or, under
``HYT_INT8_EP=bf16`` (read at each call), in bf16 (``chain_*_ref``). On the
card the chain runs on the same two launches: the quantize launch's
token-dtype form and the GEMM's EPI_CHAIN_F32 / EPI_CHAIN_BF16 epilogue.
"""
from __future__ import annotations

import ctypes
import os
from typing import Optional

import numpy as np
import torch

from hamer_yolo_tpu_torch.core import nn
from hamer_yolo_tpu_torch.ops import cuda_build

PROLOGUES = ("id", "ln", "gelu", "gelu_poly")
_TOKEN_DTYPES = (torch.bfloat16, torch.float32)
_OUT_KIND = {torch.bfloat16: 0, torch.float32: 1, torch.int8: 2}
# Epilogues of csrc/int8_gemm.cu
(EPI_DEQ_ROW, EPI_DEQ_FOLD, EPI_GELU_Q, EPI_RESID, EPI_PROJ, EPI_CHAIN_F32,
 EPI_CHAIN_BF16) = range(7)
# Above this many rows JAX's fused_int8_matmul runs its XLA chain in place of
# the Pallas kernel (hamer_yolo_tpu/ops/int8_matmul.py FUSED_GEMM_MAX_M); so
# does the port, with the chain's arithmetic. A module constant, so that tests
# can lower it in both packages.
FUSED_GEMM_MAX_M = 8192
FORCES = (None, "pallas", "xla")
# K10's kernel: a cluster of at most 8 CTAs (the portable limit), each with
# 160 of fc2's output columns in registers, so tokens at most 1280 wide.
MLP1_COLS_PER_CTA = 160
MLP1_MAX_CLUSTER = 8
MLP1_MAX_K = MLP1_COLS_PER_CTA * MLP1_MAX_CLUSTER
MLP1_FC1_COLS = 64  # fc1 columns of a CTA in each chunk of H


def mlp1_cluster(K: int) -> int:
    """The CTAs of K10's cluster for tokens K wide: ceil(K / 160), so that
    no CTA is idle; its chunk of H is 64 columns a CTA."""
    if not 0 < K <= MLP1_MAX_K:
        raise ValueError(f"fused_int8_mlp_block1: K = {K} (at most {MLP1_MAX_K})")
    return -(-K // MLP1_COLS_PER_CTA)


# Even-polynomial GELU: GELU(x) = x/2 + E(x), E(u = x^2) of degree 8, a
# Chebyshev least-squares fit on |x| <= 4 (hamer_yolo_tpu/ops/int8_matmul.py
# _GELU_POLY_U); |x| > 4 takes the asymptotes x and 0.
GELU_POLY_U = (
    3.138923846637831e-05, 0.3985892442238482, -0.0658308598919238,
    0.009491168272223864, -0.001005431695009259, 7.497100545436031e-05,
    -3.6818665106501106e-06, 1.0570036565177172e-07,
    -1.3327008826321846e-09)
# erf by Abramowitz & Stegun 7.1.26 (|err| <= 1.5e-7): the TPU kernel has
# no erf, so its exact GELU uses this rational form.
_ERF_A = (0.254829592, -0.284496736, 1.421413741, -1.453152027, 1.061405429)
_ERF_P = 0.3275911
_SQRT2 = 1.4142135623730951


def recip_f32(c: float) -> float:
    """f32(1 / c): JAX's compiled programs divide by a constant as a product
    with its f32 reciprocal (XLA's simplifier rewrites x / c, and mean's
    sum / n, that way), so the port multiplies where the JAX source divides
    by a constant."""
    return float(np.float32(1.0) / np.float32(c))


RECIP_127 = recip_f32(127.0)
_RECIP_SQRT2 = recip_f32(_SQRT2)


def gelu_prologue(device) -> str:
    """The GELU flavour of the int8 MLP on ``device``: the polynomial on the
    card, as the JAX package takes it on the TPU, the A&S-erf form
    elsewhere."""
    return "gelu_poly" if torch.device(device).type == "cuda" else "gelu"


def _f32(v: float) -> torch.Tensor:
    return torch.tensor(v, dtype=torch.float32)


def gelu_poly_f32(x: torch.Tensor) -> torch.Tensor:
    u = torch.clamp(x * x, max=16.0)
    e = _f32(GELU_POLY_U[-1]).to(x.device)
    for c in GELU_POLY_U[-2::-1]:
        e = e * u + _f32(c).to(x.device)
    y = 0.5 * x + e
    y = torch.where(x > 4.0, x, y)
    return torch.where(x < -4.0, torch.zeros_like(y), y)


def erf_f32(x: torch.Tensor) -> torch.Tensor:
    a1, a2, a3, a4, a5 = _ERF_A
    ax = torch.abs(x)
    t = 1.0 / (1.0 + _ERF_P * ax)
    poly = ((((a5 * t + a4) * t + a3) * t + a2) * t + a1) * t
    return torch.sign(x) * (1.0 - poly * torch.exp(-ax * ax))


def layer_norm_f32(x: torch.Tensor, g: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """LN of the TPU kernels' prologue in f32, eps 1e-6: means as sums
    times f32(1 / K); rsqrt correctly rounded on either device, as in the
    kernel (XLA's own f32 rsqrt is within 1 ulp of it, and equal in most
    rows)."""
    inv_k = recip_f32(x.shape[-1])
    mu = x.sum(dim=-1, keepdim=True) * inv_k
    var = torch.square(x - mu).sum(dim=-1, keepdim=True) * inv_k
    rstd = torch.rsqrt((var + 1e-6).double()).float()
    return (x - mu) * rstd * g.float() + b.float()


def prologue_f32(x: torch.Tensor, prologue: str, g=None, b=None) -> torch.Tensor:
    """x f32 -> f32 after the fused elementwise stage (_prologue_f32)."""
    if prologue == "ln":
        return layer_norm_f32(x, g, b)
    if prologue == "gelu":
        return 0.5 * x * (1.0 + erf_f32(x * _RECIP_SQRT2))
    if prologue == "gelu_poly":
        return gelu_poly_f32(x)
    if prologue != "id":
        raise ValueError(f"unknown prologue {prologue!r}")
    return x


def quantize_rows_ref(x: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """clip(round(x * (1 / scale)), +-127) as int8: the kernels multiply by
    one reciprocal (core/quant's unfused form divides)."""
    return torch.clamp(torch.round(x * (1.0 / scale)), -127, 127).to(torch.int8)


def int_dot(xq: torch.Tensor, wq: torch.Tensor) -> torch.Tensor:
    """(..., K) int8 @ (K, N) int8 with exact integer sums, as f32 (the
    int32 sum rounded to nearest): an f64 product on either device, exact
    at these sizes (|sum| <= 127^2 K < 2^53) and free of the shape rules of
    cuBLASLt's int8 product (torch._int_mm refuses some small shapes)."""
    lead, K = xq.shape[:-1], xq.shape[-1]
    acc = xq.reshape(-1, K).double() @ wq.double()
    return acc.float().reshape(*lead, wq.shape[1])


def _as_scale(s, device) -> torch.Tensor:
    return torch.as_tensor(s, dtype=torch.float32, device=device).reshape(())


# Epilogues of csrc/int8_gemm.cu's GEMM whose scale is applied before the
# weight scale ((acc * s) * sw); the others fold them (acc * (s * sw)).
_UNFOLDED = (EPI_DEQ_ROW, EPI_PROJ)


def int8_gemm_ref(a: torch.Tensor, w: torch.Tensor, epi: int, wscale: torch.Tensor,
                  bias: Optional[torch.Tensor] = None, *, row_scale=None, s=None, res=None,
                  out_scale=None, gelu: str = "gelu", out_dtype=torch.bfloat16) -> torch.Tensor:
    """Plain version of one ``int8_gemm`` launch: the epilogue ``epi`` of the
    exact product int_dot(a, w), a (M, K) int8, w (K, N) int8, in the
    kernel's f32 op order. ``row_scale`` (M,) or the scalar ``s`` scales the
    product (EPI_CHAIN_*: chain_dequant_ref); ``res`` (M, N) is the residual
    of EPI_RESID (added in f32) and EPI_PROJ (added to the output rounded to
    ``out_dtype``); ``out_scale`` and ``gelu`` ("gelu" or "gelu_poly") make
    EPI_GELU_Q's int8 output. Returns (M, N) in ``out_dtype`` (int8 for
    EPI_GELU_Q)."""
    acc = int_dot(a, w)
    sc = (row_scale.float().reshape(-1, 1) if row_scale is not None
          else _as_scale(s, a.device))
    if epi in (EPI_CHAIN_F32, EPI_CHAIN_BF16):
        ep = torch.float32 if epi == EPI_CHAIN_F32 else torch.bfloat16
        return chain_dequant_ref(acc, sc, wscale, bias, ep, out_dtype)
    y = acc * sc * wscale.float() if epi in _UNFOLDED else acc * (sc * wscale.float())
    if bias is not None:
        y = y + bias.float()
    if epi == EPI_GELU_Q:
        return quantize_rows_ref(prologue_f32(y, gelu), _as_scale(out_scale, a.device))
    if epi == EPI_RESID:
        return (res.float() + y).to(out_dtype)
    if epi == EPI_PROJ:
        return res.to(out_dtype) + y.to(out_dtype)
    return y.to(out_dtype)


# ------------------------------------------------------- K5's chain form
def int8_ep_dtype() -> torch.dtype:
    """The chain's dequant dtype: bf16 where HYT_INT8_EP is "bf16", else f32.
    Read at each call (JAX reads it when it traces)."""
    return torch.bfloat16 if os.environ.get("HYT_INT8_EP") == "bf16" else torch.float32


def uses_chain(M: int, force=None) -> bool:
    """Whether K5 takes its chain form for M flat rows: above
    FUSED_GEMM_MAX_M unless ``force`` is "pallas", or always under "xla"."""
    if force not in FORCES:
        raise ValueError(f"fused_int8_matmul: force {force!r} (None, 'pallas' or 'xla')")
    return force != "pallas" and (force == "xla" or M > FUSED_GEMM_MAX_M)


def fma_f32(a: torch.Tensor, b, c) -> torch.Tensor:
    """a * b + c rounded once to f32, as XLA's CPU code contracts an f32
    multiply and add: the product is exact in f64, the sum rounds there and
    then to f32 (a double rounding that parts from one rounding only where the
    f64 sum lands on an f32 midpoint)."""
    b = b.double() if isinstance(b, torch.Tensor) else b
    c = c.double() if isinstance(c, torch.Tensor) else c
    return (a.double() * b + c).float()


def chain_prologue_ref(x: torch.Tensor, prologue: str, g=None, b=None) -> torch.Tensor:
    """The chain's prologue (_xla_chain's _prologue_f32 call) in the tokens'
    dtype: each op rounds to that dtype, its constants rounded to it first
    (JAX's weak typing); LN's means sum in f32 and round once, LN's vectors
    are cast to the dtype. The polynomial GELU's coefficients are strong f32,
    so its polynomial runs in f32 whatever the tokens, with XLA's multiply-add
    contractions, and its output is f32. An f32 multiply and add of the other
    prologues is left uncontracted, as in the kernel form's plain version
    (prologue_f32)."""
    dt = x.dtype
    if dt == torch.float32 and prologue != "gelu_poly":
        return prologue_f32(x, prologue, g, b)

    def w(v):
        return nn.weak_scalar(v, dt)

    if prologue == "ln":
        mu = torch.mean(x, dim=-1, keepdim=True)
        d = x - mu
        var = torch.mean(torch.square(d), dim=-1, keepdim=True)
        return d * nn.rsqrt(var + w(1e-6)) * g.to(dt) + b.to(dt)
    if prologue == "gelu":
        z = x / w(_SQRT2)
        az = torch.abs(z)
        t = 1.0 / (1.0 + w(_ERF_P) * az)
        a1, a2, a3, a4, a5 = (w(a) for a in _ERF_A)
        poly = ((((a5 * t + a4) * t + a3) * t + a2) * t + a1) * t
        return 0.5 * x * (1.0 + torch.sign(z) * (1.0 - poly * torch.exp(-az * az)))
    if prologue == "gelu_poly":
        u = torch.clamp(x * x, max=16.0).float()
        e = torch.full_like(u, GELU_POLY_U[-1])
        for c in GELU_POLY_U[-2::-1]:
            e = fma_f32(e, u, float(np.float32(c)))
        y = (0.5 * x).float() + e
        y = torch.where(x > 4.0, x.float(), y)
        return torch.where(x < -4.0, torch.zeros_like(y), y)
    if prologue != "id":
        raise ValueError(f"unknown prologue {prologue!r}")
    return x


def chain_quantize_ref(x: torch.Tensor, static_scale=None):
    """The chain's quantize in x's dtype: sx = max(f32(absmax / 127), 1e-8)
    per row with the division in x's dtype (f32: times f32(1 / 127), as
    compiled JAX divides by a constant), or the static scale; then
    clip(round(x / sx), +-127) with sx cast to x's dtype and a true division
    in it. Returns (int8 (M, K), sx (M, 1) or (1, 1) f32)."""
    if static_scale is None:
        absmax = torch.amax(torch.abs(x), dim=-1, keepdim=True)
        q = absmax * RECIP_127 if x.dtype == torch.float32 else absmax / 127.0
        sx = torch.clamp(q.float(), min=1e-8)
    else:
        sx = _as_scale(static_scale, x.device).reshape(1, 1)
    xq = torch.clamp(torch.round(x / sx.to(x.dtype)), -127, 127).to(torch.int8)
    return xq, sx


def chain_dequant_ref(acc: torch.Tensor, sx: torch.Tensor, wscale: torch.Tensor,
                      bias: Optional[torch.Tensor], ep: torch.dtype, out_dtype) -> torch.Tensor:
    """The chain's epilogue on the exact int32 sums ``acc`` (as f32, from
    int_dot): acc.astype(ep) * (sx * sw).astype(ep) + b.astype(ep), then the
    output dtype. In f32 the multiply and add contract into one FMA (XLA's
    CPU code; the kernel's __fmaf_rn); in bf16 each op rounds."""
    sw = sx * wscale.float()
    b = torch.zeros_like(wscale, dtype=torch.float32) if bias is None else bias.float()
    if ep == torch.float32:
        return fma_f32(acc, sw, b).to(out_dtype)
    return (acc.to(ep) * sw.to(ep) + b.to(ep)).to(out_dtype)


def fused_int8_chain_ref(x: torch.Tensor, wq: torch.Tensor, wscale: torch.Tensor,
                         bias: Optional[torch.Tensor] = None,
                         ln_scale: Optional[torch.Tensor] = None,
                         ln_bias: Optional[torch.Tensor] = None, *, prologue: str = "id",
                         out_dtype=None, static_scale=None) -> torch.Tensor:
    """Plain version of K5's chain form (JAX's _xla_chain), the dequant in
    int8_ep_dtype()."""
    K, N = wq.shape
    xp = chain_prologue_ref(x.reshape(-1, K), prologue, ln_scale, ln_bias)
    xq, sx = chain_quantize_ref(xp, static_scale)
    y = chain_dequant_ref(int_dot(xq, wq), sx, wscale, bias, int8_ep_dtype(),
                          out_dtype or x.dtype)
    return y.reshape(*x.shape[:-1], N)


# --------------------------------------------------------------------- K5
def fused_int8_matmul_ref(x: torch.Tensor, wq: torch.Tensor, wscale: torch.Tensor,
                          bias: Optional[torch.Tensor] = None,
                          ln_scale: Optional[torch.Tensor] = None,
                          ln_bias: Optional[torch.Tensor] = None, *, prologue: str = "id",
                          out_dtype=None, static_scale=None, force=None) -> torch.Tensor:
    """Plain version of K5: the chain form (fused_int8_chain_ref) where
    uses_chain says so, else the TPU kernel's _kernel in its f32 op order."""
    K, N = wq.shape
    if uses_chain(x.numel() // K, force):
        return fused_int8_chain_ref(x, wq, wscale, bias, ln_scale, ln_bias, prologue=prologue,
                                    out_dtype=out_dtype, static_scale=static_scale)
    x2 = prologue_f32(x.reshape(-1, K).float(), prologue, ln_scale, ln_bias)
    if static_scale is None:
        absmax = torch.amax(torch.abs(x2), dim=-1, keepdim=True)
        scale = torch.clamp(absmax * RECIP_127, min=1e-8)
        scales = {"row_scale": scale}
    else:
        scale = _as_scale(static_scale, x.device)
        scales = {"s": scale}
    y = int8_gemm_ref(quantize_rows_ref(x2, scale), wq, EPI_DEQ_ROW, wscale, bias,
                      out_dtype=out_dtype or x.dtype, **scales)
    return y.reshape(*x.shape[:-1], N)


def fused_int8_matmul(x: torch.Tensor, wq: torch.Tensor, wscale: torch.Tensor,
                      bias: Optional[torch.Tensor] = None,
                      ln_scale: Optional[torch.Tensor] = None,
                      ln_bias: Optional[torch.Tensor] = None, *, prologue: str = "id",
                      out_dtype=None, static_scale=None, force=None) -> torch.Tensor:
    """[LN | GELU | id](x) @ dequant-int8 wq + bias, quantizing x per row
    (or by ``static_scale``), with the JAX signature: x (..., K) bf16/f32,
    wq (K, N) int8 in the (in, out) layout, wscale (N,), bias (N,) or None,
    ln_scale/ln_bias (K,) for the "ln" prologue. Returns (..., N) in
    out_dtype (default x.dtype). ``force``: None picks the form by the flat
    row count (uses_chain), "pallas" the kernel form, "xla" the chain form.

    CPU tensors take the plain version. CUDA tensors launch
    ``csrc/int8_gemm.cu`` (the quantize and the GEMM, each in the chosen
    form): K and N multiples of 16; anything else raises.
    """
    cuda_build.refuse_grad("fused_int8_matmul", x, wq, wscale, bias, ln_scale, ln_bias,
                           static_scale)
    if x.device.type == "cpu":
        return fused_int8_matmul_ref(x, wq, wscale, bias, ln_scale, ln_bias, prologue=prologue,
                                     out_dtype=out_dtype, static_scale=static_scale, force=force)
    K, N = wq.shape
    out_dtype = out_dtype or x.dtype
    if prologue not in PROLOGUES:
        raise ValueError(f"fused_int8_matmul: unknown prologue {prologue!r}")
    if out_dtype not in _TOKEN_DTYPES:
        raise ValueError(f"fused_int8_matmul: out_dtype {out_dtype} (bf16 or f32)")
    x2 = x.reshape(-1, K)
    chain = uses_chain(x2.shape[0], force)
    epi = EPI_DEQ_ROW
    if chain:
        epi = EPI_CHAIN_BF16 if int8_ep_dtype() == torch.bfloat16 else EPI_CHAIN_F32
    xq, row_scale, s = quantize_rows(x2, prologue, ln_scale, ln_bias, static_scale,
                                     "fused_int8_matmul", chain=chain)
    out = torch.empty((x2.shape[0], N), dtype=out_dtype, device=x.device)
    int8_gemm(xq, wq, epi, out, wscale, bias, row_scale=row_scale, s=s,
              what="fused_int8_matmul")
    fused_int8_matmul.launches += 1
    if chain:
        key = "chain bf16" if epi == EPI_CHAIN_BF16 else "chain"
        variants = fused_int8_matmul.variant_launches
        variants[key] = variants.get(key, 0) + 1
    return out.reshape(*x.shape[:-1], N)


fused_int8_matmul.launches = 0
# the calls in the chain form, "chain" (f32 dequant) and "chain bf16" (counted
# in ``launches`` too)
fused_int8_matmul.variant_launches = {}


# --------------------------------------------------------------------- K4
def fused_int8_mlp_block_ref(tok: torch.Tensor, w1q, w1scale, b1, w2q, w2scale, b2,
                             ln_scale, ln_bias, sx1, sx2, gelu: str = "gelu") -> torch.Tensor:
    """Plain version of K4 (_mlp1_kernel then _mlp2_kernel)."""
    K = tok.shape[-1]
    x0 = tok.reshape(-1, K).float()
    s1, s2 = _as_scale(sx1, tok.device), _as_scale(sx2, tok.device)
    xq = quantize_rows_ref(layer_norm_f32(x0, ln_scale, ln_bias), s1)
    yq = int8_gemm_ref(xq, w1q, EPI_GELU_Q, w1scale, b1, s=s1, out_scale=s2, gelu=gelu)
    out = int8_gemm_ref(yq, w2q, EPI_RESID, w2scale, b2, s=s2, res=x0, out_dtype=tok.dtype)
    return out.reshape(tok.shape)


def fused_int8_mlp_block(tok: torch.Tensor, w1q, w1scale, b1, w2q, w2scale, b2,
                         ln_scale, ln_bias, sx1, sx2, gelu: str = "gelu") -> torch.Tensor:
    """tok + fc2(GELU(fc1(LN(tok)))) with the static scales sx1 (post-LN)
    and sx2 (post-GELU), the JAX signature: tok (..., K) bf16/f32; w1q
    (K, H), w2q (H, K) int8; scales and biases per output channel; ``gelu``
    "gelu" (A&S erf) or "gelu_poly".

    CPU tensors take the plain version. CUDA tensors launch
    ``csrc/int8_gemm.cu`` three times (quantize, fc1 + GELU + quantize, fc2
    + residual): K and H multiples of 16; anything else raises.
    """
    cuda_build.refuse_grad("fused_int8_mlp_block", tok, w1q, w1scale, b1, w2q, w2scale, b2,
                           ln_scale, ln_bias, sx1, sx2)
    if tok.device.type == "cpu":
        return fused_int8_mlp_block_ref(tok, w1q, w1scale, b1, w2q, w2scale, b2, ln_scale,
                                        ln_bias, sx1, sx2, gelu)
    if gelu not in ("gelu", "gelu_poly"):
        raise ValueError(f"fused_int8_mlp_block: unknown gelu {gelu!r}")
    K, H = w1q.shape
    if w2q.shape != (H, K):
        raise ValueError(f"fused_int8_mlp_block: w1q {tuple(w1q.shape)}, w2q {tuple(w2q.shape)}")
    x2 = cuda_build.aligned16(tok.reshape(-1, K))
    s2 = _device_scale(sx2, tok.device, "fused_int8_mlp_block")
    xq, _, s1 = quantize_rows(x2, "ln", ln_scale, ln_bias, sx1, "fused_int8_mlp_block")
    yq = torch.empty((x2.shape[0], H), dtype=torch.int8, device=tok.device)
    int8_gemm(xq, w1q, EPI_GELU_Q, yq, w1scale, b1, s=s1, out_scale=s2,
              gelu_poly=gelu == "gelu_poly", what="fused_int8_mlp_block")
    out = torch.empty_like(x2)
    int8_gemm(yq, w2q, EPI_RESID, out, w2scale, b2, s=s2, res=x2, what="fused_int8_mlp_block")
    fused_int8_mlp_block.launches += 1
    return out.reshape(tok.shape)


fused_int8_mlp_block.launches = 0


# -------------------------------------------------------------------- K10
def fused_int8_mlp_block1_ref(tok: torch.Tensor, w1q, w1scale, b1, w2q, w2scale, b2,
                              ln_scale, ln_bias, sx1, sx2, gelu: str = "gelu",
                              hc: int = 1280) -> torch.Tensor:
    """Plain version of K10 (_mlp1p_kernel): fc1, GELU, quantize and fc2 chunk
    by chunk over ``hc`` columns of H, the fc2 partial sums added as exact
    integers (an f64 sum here, exact below 2^53), one dequant at the end."""
    K = tok.shape[-1]
    H = w1q.shape[1]
    if H % hc:
        hc = H
    x0 = tok.reshape(-1, K).float()
    s1, s2 = _as_scale(sx1, tok.device), _as_scale(sx2, tok.device)
    xq = quantize_rows_ref(layer_norm_f32(x0, ln_scale, ln_bias), s1)
    acc = torch.zeros((x0.shape[0], K), dtype=torch.float64, device=tok.device)
    for c in range(0, H, hc):
        y = int_dot(xq, w1q[:, c:c + hc]) * (s1 * w1scale[c:c + hc].float())
        if b1 is not None:
            y = y + b1[c:c + hc].float()
        yq = quantize_rows_ref(prologue_f32(y, gelu), s2)
        acc = acc + yq.double() @ w2q[c:c + hc].double()
    z = acc.float() * (s2 * w2scale.float())
    if b2 is not None:
        z = z + b2.float()
    return (x0 + z).to(tok.dtype).reshape(tok.shape)


def fused_int8_mlp_block1(tok: torch.Tensor, w1q, w1scale, b1, w2q, w2scale, b2,
                          ln_scale, ln_bias, sx1, sx2, gelu: str = "gelu",
                          hc: int = 1280) -> torch.Tensor:
    """K4's function in one launch, the JAX signature (without the TPU's row
    tile ``tm``): the (M, H) int8 GELU activations never reach device memory.
    The result equals ``fused_int8_mlp_block``'s bit for bit, whatever the
    chunking: the chunks' fc2 sums add in int32.

    CPU tensors take the plain version, in chunks of ``hc`` columns (H where
    hc does not divide it). CUDA tensors launch ``mlp_block1_kernel`` of
    ``csrc/int8_gemm.cu`` on a cluster of ``mlp1_cluster(K)`` CTAs, which
    chunks H by 64 columns a CTA whatever ``hc`` says, reading the weights
    through their K-major copies (``kmajor_weight``): K and H multiples of
    16, K at most 1280; anything else raises.
    """
    cuda_build.refuse_grad("fused_int8_mlp_block1", tok, w1q, w1scale, b1, w2q, w2scale, b2,
                           ln_scale, ln_bias, sx1, sx2)
    if tok.device.type == "cpu":
        return fused_int8_mlp_block1_ref(tok, w1q, w1scale, b1, w2q, w2scale, b2, ln_scale,
                                         ln_bias, sx1, sx2, gelu, hc)
    what = "fused_int8_mlp_block1"
    dev = tok.device
    if dev.type != "cuda":
        raise ValueError(f"{what}: unsupported device {dev}")
    if gelu not in ("gelu", "gelu_poly"):
        raise ValueError(f"{what}: unknown gelu {gelu!r}")
    if tok.dtype not in _TOKEN_DTYPES:
        raise ValueError(f"{what}: the kernel takes bf16 or f32 tokens, got {tok.dtype}")
    K, H = w1q.shape
    if (tok.shape[-1] != K or w2q.shape != (H, K) or K % 16 or H % 16 or K > MLP1_MAX_K
            or any(w.dtype != torch.int8 or w.device != dev for w in (w1q, w2q))):
        raise ValueError(f"{what}: tok {tuple(tok.shape)}, w1q {w1q.dtype} {tuple(w1q.shape)}, "
                         f"w2q {w2q.dtype} {tuple(w2q.shape)} on {w1q.device}: int8 (K, H) and "
                         f"(H, K) on {dev}, multiples of 16, K <= {MLP1_MAX_K}")
    x2 = cuda_build.aligned16(tok.reshape(-1, K))
    g, b = (_vec(v, K, dev, what, "the LN vectors") for v in (ln_scale, ln_bias))
    ws1, bs1 = _vec(w1scale, H, dev, what, "fc1's scales"), _vec(b1, H, dev, what, "fc1's bias")
    ws2, bs2 = _vec(w2scale, K, dev, what, "fc2's scales"), _vec(b2, K, dev, what, "fc2's bias")
    s1, s2 = _device_scale(sx1, dev, what), _device_scale(sx2, dev, what)
    w1map, w2map = _kmajor(w1q)[1], _kmajor(w2q)[1]
    out = torch.empty_like(x2)
    lib = cuda_build.load("int8_gemm.cu")
    idx = x2.get_device()
    with torch.cuda.device(idx):  # an index: less host work than a device
        stream = torch.cuda.current_stream(idx).cuda_stream
        cuda_build.check(lib.hyt_mlp_block1(
            x2.data_ptr(), int(x2.dtype == torch.float32), g.data_ptr(), b.data_ptr(),
            ctypes.addressof(w1map), ws1.data_ptr(), bs1.data_ptr(), ctypes.addressof(w2map),
            ws2.data_ptr(), bs2.data_ptr(), s1.data_ptr(), s2.data_ptr(),
            int(gelu == "gelu_poly"), x2.shape[0], K, H, mlp1_cluster(K), out.data_ptr(),
            stream), f"{what}: mlp_block1_kernel")
    fused_int8_mlp_block1.launches += 1
    return out.reshape(tok.shape)


fused_int8_mlp_block1.launches = 0


def int8_dot_prequant(xq: torch.Tensor, wq: torch.Tensor, wscale: torch.Tensor,
                      bias: Optional[torch.Tensor], sx, out_dtype=torch.bfloat16) -> torch.Tensor:
    """(..., K) int8 already quantized by the static scale ``sx`` @ (K, N)
    int8 -> (..., N): the plain exact int8 product and its dequant,
    ((acc * sx) * wscale + bias) in f32. Not a kernel: JAX computes it with
    dot_general outside Pallas."""
    K = xq.shape[-1]
    y = int8_gemm_ref(xq.reshape(-1, K), wq, EPI_DEQ_ROW, wscale, bias, s=sx,
                      out_dtype=out_dtype)
    return y.reshape(*xq.shape[:-1], wq.shape[1])


# --------------------------------------- kernels against their plain versions
# How far an int8 kernel may sit from its plain version on the card. Both
# round at the same points in the same f32 op order, so they differ only
# where a sum taken in another order (an LN mean or variance, a softmax
# sum, the attention products) moves a value that sits within an ulp of an
# int8 rounding midpoint to the neighbouring int8 value. Such a flip moves
# every output of its row (a GEMM input) or one element (an int8 output) by
# one int8 step. Elsewhere the outputs agree to one rounding of the output
# dtype (K5 with the GELU and id prologues read bit-identical). Limits:
# float outputs, the share of rows with any element beyond one rounding of
# max(|plain|, mean |plain|) (bf16: 2^-8; f32: 2^-19, a few ulps for the
# per-row scales' own sums) and the largest error over the output's mean
# magnitude (one int8 step of a K-long product is about 0.06 / sqrt(K) of
# it, and bf16 outputs of a residual sum round at up to 1/128 of their own
# magnitude, a few times the mean; a wrong tile or row is off by the order
# of 1); int8 outputs, +-1 at most, on a capped share of elements. Readings
# of chip_smoke.py on an H100 at ViT-H shapes: K5 and K4 at most 0.52% of
# rows, errors at most 0.023 of the mean (K3: 0.051); K7's int8 output 2e-6
# of elements. tests/test_torch_int8_kernels.py::TestLimits holds the limits
# to both sides: a plain version with its LN sums in f64 passes (1.0% of
# rows), one with the LN's eps left out fails (6.3%). K3 sets its own row
# limit (ops/attn_proj_block.py).
MAX_FRAC_ROWS_FLIPPED = 0.02
MAX_ERR_OVER_MEAN = 0.1
MAX_FRAC_INT8_FLIPPED = 0.01


def check_against_plain(got: torch.Tensor, ref: torch.Tensor, what: str,
                        max_frac_rows: float = MAX_FRAC_ROWS_FLIPPED,
                        max_err_over_mean: float = MAX_ERR_OVER_MEAN) -> dict:
    """Raise unless an int8 kernel's output ``got`` agrees with its plain
    version's ``ref`` to the limits above; returns the readings."""
    if ref.dtype == torch.int8:
        d = (got.to(torch.int32) - ref.to(torch.int32)).abs()
        r = {"max_abs_err": float(d.max()), "frac_flipped": float((d > 0).float().mean())}
        if r["max_abs_err"] > 1 or r["frac_flipped"] > MAX_FRAC_INT8_FLIPPED:
            raise AssertionError(f"{what} disagrees with its plain version: {r} (limits: "
                                 f"+-1 on at most {MAX_FRAC_INT8_FLIPPED} of elements)")
        return r
    err = (got.float() - ref.float()).abs()
    mag = ref.float().abs()
    mean = float(mag.mean()) + 1e-30
    ulp = 2.0 ** -8 if ref.dtype == torch.bfloat16 else 2.0 ** -19
    beyond = err > ulp * torch.maximum(mag, torch.full_like(mag, mean))
    r = {"max_abs_err": float(err.max()), "err_over_mean": float(err.max()) / mean,
         "frac_rows_flipped": float(beyond.reshape(-1, ref.shape[-1]).any(-1).float().mean())}
    if r["frac_rows_flipped"] > max_frac_rows or r["err_over_mean"] > max_err_over_mean:
        raise AssertionError(f"{what} disagrees with its plain version: {r} (limits: at most "
                             f"{max_frac_rows} of rows beyond one rounding, max error "
                             f"{max_err_over_mean} of the mean magnitude)")
    return r


# ------------------------------------------------ launches of int8_gemm.cu
def _device_scale(s, device, what: str) -> torch.Tensor:
    """A static scale as a (1,) f32 tensor on ``device`` (the kernels read
    it there, so no value crosses to the host)."""
    t = (s if isinstance(s, torch.Tensor) else torch.tensor(float(s), device=device)).float()
    if t.numel() != 1:
        raise ValueError(f"{what}: a static scale has one element, got {tuple(t.shape)}")
    if t.device != device:
        raise ValueError(f"{what}: the static scale is on {t.device}, the tokens on {device}")
    return t.reshape(1).contiguous()


def _vec(v: Optional[torch.Tensor], n: int, device, what: str, name: str) -> torch.Tensor:
    if v is None:
        return torch.zeros(n, dtype=torch.float32, device=device)
    if v.shape != (n,) or v.device != device:
        raise ValueError(f"{what}: {name} must be ({n},) on {device}, got "
                         f"{tuple(v.shape)} on {v.device}")
    return v.to(torch.float32).contiguous()


def quantize_rows(x2: torch.Tensor, prologue: str, g, b, static_scale, what: str,
                  chain: bool = False):
    """Launch the prologue + quantize of csrc/int8_gemm.cu on x2 (M, K) bf16
    or f32, in K5's chain form where ``chain``: -> (int8 (M, K), per-row
    scales (M,) or None, static scale (1,) or None)."""
    M, K = x2.shape
    dev = x2.device
    if dev.type != "cuda":
        raise ValueError(f"{what}: unsupported device {dev}")
    if x2.dtype not in _TOKEN_DTYPES:
        raise ValueError(f"{what}: the kernel takes bf16 or f32 rows, got {x2.dtype}")
    if K % 16:
        raise ValueError(f"{what}: K = {K} is not a multiple of 16")
    x2 = x2.contiguous()
    pid = PROLOGUES.index(prologue)
    gb = (None, None)
    if prologue == "ln":
        gb = tuple(_vec(v, K, dev, what, "the LN vectors") for v in (g, b))
    xq = torch.empty((M, K), dtype=torch.int8, device=dev)
    if static_scale is None:
        row_scale, s = torch.empty(M, dtype=torch.float32, device=dev), None
    else:
        row_scale, s = None, _device_scale(static_scale, dev, what)
    lib = cuda_build.load("int8_gemm.cu")
    idx = x2.get_device()
    with torch.cuda.device(idx):  # an index: less host work than a device
        stream = torch.cuda.current_stream(idx).cuda_stream
        cuda_build.check(lib.hyt_quantize_rows(
            x2.data_ptr(), int(x2.dtype == torch.float32), _ptr(gb[0]), _ptr(gb[1]), pid, M, K,
            int(static_scale is None), _ptr(s), int(chain), xq.data_ptr(), _ptr(row_scale),
            stream),
            f"{what}: quantize_rows_kernel")
    return xq, row_scale, s


def int8_gemm(a: torch.Tensor, w: torch.Tensor, epi: int, out: torch.Tensor,
              wscale: torch.Tensor, bias: Optional[torch.Tensor], *, row_scale=None, s=None,
              res=None, out_scale=None, gelu_poly: bool = False,
              what: str = "int8_gemm") -> None:
    """Launch the int8 GEMM of csrc/int8_gemm.cu: out (M, N) = epilogue(a
    (M, K) int8 @ w (K, N) int8), reading w through its K-major copy
    (``kmajor_weight``)."""
    M, K = a.shape
    dev = a.device
    if w.dtype != torch.int8 or w.dim() != 2 or w.shape[0] != K or w.device != dev:
        raise ValueError(f"{what}: the weight must be int8 ({K}, N) on {dev}, got "
                         f"{w.dtype} {tuple(w.shape)} on {w.device}")
    N = w.shape[1]
    if K % 16 or N % 16:
        raise ValueError(f"{what}: K = {K} and N = {N} must be multiples of 16")
    if out.shape != (M, N) or not out.is_contiguous() or out.data_ptr() % 16:
        raise ValueError(f"{what}: the output must be a contiguous ({M}, {N}) tensor, 16-byte "
                         f"aligned, got {tuple(out.shape)} at {out.data_ptr() % 16} mod 16")
    if res is not None:
        if res.shape != (M, N) or res.dtype != out.dtype:
            raise ValueError(f"{what}: the residual must be ({M}, {N}) {out.dtype}")
        res = cuda_build.aligned16(res)
    a = cuda_build.aligned16(a)
    wmap = _kmajor(w)[1]
    wscale = cuda_build.aligned16(_vec(wscale, N, dev, what, "the weight scales"))
    bias = cuda_build.aligned16(_vec(bias, N, dev, what, "the bias"))
    lib = cuda_build.load("int8_gemm.cu")
    idx = a.get_device()
    with torch.cuda.device(idx):  # an index: less host work than a device
        stream = torch.cuda.current_stream(idx).cuda_stream
        cuda_build.check(lib.hyt_int8_gemm(
            a.data_ptr(), ctypes.addressof(wmap), M, N, K, epi, _OUT_KIND[out.dtype],
            _ptr(row_scale), _ptr(s), wscale.data_ptr(), bias.data_ptr(), _ptr(res),
            _ptr(out_scale), int(gelu_poly), out.data_ptr(), stream),
            f"{what}: int8_gemm_kernel")


# ------------------------------------------------------ K-major weight copies
# 8-bit wgmma reads both operands K-major from shared memory, so the card's
# GEMM takes the weight as (N, K) contiguous, while every public function
# keeps JAX's (K, N). Each weight gets one copy, with its TMA map, kept as
# long as the weight lives (core/nn.derived: keyed by the weight's identity
# and version). ViT-H's int8 weights are 630 MB, so their copies hold as much
# again on the card.
def kmajor_weight(w: torch.Tensor) -> torch.Tensor:
    """The K-major (N, K) contiguous, 16-byte aligned copy of the (K, N)
    int8 weight ``w``, made once per weight (a later in-place change to
    ``w`` makes it anew); ``kmajor_weight.transposes`` counts the copies
    made."""
    return _kmajor(w)[0]


kmajor_weight.transposes = 0


def _kmajor(w: torch.Tensor):
    """(kmajor_weight(w), its TMA map: 128 bytes of host memory, or None
    for a CPU weight)."""
    if w.dtype != torch.int8 or w.dim() != 2:
        raise ValueError(f"kmajor_weight: an int8 (K, N) weight, got {w.dtype} {tuple(w.shape)}")

    def make():
        wt = cuda_build.aligned16(w.t().contiguous())
        wmap = None
        if wt.is_cuda:
            wmap = ctypes.create_string_buffer(128)
            idx = wt.get_device()
            with torch.cuda.device(idx):
                cuda_build.check(cuda_build.load("int8_gemm.cu").hyt_weight_map(
                    wt.data_ptr(), wt.shape[0], wt.shape[1], ctypes.addressof(wmap)),
                    "kmajor_weight: the weight's TMA map")
        kmajor_weight.transposes += 1
        return wt, wmap

    return nn.derived(w, "kmajor", make)


def _ptr(t: Optional[torch.Tensor]):
    return None if t is None else t.data_ptr()
