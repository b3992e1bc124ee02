"""Kernels K7 and K8: single-block softmax attention over short sequences,
with an optional int8 epilogue (port of fused_short_attention,
fused_qkv_attention and softmax_attention_qkv in
hamer_yolo_tpu/ops/attention_pallas.py).

The CUDA counterpart is ``csrc/short_attention.cu``: one launch.
``launch_attention`` is also the attention launch of K2 (ops/attn_block.py),
K3 (ops/attn_proj_block.py) and K6 (ops/attn_block_int8.py).

bf16 inputs run a kernel built for Hopper's warpgroup instructions, which
replaced one that staged f32 logits and bf16 probabilities in shared memory
(142 KB for each 64-row query tile, loads through registers with no
overlap). The work is bound by bytes (31.5 MB for 3.0 GFLOP at ViT-H's
shape), so the design keeps everything but q, k, v and the output on chip
and overlaps the loads with math: a CTA of three warpgroups per (192 query
rows, head, crop) lands its Q tiles and the head's K and V in shared memory
once, by asynchronous 16-byte copies on two mbarriers (Q + K, then V);
S = Q K^T and O = P V run on ``wgmma``; the logits and probabilities stay
in registers (the softmax reduces each row over a quad by shuffles, and p is
packed straight into the A fragments of P V); the epilogue writes 8
adjacent outputs a thread. That kernel takes up to 256 keys; beyond, a
key-block form streams K and V through shared memory 64 keys at a time in
two passes (the row max and sum, then p normalised and rounded to bf16
before P V, as the TPU kernel rounds), so any N runs. Heads are at most
``MAX_HD`` wide; the wrapper raises beyond. f32 inputs run both products in
f32 on the CUDA cores (as the JAX kernels compute them for f32), one CTA per
(64-row query tile, head, crop), keys in the same blocks and two passes.

K7 against K8 on the card. On the TPU, K8 exists to spare K7's four
transposes of (B, h, N, hd) tensors through device memory. The port's K7
never made them: its kernel reads q, k and v through strides, so
``softmax_attention_qkv(force="pallas_direct")`` hands it views of the fused
qkv tensor. What still differs: K7 (``hyt_short_attention``) takes three
pointers and one stride set computed by the wrapper from whatever views it
is given, and returns a (B, h, N, hd) view that the caller transposes back
and reshapes (no copy); K8 (``hyt_fused_qkv_attention``) takes the one
contiguous (B, N, 3D) pointer and the head count, derives the head offsets
(s * D + t * hd) in its entry and writes a contiguous (B, N, D) tensor. The
device code and the addresses it touches are the same, so their outputs are
equal bit for bit and their times on the card should agree to the launch's
host cost.
"""
from __future__ import annotations

import ctypes
import functools
import os

import numpy as np
import torch

from hamer_yolo_tpu_torch.core import nn
from hamer_yolo_tpu_torch.ops import cuda_build
from hamer_yolo_tpu_torch.ops.int8_matmul import RECIP_127

_OUT_KIND = {torch.bfloat16: 0, torch.float32: 1, torch.int8: 2}  # of hyt_short_attention
_IN_DTYPES = (torch.bfloat16, torch.float32)
MAX_HD = 128  # head width the bf16 kernels take: eight 16-wide wgmma accumulators


def fused_short_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                              out_scale=None) -> torch.Tensor:
    """Plain version of K7 (_attn_kernel): q/k/v (B, h, N, hd) ->
    (B, h, N, hd) in q.dtype, or int8 with ``out_scale``."""
    hd = q.shape[-1]
    qs = q * nn.weak_scalar(hd ** -0.5, q.dtype)  # JAX's weak-typed q * scale
    logits = torch.einsum("bhnd,bhmd->bhnm", qs.float(), k.float())
    e = torch.exp(logits - torch.amax(logits, dim=-1, keepdim=True))
    p = e * (1.0 / torch.sum(e, dim=-1, keepdim=True))
    res = torch.einsum("bhnm,bhmd->bhnd", p.to(v.dtype).float(), v.float())
    if out_scale is None:
        return res.to(q.dtype)
    inv = 1.0 / torch.as_tensor(out_scale, dtype=torch.float32, device=q.device).reshape(())
    return torch.clamp(torch.round(res * inv), -127, 127).to(torch.int8)


# K3's opt-in softmax flavours and attention products (JAX's HYT_SOFTMAX and
# HYT_ATTN_MATH, read by core/quant.py; hamer_yolo_tpu/ops/attention_pallas.py
# softmax_flavor, attn_math_flavor and _attn_proj_block_kernel).
SOFTMAXES = ("exp", "exp2", "exp2p")
ATTN_MATHS = ("bf16", "int8")
LOG2E = 1.4426950408889634


def softmax_flavor() -> str:
    """HYT_SOFTMAX, read at each call: "exp2" or "exp2p" where it says so,
    else "exp"."""
    v = os.environ.get("HYT_SOFTMAX")
    return v if v in ("exp2", "exp2p") else "exp"


def attn_math_flavor() -> str:
    """HYT_ATTN_MATH, read at each call: "int8" where it says so, else "bf16"."""
    return "int8" if os.environ.get("HYT_ATTN_MATH") == "int8" else "bf16"


def check_flavour(softmax: str, attn_math: str, what: str) -> None:
    if softmax not in SOFTMAXES or attn_math not in ATTN_MATHS:
        raise ValueError(f"{what}: softmax {softmax!r} (one of {SOFTMAXES}), attn_math "
                         f"{attn_math!r} (one of {ATTN_MATHS})")


def _head_scale(t: torch.Tensor) -> torch.Tensor:
    """A head's dynamic int8 scale, max |t| * f32(1 / 127) + 1e-12 over its
    (N, hd) tile, in f32: (B, h, 1, 1)."""
    return torch.amax(torch.abs(t), dim=(-2, -1), keepdim=True) * RECIP_127 + 1e-12


def _int_products(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Exact integer a @ b over the last two axes (f64, exact below 2^53),
    rounded to f32 as the int32 -> f32 conversion rounds."""
    return torch.matmul(a.double(), b.double()).float()


# The int8 products' tiles (csrc/attention_flavours.cu): N pads to a multiple
# of the key block, Qi and Ki rows to the k32 depth of 8-bit wgmma, Vt's rows
# (the P V product's n) to 16.
I8_KEY_BLOCK = 64


def int8_tile_dims(N: int, hd: int):
    """(Nk, Hk, Hv): the padded keys, the Qi / Ki row bytes, the Vt rows."""
    return -(-N // I8_KEY_BLOCK) * I8_KEY_BLOCK, -(-hd // 32) * 32, -(-hd // 16) * 16


def quantize_heads_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor):
    """Plain version of the int8 products' pre-pass (quantize_heads_kernel):
    q/k/v (B, h, N, hd) -> (scales (B, h, 3) f32: sq, sk, sv; qi, ki (B, h,
    Nk, Hk) int8; vt (B, h, Hv, Nk) int8, v transposed, keys contiguous),
    each head quantized by its dynamic scale (_head_scale) as rint(t * (1 /
    s)) with no clip, zero padded to int8_tile_dims."""
    N, hd = q.shape[-2:]
    Nk, Hk, Hv = int8_tile_dims(N, hd)
    ts = [t.float() for t in (q, k, v)]
    scales = [_head_scale(t) for t in ts]
    qi, ki, vi = (torch.round(t * (1.0 / s)).to(torch.int8) for t, s in zip(ts, scales))
    pad = torch.nn.functional.pad
    return (torch.cat(scales, dim=-1).squeeze(-2), pad(qi, (0, Hk - hd, 0, Nk - N)),
            pad(ki, (0, Hk - hd, 0, Nk - N)), pad(vi.transpose(-1, -2), (0, Nk - N, 0, Hv - hd)))


def int8_products_attention_ref(scales: torch.Tensor, qi: torch.Tensor, ki: torch.Tensor,
                                vt: torch.Tensor, N: int, hd: int, out_scale,
                                softmax: str = "exp") -> torch.Tensor:
    """Plain version of the int8 products' attention launch
    (attention_int8_kernel) on quantize_heads_ref's tiles: logits = (qi .
    ki^T) * (qs * (sq * sk)) over the N keys (pad keys left out), the softmax
    (exp, or exp2 under "exp2" / "exp2p"), pi = round((e * inv_s) * 127), res
    = (pi . vi) * ((sv * f32(1 / 127)) * inv_p), clip(round(res), +-127):
    (B, h, N, hd) int8."""
    exp2 = softmax in ("exp2", "exp2p")
    qs = float(np.float32(hd ** -0.5 * LOG2E if exp2 else hd ** -0.5))
    inv_p = 1.0 / torch.as_tensor(out_scale, dtype=torch.float32, device=qi.device).reshape(())
    sq, sk, sv = (scales[..., i, None, None] for i in range(3))
    logits = _int_products(qi[..., :N, :], ki[..., :N, :].transpose(-1, -2)) * (qs * (sq * sk))
    e = (torch.exp2 if exp2 else torch.exp)(logits - torch.amax(logits, dim=-1, keepdim=True))
    pi = torch.round(e * (1.0 / torch.sum(e, dim=-1, keepdim=True)) * 127.0)
    res = _int_products(pi, vt[..., :hd, :N].transpose(-1, -2)) * ((sv * RECIP_127) * inv_p)
    return torch.clamp(torch.round(res), -127, 127).to(torch.int8)


def flavoured_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, out_scale,
                            softmax: str = "exp", attn_math: str = "bf16") -> torch.Tensor:
    """Plain version of K3's attention step under a softmax flavour and an
    attention-products dtype (the loop body of _attn_proj_block_kernel): q/k/v
    (B, h, N, hd) bf16 -> int8 (B, h, N, hd), quantized by ``out_scale``.

    "exp2" folds log2(e) into the q prescale and takes exp2 of the
    max-shifted logits; "exp2p" besides leaves e unnormalised into the p.v
    product, res = (e.bf16 @ v) * (inv_s * inv_p). "int8" products:
    quantize_heads_ref, then int8_products_attention_ref (the two launches of
    the kernel); under int8 products "exp2p" is "exp2", as in JAX."""
    check_flavour(softmax, attn_math, "flavoured_attention_ref")
    N, hd = q.shape[-2:]
    if attn_math == "int8":
        return int8_products_attention_ref(*quantize_heads_ref(q, k, v), N, hd, out_scale,
                                           softmax)
    exp2 = softmax in ("exp2", "exp2p")
    qs = hd ** -0.5 * LOG2E if exp2 else hd ** -0.5
    inv_p = 1.0 / torch.as_tensor(out_scale, dtype=torch.float32, device=q.device).reshape(())
    expf = torch.exp2 if exp2 else torch.exp
    logits = torch.einsum("bhnd,bhmd->bhnm", (q * nn.weak_scalar(qs, q.dtype)).float(),
                          k.float())
    e = expf(logits - torch.amax(logits, dim=-1, keepdim=True))
    inv_s = 1.0 / torch.sum(e, dim=-1, keepdim=True)
    if softmax == "exp2p":
        res = torch.einsum("bhnm,bhmd->bhnd", e.to(v.dtype).float(), v.float())
        res = res * (inv_s * inv_p)
    else:
        p = e * inv_s
        res = torch.einsum("bhnm,bhmd->bhnd", p.to(v.dtype).float(), v.float()) * inv_p
    return torch.clamp(torch.round(res), -127, 127).to(torch.int8)


def fused_short_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          out_scale=None) -> torch.Tensor:
    """softmax(q k^T / sqrt(hd)) v per (crop, head), no mask, with the JAX
    signature: q/k/v (B, h, N, hd) -> (B, h, N, hd) in q.dtype, or int8
    quantized by the static scale ``out_scale`` (that of the consuming int8
    GEMM).

    CPU tensors take the plain version. CUDA tensors launch
    ``csrc/short_attention.cu``: q, k, v of one float dtype (bf16 or f32),
    one shape and one stride set with hd contiguous (views into a fused qkv
    tensor are fine), hd a multiple of 8, bf16 heads up to MAX_HD wide; anything
    else raises. The output
    is a (B, h, N, hd) view of a (B, N, h, hd) tensor, the layout the proj
    GEMM reads.
    """
    cuda_build.refuse_grad("fused_short_attention", q, k, v, out_scale)
    if q.device.type == "cpu":
        return fused_short_attention_ref(q, k, v, out_scale)
    B, H, N, hd = q.shape
    out = torch.empty((B, N, H, hd), dtype=q.dtype if out_scale is None else torch.int8,
                      device=q.device).transpose(1, 2)
    launch_attention(q, k, v, out, out_scale, "fused_short_attention")
    fused_short_attention.launches += 1
    return out


fused_short_attention.launches = 0


def launch_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, out: torch.Tensor,
                     out_scale, what: str, softmax: str = "exp",
                     attn_math: str = "bf16") -> None:
    """Launch csrc/short_attention.cu on (B, h, N, hd) views q, k, v (bf16
    or f32) into ``out`` (strides multiples of 8, hd contiguous, 16-byte
    aligned): bf16 (bf16 inputs only) or f32, or int8 quantized by
    ``out_scale``. Another ``softmax`` or ``attn_math`` (K3's) launches
    csrc/attention_flavours.cu instead: bf16 inputs and an int8 output only."""
    if not q.is_cuda:
        raise ValueError(f"{what}: unsupported device {q.device}")
    shape = q.shape
    if len(shape) != 4 or not (shape == k.shape == v.shape == out.shape):
        raise ValueError(f"{what}: q, k, v, out of one (B, h, N, hd) shape, got "
                         f"{[tuple(t.shape) for t in (q, k, v, out)]}")
    _check_in_out(q.dtype, (k.dtype, v.dtype), out.dtype, out_scale, what)
    idx = q.get_device()
    if k.get_device() != idx or v.get_device() != idx or out.get_device() != idx:
        raise ValueError(f"{what}: every tensor must be on {q.device}")
    B, H, N, hd = shape
    st, ost = q.stride(), out.stride()
    if k.stride() != st or v.stride() != st or st[3] != 1 or ost[3] != 1:
        raise ValueError(f"{what}: q, k, v need one stride set with hd contiguous, got "
                         f"{[t.stride() for t in (q, k, v, out)]}")
    ptrs = (q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr())
    if hd % 8 or any(x % 8 for x in st[:3] + ost[:3]) or any(x % 16 for x in ptrs):
        raise ValueError(f"{what}: hd = {hd} and the strides {st[:3]}, {ost[:3]} must be "
                         "multiples of 8, the tensors 16-byte aligned")
    if softmax != "exp" or attn_math != "bf16":
        _launch_flavour(q, k, v, out, out_scale, what, softmax, attn_math)
        return
    lib = _library(N, hd, q.dtype, what)
    s = _scale_on(out_scale, q.device)
    with torch.cuda.device(idx):  # an index, not a device: a third of the host cost
        stream = torch.cuda.current_stream(idx).cuda_stream
        cuda_build.check(lib.hyt_short_attention(
            ptrs[0], ptrs[1], ptrs[2], int(q.dtype == torch.float32), st[0], st[1], st[2],
            ptrs[3], _OUT_KIND[out.dtype], None if s is None else s.data_ptr(), ost[0], ost[1],
            ost[2], B, H, N, hd, _scale(hd, q.dtype), stream), f"{what}: short_attention_kernel")


def _launch_flavour(q, k, v, out, out_scale, what, softmax, attn_math) -> None:
    """launch_attention's K3 forms, on checked views: exp2 / exp2p on the
    flavoured bf16 kernels, the int8 products on their two launches
    (_launch_int8_products)."""
    check_flavour(softmax, attn_math, what)
    B, H, N, hd = q.shape
    if q.dtype != torch.bfloat16 or out.dtype != torch.int8 or hd > MAX_HD:
        raise ValueError(f"{what}: softmax {softmax!r} / attn_math {attn_math!r} take bf16 "
                         f"q, k, v (hd <= {MAX_HD}) and an int8 output, got {q.dtype} -> "
                         f"{out.dtype}, hd = {hd}")
    if attn_math == "int8":
        _launch_int8_products(q, k, v, out, out_scale, what, softmax)
        return
    lib = cuda_build.load("attention_flavours.cu")
    st, ost = q.stride(), out.stride()
    s = _scale_on(out_scale, q.device)
    idx = q.get_device()
    with torch.cuda.device(idx):
        stream = torch.cuda.current_stream(idx).cuda_stream
        rc = lib.hyt_attention_flavour(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), st[0], st[1], st[2], out.data_ptr(),
            s.data_ptr(), ost[0], ost[1], ost[2], B, H, N, hd,
            _flavour_scale(hd, softmax, attn_math), SOFTMAXES.index(softmax), stream)
    cuda_build.check(rc, f"{what}: attention ({softmax}, {attn_math})")


def _int8_scratch(B: int, H: int, N: int, hd: int, dev):
    """The pre-pass's outputs: the tiles (Qi of every head, then Ki, then
    Vt, in csrc/attention_flavours.cu's blocked order) and the (B, H, 3)
    scales."""
    Nk, Hk, Hv = int8_tile_dims(N, hd)
    return (torch.empty(B * H * Nk * (2 * Hk + Hv), dtype=torch.int8, device=dev),
            torch.empty((B, H, 3), dtype=torch.float32, device=dev))


def _launch_int8_products(q, k, v, out, out_scale, what, softmax) -> None:
    """The int8 products on checked views: the quantize pre-pass, then the
    attention launch, both in csrc/attention_flavours.cu (any N)."""
    B, H, N, hd = q.shape
    lib = cuda_build.load("attention_flavours.cu")
    st, ost = q.stride(), out.stride()
    s = _scale_on(out_scale, q.device)
    tiles, scales = _int8_scratch(B, H, N, hd, q.device)
    idx = q.get_device()
    with torch.cuda.device(idx):
        stream = torch.cuda.current_stream(idx).cuda_stream
        rc = lib.hyt_attention_int8(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), st[0], st[1], st[2], out.data_ptr(),
            s.data_ptr(), ost[0], ost[1], ost[2], B, H, N, hd,
            _flavour_scale(hd, softmax, "int8"), int(softmax != "exp"), tiles.data_ptr(),
            scales.data_ptr(), stream)
    cuda_build.check(rc, f"{what}: attention ({softmax}, int8)")
    int8_products_attention.launches += 1


def int8_products_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, out_scale,
                            softmax: str = "exp") -> torch.Tensor:
    """K3's attention step under the int8 products (HYT_ATTN_MATH=int8):
    q/k/v (B, h, N, hd) bf16 -> (B, h, N, hd) int8 quantized by
    ``out_scale``, any N. CPU tensors take the plain version
    (flavoured_attention_ref); CUDA tensors launch the pre-pass and the
    attention kernel of csrc/attention_flavours.cu (``launches`` counts the
    pair, on this path and on K3's), or raise. The output is a view of a (B,
    N, h, hd) tensor."""
    cuda_build.refuse_grad("int8_products_attention", q, k, v, out_scale)
    if q.device.type == "cpu":
        return flavoured_attention_ref(q, k, v, out_scale, softmax, "int8")
    B, H, N, hd = q.shape
    out = torch.empty((B, N, H, hd), dtype=torch.int8, device=q.device).transpose(1, 2)
    launch_attention(q, k, v, out, out_scale, "int8_products_attention", softmax, "int8")
    return out


int8_products_attention.launches = 0


def quantize_heads(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor):
    """The int8 products' pre-pass alone, quantize_heads_ref's outputs: CPU
    tensors take the plain version; CUDA tensors (bf16, the checks of
    launch_attention) launch quantize_heads_kernel and return its tiles
    unblocked (blocked_to_plain). For the checks: no launch is counted."""
    cuda_build.refuse_grad("quantize_heads", q, k, v)
    if q.device.type == "cpu":
        return quantize_heads_ref(q, k, v)
    B, H, N, hd = q.shape
    st = q.stride()
    if (q.dtype != torch.bfloat16 or hd > MAX_HD or hd % 8 or any(t.stride() != st or
                                                                  t.dtype != q.dtype
                                                                  for t in (k, v))):
        raise ValueError(f"quantize_heads: bf16 q, k, v of one stride set, hd <= {MAX_HD} a "
                         f"multiple of 8, got {q.dtype}, hd = {hd}")
    tiles, scales = _int8_scratch(B, H, N, hd, q.device)
    lib = cuda_build.load("attention_flavours.cu")
    idx = q.get_device()
    with torch.cuda.device(idx):
        stream = torch.cuda.current_stream(idx).cuda_stream
        rc = lib.hyt_quantize_heads(q.data_ptr(), k.data_ptr(), v.data_ptr(), st[0], st[1],
                                    st[2], B, H, N, hd, tiles.data_ptr(), scales.data_ptr(),
                                    stream)
    cuda_build.check(rc, "quantize_heads")
    return (scales, *blocked_to_plain(tiles, B, H, N, hd))


def blocked_to_plain(tiles: torch.Tensor, B: int, H: int, N: int, hd: int):
    """The pre-pass's tiles in quantize_heads_ref's layout: (qi, ki (B, H,
    Nk, Hk), vt (B, H, Hv, Nk)). Qi and Ki are stored as row groups of 8 rows
    of (Hk / 16) core matrices of 8 rows x 16 bytes, Vt as key blocks of
    I8_KEY_BLOCK keys of (Hv / 8) row groups of such core matrices (the
    shared-memory order of the attention kernel)."""
    Nk, Hk, Hv = int8_tile_dims(N, hd)
    qk = tiles[:2 * B * H * Nk * Hk].view(2, B, H, Nk // 8, Hk // 16, 8, 16)
    qk = qk.permute(0, 1, 2, 3, 5, 4, 6).reshape(2, B, H, Nk, Hk)
    vt = tiles[2 * B * H * Nk * Hk:].view(B, H, Nk // I8_KEY_BLOCK, Hv // 8,
                                          I8_KEY_BLOCK // 16, 8, 16)
    return qk[0], qk[1], vt.permute(0, 1, 3, 5, 2, 4, 6).reshape(B, H, Hv, Nk)


@functools.lru_cache(maxsize=None)
def _flavour_scale(hd: int, softmax: str, attn_math: str) -> float:
    """K3's q prescale under its form: hd^-0.5, times log2(e) under exp2 and
    exp2p; rounded to bf16 with q (JAX's weak typing) for the bf16 products,
    an f32 factor of the int32 logits for the int8 ones."""
    qs = hd ** -0.5 * LOG2E if softmax != "exp" else hd ** -0.5
    return float(np.float32(qs)) if attn_math == "int8" else nn.weak_scalar(qs, torch.bfloat16)


def _check_in_out(in_dtype, other_dtypes, out_dtype, out_scale, what: str) -> None:
    if in_dtype not in _IN_DTYPES or any(d != in_dtype for d in other_dtypes):
        raise ValueError(f"{what}: the kernel takes q, k, v of one float dtype, bf16 or f32, "
                         f"got {[in_dtype, *other_dtypes]}")
    if (out_dtype not in _OUT_KIND or (out_dtype == torch.int8) != (out_scale is not None)
            or (out_dtype == torch.bfloat16 and in_dtype != torch.bfloat16)):
        raise ValueError(f"{what}: the output is bf16 (bf16 inputs) or f32, or int8 with an "
                         f"out_scale; got {out_dtype} with out_scale {out_scale is not None}")


def _library(N: int, hd: int, dtype, what: str):
    """The loaded csrc/short_attention.cu, after the check that it takes
    (N, hd) in ``dtype``: bf16 heads up to MAX_HD wide (any N), f32 as far as
    a 64-row tile and a 64-key block of the head fit in a block's shared
    memory (hd up to about 200)."""
    lib = cuda_build.load("short_attention.cu")
    if dtype == torch.bfloat16:
        if hd > MAX_HD:
            raise ValueError(f"{what}: hd = {hd} is beyond the bf16 kernel's limit of "
                             f"hd <= {MAX_HD}")
        return lib
    smem = lib.hyt_short_attn_smem_bytes(N, hd, dtype.itemsize)
    if smem > cuda_build.MAX_SMEM:
        raise ValueError(f"{what}: N={N}, hd={hd} in {dtype} needs {smem} B of shared memory")
    return lib


def occupancy(N: int, hd: int, out_dtype=torch.bfloat16) -> dict:
    """The bf16 kernel for (N, hd) and ``out_dtype`` on the current card: its
    registers a thread and the CTAs that fit on one SM."""
    lib = _library(N, hd, torch.bfloat16, "occupancy")
    regs, ctas = ctypes.c_int(), ctypes.c_int()
    cuda_build.check(lib.hyt_short_attn_occupancy(N, hd, _OUT_KIND[out_dtype], ctypes.byref(regs),
                                                  ctypes.byref(ctas)), "occupancy")
    return {"registers": regs.value, "ctas_per_sm": ctas.value}


@functools.lru_cache(maxsize=None)
def _scale(hd: int, dtype) -> float:
    """hd^-0.5 as JAX's weak typing rounds it next to ``dtype`` q."""
    return nn.weak_scalar(hd ** -0.5, dtype)


def _scale_on(out_scale, dev):
    """``out_scale`` as a (1,) f32 tensor on ``dev``, or None."""
    if out_scale is None:
        return None
    s = out_scale if isinstance(out_scale, torch.Tensor) else torch.tensor(float(out_scale))
    return s.to(device=dev, dtype=torch.float32).reshape(1).contiguous()


# --------------------------------------------------------------------- K8
def fused_qkv_attention_ref(qkv: torch.Tensor, num_heads: int, out_scale=None) -> torch.Tensor:
    """Plain version of K8 (_attn_qkv_kernel): head by head on slices of the
    fused (B, N, 3D) tensor, q of head t at t * hd, k at D + t * hd, v at
    2 D + t * hd, each head's result written into its columns of the
    (B, N, D) output."""
    B, N, td = qkv.shape
    hd = td // 3 // num_heads
    D = num_heads * hd
    scale = nn.weak_scalar(hd ** -0.5, qkv.dtype)
    inv = None
    if out_scale is not None:
        inv = 1.0 / torch.as_tensor(out_scale, dtype=torch.float32, device=qkv.device).reshape(())
    out = torch.empty((B, N, D), dtype=qkv.dtype if inv is None else torch.int8,
                      device=qkv.device)
    for t in range(num_heads):
        q = qkv[:, :, t * hd:(t + 1) * hd]
        k = qkv[:, :, D + t * hd:D + (t + 1) * hd]
        v = qkv[:, :, 2 * D + t * hd:2 * D + (t + 1) * hd]
        logits = torch.einsum("bnd,bmd->bnm", (q * scale).float(), k.float())
        e = torch.exp(logits - torch.amax(logits, dim=-1, keepdim=True))
        p = e * (1.0 / torch.sum(e, dim=-1, keepdim=True))
        res = torch.einsum("bnm,bmd->bnd", p.to(v.dtype).float(), v.float())
        if inv is not None:
            res = torch.clamp(torch.round(res * inv), -127, 127)
        out[:, :, t * hd:(t + 1) * hd] = res.to(out.dtype)
    return out


def fused_qkv_attention(qkv: torch.Tensor, num_heads: int, out_scale=None) -> torch.Tensor:
    """softmax attention straight from the fused qkv tensor, the JAX
    signature: qkv (B, N, 3D) as the qkv GEMM wrote it -> (B, N, D) in
    qkv.dtype, or int8 quantized by the static scale ``out_scale``.

    CPU tensors take the plain version. CUDA tensors launch the K8 entry of
    ``csrc/short_attention.cu``: bf16 or f32, the head width a multiple of
    8 (bf16: hd <= MAX_HD); anything else raises.
    """
    cuda_build.refuse_grad("fused_qkv_attention", qkv, out_scale)
    if qkv.device.type == "cpu":
        return fused_qkv_attention_ref(qkv, num_heads, out_scale)
    what = "fused_qkv_attention"
    dev = qkv.device
    if dev.type != "cuda":
        raise ValueError(f"{what}: unsupported device {dev}")
    if qkv.dim() != 3 or qkv.shape[2] % (3 * num_heads):
        raise ValueError(f"{what}: qkv must be (B, N, 3 * heads * hd), got {tuple(qkv.shape)} "
                         f"for {num_heads} heads")
    B, N, td = qkv.shape
    hd = td // 3 // num_heads
    out = torch.empty((B, N, td // 3), dtype=qkv.dtype if out_scale is None else torch.int8,
                      device=dev)
    _check_in_out(qkv.dtype, (), out.dtype, out_scale, what)
    if hd % 8:
        raise ValueError(f"{what}: the head width {hd} must be a multiple of 8")
    qkv = cuda_build.aligned16(qkv)
    lib = _library(N, hd, qkv.dtype, what)
    s = _scale_on(out_scale, dev)
    idx = qkv.get_device()
    with torch.cuda.device(idx):  # an index, not a device: a third of the host cost
        stream = torch.cuda.current_stream(idx).cuda_stream
        cuda_build.check(lib.hyt_fused_qkv_attention(
            qkv.data_ptr(), int(qkv.dtype == torch.float32), out.data_ptr(),
            _OUT_KIND[out.dtype], None if s is None else s.data_ptr(), B, N, num_heads, hd,
            _scale(hd, qkv.dtype), stream), f"{what}: short_attention_kernel")
    fused_qkv_attention.launches += 1
    return out


fused_qkv_attention.launches = 0


# JAX's crossover for "auto" (hamer_yolo_tpu/ops/attention_pallas.py
# MIN_PALLAS_CROPS, measured on a TPU): the kernel from this many crops up.
MIN_PALLAS_CROPS = 64
FORCES = ("xla", "pallas", "pallas_direct", "pallas_fusedqkv", "auto")


def softmax_attention_qkv(qkv: torch.Tensor, num_heads: int, *, force: str = "xla",
                          out_scale=None) -> torch.Tensor:
    """(B, N, 3D) fused qkv -> (B, N, D) softmax attention, the JAX
    function's forms.

    "xla": the plain einsum softmax in qkv's dtype (core/nn's op sequence),
    quantized by dividing by ``out_scale`` when it is given. "pallas_direct":
    K7 (its plain version on the CPU) on views of qkv; with ``out_scale`` the
    int8 epilogue quantizes in the kernel. "pallas_fusedqkv": K8, the same
    with the fused tensor handed over as it is. "pallas": K7 on the crop
    batch as given (JAX's custom_vmap rule collapses vmapped crops into one
    batch first; the port's batch is that batch already). "auto": K7 where
    qkv is on the card and holds at least MIN_PALLAS_CROPS crops, the
    einsum otherwise. "pallas" and "auto" take no ``out_scale`` (a
    ValueError, as in JAX). ``force`` is explicit: the HYT_ATTN switch is
    read in core/quant.py.
    """
    if force not in FORCES:
        raise ValueError(f"softmax_attention_qkv: force {force!r} (one of {FORCES})")
    if out_scale is not None and force in ("pallas", "auto"):
        raise ValueError("out_scale requires force='xla'/'pallas_direct'/'pallas_fusedqkv'")
    if force == "pallas_fusedqkv":
        return fused_qkv_attention(qkv, num_heads, out_scale=out_scale)
    B, N, td = qkv.shape
    hd = td // 3 // num_heads
    x = qkv.reshape(B, N, 3, num_heads, hd)
    q, k, v = x[:, :, 0], x[:, :, 1], x[:, :, 2]  # (B, N, h, hd)
    if force == "auto":
        force = "pallas" if qkv.is_cuda and B >= MIN_PALLAS_CROPS else "xla"
    if force in ("pallas_direct", "pallas"):
        out = fused_short_attention(q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
                                    out_scale=out_scale)
        return out.transpose(1, 2).reshape(B, N, num_heads * hd)
    out = nn._softmax_attention(nn._scaled(q, hd), k, v)
    if out_scale is None:
        return out
    s = torch.as_tensor(out_scale, dtype=torch.float32, device=qkv.device).reshape(())
    return torch.clamp(torch.round(out.float() / s), -127, 127).to(torch.int8)


def fast_mha_self_attention(p: nn.Params, x: torch.Tensor, num_heads: int,
                            force: str = "xla") -> torch.Tensor:
    """nn.mha_self_attention with its softmax attention in the form ``force``
    of softmax_attention_qkv (JAX: ops/attention_pallas.fast_mha_self_attention,
    whose form HYT_ATTN names; pipeline/frame._select_attn_impl reads it)."""
    qkv = nn.linear(p["qkv"], x)
    return nn.linear(p["proj"], softmax_attention_qkv(qkv, num_heads, force=force))
