"""Kernel K7: single-block softmax attention over short sequences, with an
optional int8 epilogue (port of fused_short_attention and
softmax_attention_qkv in hamer_yolo_tpu/ops/attention_pallas.py).

The CUDA counterpart is ``csrc/short_attention.cu``: one launch, one CTA per
(64-row query tile, head, crop), reading q, k and v through strides so that
``softmax_attention_qkv`` hands it views of the fused qkv tensor without the
transposes the TPU path materialises. ``launch_attention`` is also the
attention launch of K2 (ops/attn_block.py) and K3 (ops/attn_proj_block.py).
"""
from __future__ import annotations

import torch

from hamer_yolo_tpu_torch.core import nn
from hamer_yolo_tpu_torch.ops import cuda_build

_OUT_KIND = {torch.bfloat16: 0, torch.float32: 1, torch.int8: 2}  # of hyt_short_attention


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


def fused_short_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          out_scale=None) -> torch.Tensor:
    """softmax(q k^T / sqrt(hd)) v per (crop, head), no mask, with the JAX
    signature: q/k/v (B, h, N, hd) -> (B, h, N, hd) in q.dtype, or int8
    quantized by the static scale ``out_scale`` (that of the consuming int8
    GEMM).

    CPU tensors take the plain version. CUDA tensors launch
    ``csrc/short_attention.cu``: bf16 q, k, v of one shape and one stride
    set with hd contiguous (views into a fused qkv tensor are fine), hd a
    multiple of 8; anything else raises. The output is a (B, h, N, hd) view
    of a (B, N, h, hd) tensor, the layout the proj GEMM reads.
    """
    if q.device.type == "cpu":
        return fused_short_attention_ref(q, k, v, out_scale)
    B, H, N, hd = q.shape
    out = torch.empty((B, N, H, hd), dtype=torch.bfloat16 if out_scale is None else torch.int8,
                      device=q.device).transpose(1, 2)
    launch_attention(q, k, v, out, out_scale, "fused_short_attention")
    fused_short_attention.launches += 1
    return out


fused_short_attention.launches = 0


def launch_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, out: torch.Tensor,
                     out_scale, what: str) -> None:
    """Launch csrc/short_attention.cu on (B, h, N, hd) views q, k, v into
    ``out`` (any strides, hd contiguous): bf16 or f32, or int8 quantized by
    ``out_scale``."""
    dev = q.device
    if dev.type != "cuda":
        raise ValueError(f"{what}: unsupported device {dev}")
    if q.dim() != 4 or not (q.shape == k.shape == v.shape == out.shape):
        raise ValueError(f"{what}: q, k, v, out of one (B, h, N, hd) shape, got "
                         f"{[tuple(t.shape) for t in (q, k, v, out)]}")
    if any(t.dtype != torch.bfloat16 for t in (q, k, v)):
        raise ValueError(f"{what}: the kernel takes bf16 q, k, v, got "
                         f"{[t.dtype for t in (q, k, v)]}")
    if any(t.device != dev for t in (k, v, out)):
        raise ValueError(f"{what}: every tensor must be on {dev}")
    if out.dtype not in _OUT_KIND or (out.dtype == torch.int8) != (out_scale is not None):
        raise ValueError(f"{what}: the output is bf16 or f32, or int8 with an out_scale; got "
                         f"{out.dtype} with out_scale {out_scale is not None}")
    B, H, N, hd = q.shape
    st = q.stride()
    if k.stride() != st or v.stride() != st or st[3] != 1 or out.stride(3) != 1:
        raise ValueError(f"{what}: q, k, v need one stride set with hd contiguous, got "
                         f"{[t.stride() for t in (q, k, v, out)]}")
    if hd % 8 or any(s % 8 for s in st[:3]) or any(t.data_ptr() % 16 for t in (q, k, v)):
        raise ValueError(f"{what}: hd = {hd} and the strides {st[:3]} must be multiples of 8, "
                         "the tensors 16-byte aligned")
    lib = cuda_build.load("short_attention.cu")
    smem = lib.hyt_short_attn_smem_bytes(N, hd)
    if smem > cuda_build.MAX_SMEM:
        raise ValueError(f"{what}: N={N}, hd={hd} needs {smem} B of shared memory")
    s = None
    if out_scale is not None:
        s = out_scale if isinstance(out_scale, torch.Tensor) else torch.tensor(float(out_scale))
        s = s.to(device=dev, dtype=torch.float32).reshape(1).contiguous()
    scale = nn.weak_scalar(hd ** -0.5, torch.bfloat16)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        cuda_build.check(lib.hyt_short_attention(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), st[0], st[1], st[2], out.data_ptr(),
            _OUT_KIND[out.dtype], None if s is None else s.data_ptr(), out.stride(0),
            out.stride(1), out.stride(2),
            B, H, N, hd, scale, stream), f"{what}: short_attention_kernel")


def softmax_attention_qkv(qkv: torch.Tensor, num_heads: int, *, force: str = "xla",
                          out_scale=None) -> torch.Tensor:
    """(B, N, 3D) fused qkv -> (B, N, D) softmax attention, the JAX
    function's "xla" and "pallas_direct" forms.

    "xla": the plain einsum softmax in qkv's dtype (core/nn's op sequence),
    quantized by dividing by ``out_scale`` when it is given. "pallas_direct":
    K7 (its plain version on the CPU) on views of qkv; with ``out_scale`` the
    int8 epilogue quantizes in the kernel.
    """
    B, N, td = qkv.shape
    hd = td // 3 // num_heads
    x = qkv.reshape(B, N, 3, num_heads, hd)
    q, k, v = x[:, :, 0], x[:, :, 1], x[:, :, 2]  # (B, N, h, hd)
    if force == "pallas_direct":
        out = fused_short_attention(q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
                                    out_scale=out_scale)
        return out.transpose(1, 2).reshape(B, N, num_heads * hd)
    if force != "xla":
        raise ValueError(f"softmax_attention_qkv: force {force!r} (xla or pallas_direct)")
    out = nn._softmax_attention(nn._scaled(q, hd), k, v)
    if out_scale is None:
        return out
    s = torch.as_tensor(out_scale, dtype=torch.float32, device=qkv.device).reshape(())
    return torch.clamp(torch.round(out.float() / s), -127, 127).to(torch.int8)
