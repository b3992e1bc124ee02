"""Functional layers on tensors (port of hamer_yolo_tpu/core/nn.py).

Parameters are nested dicts of tensors, as the JAX pytrees are, and each
layer keeps the JAX layer's arithmetic: weights are cast to the activation
dtype per op and bias is added after the product, in the activation dtype.
``linear`` takes that cast from ``cast_weight``, which makes it once per
weight tensor (the same rounding, kept while the weight lives).

Layouts: activations are NHWC images and (B, N, D) tokens at every public
function; linear weights stay (in, out) so y = x @ w + b; conv weights are
OIHW (core/bridge.py transposes JAX's HWIO once), and conv2d moves NHWC to
NCHW at its boundary as a view (the permuted tensor is channels-last in
memory, which cuDNN takes as it is).
"""
from __future__ import annotations

import functools
import math
import weakref
from typing import Any, Callable, Dict, Tuple

import torch
import torch.nn.functional as F

Params = Dict[str, Any]


# ---------------------------------------------------------------------------
# Seeded random init (the JAX initialisers' distributions, not their bits:
# torch.Generator and jax.random give different numbers from one seed).
# ---------------------------------------------------------------------------

def kaiming_uniform(shape, fan_in: int, gen: torch.Generator) -> torch.Tensor:
    bound = math.sqrt(6.0 / fan_in)
    t = torch.empty(shape, device=gen.device)
    return t.uniform_(-bound, bound, generator=gen)


def trunc_normal(shape, gen: torch.Generator, std: float = 0.02) -> torch.Tensor:
    t = torch.empty(shape, device=gen.device)
    return torch.nn.init.trunc_normal_(t, 0.0, std, -2.0 * std, 2.0 * std, generator=gen)


def linear_init(gen: torch.Generator, in_dim: int, out_dim: int, bias: bool = True) -> Params:
    p = {"w": kaiming_uniform((in_dim, out_dim), in_dim, gen)}
    if bias:
        p["b"] = torch.zeros(out_dim, device=gen.device)
    return p


def conv_init(gen: torch.Generator, k: int, c_in: int, c_out: int, bias: bool = False,
              groups: int = 1) -> Params:
    p = {"w": kaiming_uniform((c_out, c_in // groups, k, k), c_in // groups * k * k, gen)}
    if bias:
        p["b"] = torch.zeros(c_out, device=gen.device)
    return p


def layer_norm_init(dim: int, device) -> Params:
    return {"scale": torch.ones(dim, device=device), "bias": torch.zeros(dim, device=device)}


def mha_qkv_init(gen: torch.Generator, dim: int, num_heads: int, head_dim: int = 0,
                 qkv_bias: bool = True, out_bias: bool = True) -> Params:
    inner = (head_dim or dim // num_heads) * num_heads
    return {"qkv": linear_init(gen, dim, inner * 3, bias=qkv_bias),
            "proj": linear_init(gen, inner, dim, bias=out_bias)}


def cross_attention_init(gen: torch.Generator, dim: int, context_dim: int, num_heads: int,
                         head_dim: int) -> Params:
    inner = head_dim * num_heads
    return {"to_q": linear_init(gen, dim, inner, bias=False),
            "to_kv": linear_init(gen, context_dim, inner * 2, bias=False),
            "proj": linear_init(gen, inner, dim, bias=True)}


def mlp_init(gen: torch.Generator, dim: int, hidden: int) -> Params:
    return {"fc1": linear_init(gen, dim, hidden), "fc2": linear_init(gen, hidden, dim)}


# ---------------------------------------------------------------------------
# Values derived from a weight once: (id(w), tag) -> (weak reference to w,
# w's version counter, the value). An in-place change to w bumps its version
# and the value is made anew; the entry goes with w.
# ---------------------------------------------------------------------------
_DERIVED: Dict[tuple, tuple] = {}


def derived(w: torch.Tensor, tag, make: Callable[[], Any]) -> Any:
    """``make()``, a value computed from the weight ``w`` alone, made once
    per (weight tensor, ``tag``) and kept while ``w`` lives unchanged."""
    key = (id(w), tag)
    version = None if w.is_inference() else w._version
    hit = _DERIVED.get(key)
    if hit is not None and hit[0]() is w and hit[1] == version:
        return hit[2]
    value = make()
    _DERIVED[key] = (weakref.ref(w, lambda _, key=key: _DERIVED.pop(key, None)), version, value)
    return value


@functools.lru_cache(maxsize=None)
def constant(values: tuple, dtype: torch.dtype, device: torch.device) -> torch.Tensor:
    """``torch.tensor(values, dtype)`` on ``device``, made once: a constant
    copied from the host inside a forward would keep the forward from being
    captured in a CUDA graph (pipeline/captured.py). Made outside inference
    mode whatever the caller's, so that autograd may save it (an index into
    a train step's activations), also after an inference forward made it."""
    with torch.inference_mode(False):
        return torch.tensor(values, dtype=dtype, device=device)


def cast_weight(w: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """``w.to(dtype)``, made once per weight tensor and dtype;
    ``cast_weight.casts`` counts the casts made. Where autograd would track
    the cast, it is made per call, as ``w.to`` does."""
    if w.dtype == dtype:
        return w
    if w.requires_grad and torch.is_grad_enabled():
        return w.to(dtype)

    def make():
        cast_weight.casts += 1
        return w.to(dtype)

    return derived(w, dtype, make)


cast_weight.casts = 0


# ---------------------------------------------------------------------------
# Layers
# ---------------------------------------------------------------------------

def linear(p: Params, x: torch.Tensor) -> torch.Tensor:
    y = x @ cast_weight(p["w"], x.dtype)
    if "b" in p:
        y = y + cast_weight(p["b"], x.dtype)
    return y


def weak_scalar(value: float, dtype: torch.dtype) -> float:
    """A Python float as JAX's weak typing sees it next to a ``dtype``
    array: cast to that dtype first (hd^-0.5 and 1e-6 are not exact in bf16)."""
    return torch.tensor(value, dtype=dtype).item()


def rsqrt(x: torch.Tensor) -> torch.Tensor:
    """rsqrt computed in f32 and rounded to x's dtype, which is what XLA does
    for bf16 (torch's bf16 rsqrt rounds differently in a few elements); f32
    and f64 in their own precision."""
    if x.dtype in (torch.bfloat16, torch.float16):
        return torch.rsqrt(x.float()).to(x.dtype)
    return torch.rsqrt(x)


def layer_norm(p: Params, x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    mu = torch.mean(x, dim=-1, keepdim=True)
    var = torch.mean(torch.square(x - mu), dim=-1, keepdim=True)
    y = (x - mu) * rsqrt(var + weak_scalar(eps, x.dtype))
    return y * p["scale"].to(x.dtype) + p["bias"].to(x.dtype)


def resolve_padding(padding: Any, hw: Tuple[int, int], k: Tuple[int, int],
                    stride: Tuple[int, int]) -> list:
    """JAX's padding forms -> ((top, bottom), (left, right)): an int, "SAME"
    (XLA's: the total pad split with the extra row at the end), "VALID", or
    explicit pairs."""
    if isinstance(padding, int):
        return [(padding, padding), (padding, padding)]
    if padding == "VALID":
        return [(0, 0), (0, 0)]
    if padding == "SAME":
        pads = []
        for dim, kk, s in zip(hw, k, stride):
            tot = max((-(-dim // s) - 1) * s + kk - dim, 0)
            pads.append((tot // 2, tot - tot // 2))
        return pads
    return [tuple(int(v) for v in p) for p in padding]


def conv_kernel_size(w) -> int:
    """kh of a conv weight: an (O, C, kh, kw) tensor or an int8 {"q", "scale"}."""
    return (w["q"] if isinstance(w, dict) else w).shape[2]


def conv2d(p: Params, x: torch.Tensor, stride: int = 1, padding: Any = 0,
           groups: int = 1) -> torch.Tensor:
    """x (B, H, W, C) NHWC, p["w"] (O, C / groups, kh, kw) -> (B, H', W', O).

    ``padding`` is an int, or JAX's "SAME", "VALID" or ((top, bottom),
    (left, right)). Where p["w"] is an int8 {"q", "scale"} the conv takes
    JAX's W8A8 routes (core/int8_conv.py).
    """
    strides = (stride, stride) if isinstance(stride, int) else tuple(stride)
    if isinstance(p["w"], dict):
        from hamer_yolo_tpu_torch.core.int8_conv import int8_conv2d

        y = int8_conv2d(p, x, strides, padding, groups)
    else:
        xc = x.permute(0, 3, 1, 2)
        w = cast_weight(p["w"], x.dtype)
        if not isinstance(padding, int):
            (pt, pb), (pl, pr) = resolve_padding(padding, x.shape[1:3], w.shape[2:], strides)
            xc, padding = F.pad(xc, (pl, pr, pt, pb)), 0
        y = F.conv2d(xc, w, None, strides, padding, 1, groups).permute(0, 2, 3, 1)
    if "b" in p:
        y = y + cast_weight(p["b"], x.dtype)
    return y


def batch_norm_init(dim: int, device) -> Params:
    return {"scale": torch.ones(dim, device=device), "bias": torch.zeros(dim, device=device),
            "mean": torch.zeros(dim, device=device), "var": torch.ones(dim, device=device)}


def batch_norm(p: Params, x: torch.Tensor, eps: float = 1e-3) -> torch.Tensor:
    """Inference-mode BN with running stats, every op in x's dtype and
    rounded there, as JAX computes it (rsqrt(var + eps) included; eps 1e-3
    is YOLO's, pass it where it differs). Not folded into the conv: that
    rounds elsewhere. rsqrt(var + eps) depends on the weights alone, so it
    is made once per var tensor and dtype (``derived``), except where
    autograd tracks var (a train step that trains the running stats, as
    JAX's KPFusion step does): a cached value would carry no gradient."""
    def make():
        return rsqrt(p["var"].to(x.dtype) + weak_scalar(eps, x.dtype))

    if p["var"].requires_grad and torch.is_grad_enabled():
        inv = make()
    else:
        inv = derived(p["var"], ("batch_norm_inv", x.dtype, eps), make)
    return ((x - cast_weight(p["mean"], x.dtype)) * inv * cast_weight(p["scale"], x.dtype)
            + cast_weight(p["bias"], x.dtype))


def batch_norm_train(p: Params, x: torch.Tensor, eps: float = 1e-3, momentum: float = 0.03
                     ) -> Tuple[torch.Tensor, Params]:
    """Training-mode BN over the batch statistics of x (B, ..., C), and the
    updated running stats (torch's semantics: momentum 0.03, YOLOv7's
    initialize_weights; the unbiased variance), in JAX's order of
    operations: the moments are taken in f32 (jnp.mean and jnp.var upcast a
    bf16 input) and rounded to x's dtype before they normalise x; the stats
    update is made without gradient. Returns (y, a copy of p whose "mean"
    and "var" are the new stats)."""
    axes = tuple(range(x.ndim - 1))
    xf = x.float() if x.dtype in (torch.bfloat16, torch.float16) else x
    mean32 = xf.mean(dim=axes)
    mean = mean32.to(x.dtype)
    var = torch.square(xf - mean32).mean(dim=axes).to(x.dtype)
    inv = rsqrt(var + weak_scalar(eps, x.dtype))
    y = (x - mean) * inv * p["scale"].to(x.dtype) + p["bias"].to(x.dtype)
    n = math.prod(x.shape[:-1])
    with torch.no_grad():
        unbiased = var * weak_scalar(n / max(n - 1, 1), x.dtype)
        stats = {"mean": (1 - momentum) * p["mean"] + momentum * mean.to(p["mean"].dtype),
                 "var": (1 - momentum) * p["var"] + momentum * unbiased.to(p["var"].dtype)}
    return y, dict(p, **stats)


def max_pool(x: torch.Tensor, k: int, stride: int, padding: int = 0) -> torch.Tensor:
    """NHWC max pool with -inf padding (reduce_window semantics)."""
    y = F.max_pool2d(x.permute(0, 3, 1, 2), k, stride, padding)
    return y.permute(0, 2, 3, 1)


def avg_pool_global(x: torch.Tensor) -> torch.Tensor:
    """(B, H, W, C) -> (B, C) global average pool."""
    return torch.mean(x, dim=(1, 2))


def _scaled(q: torch.Tensor, head_dim: int) -> torch.Tensor:
    """q * hd^-0.5 with JAX's weak-typed scalar."""
    return q * weak_scalar(head_dim ** -0.5, q.dtype)


def softmax(x: torch.Tensor, dim: int = -1) -> torch.Tensor:
    """jax.nn.softmax's op sequence, each op rounded to x's dtype (in bf16
    this differs from torch.softmax, which rounds once at the end)."""
    e = torch.exp(x - torch.amax(x, dim=dim, keepdim=True))
    return e / torch.sum(e, dim=dim, keepdim=True)


def gelu(x: torch.Tensor) -> torch.Tensor:
    """Exact erf GELU as jax.nn.gelu(approximate=False) computes it:
    0.5 x erfc(-x sqrt(1/2)), rounded per op in x's dtype."""
    return 0.5 * x * torch.special.erfc(-x * weak_scalar(math.sqrt(0.5), x.dtype))


def _softmax_attention(q, k, v):
    """q (B, N, h, hd) already scaled; k, v (B, M, h, hd) -> (B, N, h*hd)."""
    logits = torch.einsum("bnhd,bmhd->bhnm", q, k)
    attn = softmax(logits, dim=-1)
    out = torch.einsum("bhnm,bmhd->bnhd", attn, v)
    return out.reshape(q.shape[0], q.shape[1], -1)


def mha_self_attention(p: Params, x: torch.Tensor, num_heads: int) -> torch.Tensor:
    """Fused-qkv softmax self-attention, x (B, N, D) -> (B, N, D)."""
    B, N, _ = x.shape
    hd = p["qkv"]["w"].shape[1] // 3 // num_heads
    qkv = linear(p["qkv"], x).reshape(B, N, 3, num_heads, hd)
    q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
    return linear(p["proj"], _softmax_attention(_scaled(q, hd), k, v))


def cross_attention(p: Params, x: torch.Tensor, context: torch.Tensor,
                    num_heads: int) -> torch.Tensor:
    """x (B, N, D) queries over context (B, M, Dc)."""
    B, N, _ = x.shape
    M = context.shape[1]
    hd = p["to_q"]["w"].shape[1] // num_heads
    q = linear(p["to_q"], x).reshape(B, N, num_heads, hd)
    kv = linear(p["to_kv"], context).reshape(B, M, 2, num_heads, hd)
    return linear(p["proj"], _softmax_attention(_scaled(q, hd), kv[:, :, 0], kv[:, :, 1]))


def mlp_gelu(p: Params, x: torch.Tensor) -> torch.Tensor:
    """fc1 -> exact erf GELU -> fc2."""
    return linear(p["fc2"], gelu(linear(p["fc1"], x)))
