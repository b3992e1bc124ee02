"""Ghost, Stem and Swin-transformer YOLOv7 block variants, deploy form (port
of hamer_yolo_tpu/models/yolov7/variants.py), NHWC.

- Ghost: GhostConv (half the channels by a conv, the other half by a 5x5
  depthwise conv of them), the Ghost bottleneck, GhostCSPA/B/C and
  GhostSPPCSPC.
- Stem and GhostStem.
- Swin: window attention with the relative position bias and the cyclic
  shift's mask, the Swin layer with a SiLU MLP, SwinTransformerBlock and
  STCSPA/B/C. The window attention is plain tensor ops in JAX, not a TPU
  kernel, and is written here as the same explicit products and softmax,
  with JAX's dtype promotions (the f32 bias table lifts bf16 logits to f32).
- RepConv_OREPA's branches collapse to one 3x3 conv at conversion
  (core/convert), so it runs as the plain deploy RepConv.

Variant specs name their ops by these tags, their first argument the
output channels; ``init_variant`` and ``apply_variant`` dispatch on them for
models/yolov7/model.py.
"""
from __future__ import annotations

import functools
from typing import Any, Dict

import numpy as np
import torch

from hamer_yolo_tpu_torch.core import nn
from hamer_yolo_tpu_torch.models.yolov7 import blocks as B

Params = Dict[str, Any]

GHOSTC, GHOST, GCSPA, GCSPB, GCSPC, GSPP = "GHOSTC", "GHOST", "GCSPA", "GCSPB", "GCSPC", "GSPP"
STEM, GSTEM = "STEM", "GSTEM"
SWINB, STCSPA, STCSPB, STCSPC = "SWINB", "STCSPA", "STCSPB", "STCSPC"
VARIANT_OPS = (GHOSTC, GHOST, GCSPA, GCSPB, GCSPC, GSPP, STEM, GSTEM,
               SWINB, STCSPA, STCSPB, STCSPC)
_CSP = {"GCSPA": "a", "GCSPB": "b", "GCSPC": "c"}


def _conv(p: Params, x: torch.Tensor, s: int = 1, act: bool = True,
          groups: int = 1) -> torch.Tensor:
    """Conv (BN folded) + SiLU, grouped where ``groups`` says."""
    k = nn.conv_kernel_size(p["conv"]["w"])
    y = nn.conv2d(p["conv"], x, stride=s, padding=k // 2, groups=groups)
    return B.silu(y) if act else y


def _conv_init(gen: torch.Generator, c1: int, c2: int, k: int = 1, groups: int = 1) -> Params:
    return {"conv": nn.conv_init(gen, k, c1, c2, bias=True, groups=groups)}


# ---------------------------------------------------------------------------
# Ghost family
# ---------------------------------------------------------------------------

def ghost_conv_init(gen: torch.Generator, c1: int, c2: int, k: int = 1) -> Params:
    c_ = c2 // 2
    return {"cv1": _conv_init(gen, c1, c_, k), "cv2": _conv_init(gen, c_, c_, 5, groups=c_)}


def ghost_conv(p: Params, x: torch.Tensor, s: int = 1, act: bool = True) -> torch.Tensor:
    y = _conv(p["cv1"], x, s=s, act=act)
    return torch.cat([y, _conv(p["cv2"], y, act=act, groups=y.shape[-1])], dim=-1)


def ghost_bottleneck_init(gen: torch.Generator, c1: int, c2: int, k: int = 3,
                          s: int = 1) -> Params:
    c_ = c2 // 2
    p: Params = {"g1": ghost_conv_init(gen, c1, c_, 1), "g2": ghost_conv_init(gen, c_, c2, 1)}
    if s == 2:
        p["dw"] = _conv_init(gen, c_, c_, k, groups=c_)
        p["sc_dw"] = _conv_init(gen, c1, c1, k, groups=c1)
        p["sc_pw"] = _conv_init(gen, c1, c2, 1)
    return p


def ghost_bottleneck(p: Params, x: torch.Tensor, s: int = 1) -> torch.Tensor:
    y = ghost_conv(p["g1"], x)
    if s == 2:
        y = _conv(p["dw"], y, s=2, act=False, groups=y.shape[-1])
        sc = _conv(p["sc_pw"], _conv(p["sc_dw"], x, s=2, act=False, groups=x.shape[-1]),
                   act=False)
    else:
        sc = x
    return ghost_conv(p["g2"], y, act=False) + sc


def _csp_init(gen: torch.Generator, c1: int, c2: int, n: int, variant: str, body_init) -> Params:
    """The CSP wrapper's convs (BottleneckCSPA/B/C shapes) and n bodies."""
    c_ = int(c2) if variant == "b" else int(c2 * 0.5)
    if variant == "a":
        p = {"cv1": _conv_init(gen, c1, c_), "cv2": _conv_init(gen, c1, c_),
             "cv3": _conv_init(gen, 2 * c_, c2)}
    elif variant == "b":
        p = {"cv1": _conv_init(gen, c1, c_), "cv2": _conv_init(gen, c_, c_),
             "cv3": _conv_init(gen, 2 * c_, c2)}
    else:
        p = {"cv1": _conv_init(gen, c1, c_), "cv2": _conv_init(gen, c1, c_),
             "cv3": _conv_init(gen, c_, c_), "cv4": _conv_init(gen, 2 * c_, c2)}
    p["m"] = [body_init(gen, c_) for _ in range(n)]
    return p


def _csp_forward(p: Params, x: torch.Tensor, variant: str, body) -> torch.Tensor:
    if variant == "a":
        y1 = _conv(p["cv1"], x)
        y1 = body(p["m"], y1)
        return _conv(p["cv3"], torch.cat([y1, _conv(p["cv2"], x)], dim=-1))
    if variant == "b":
        x1 = _conv(p["cv1"], x)
        y1 = body(p["m"], x1)
        return _conv(p["cv3"], torch.cat([y1, _conv(p["cv2"], x1)], dim=-1))
    y1 = _conv(p["cv3"], body(p["m"], _conv(p["cv1"], x)))
    return _conv(p["cv4"], torch.cat([y1, _conv(p["cv2"], x)], dim=-1))


def _ghost_chain(ps, y: torch.Tensor) -> torch.Tensor:
    for bp in ps:
        y = ghost_bottleneck(bp, y)
    return y


def ghost_sppcspc_init(gen: torch.Generator, c1: int, c2: int) -> Params:
    c_ = c2
    specs = [(c1, c_, 1), (c1, c_, 1), (c_, c_, 3), (c_, c_, 1), (4 * c_, c_, 1), (c_, c_, 3),
             (2 * c_, c2, 1)]
    return {f"cv{i + 1}": ghost_conv_init(gen, a, b, k) for i, (a, b, k) in enumerate(specs)}


def ghost_sppcspc(p: Params, x: torch.Tensor) -> torch.Tensor:
    x1 = ghost_conv(p["cv4"], ghost_conv(p["cv3"], ghost_conv(p["cv1"], x)))
    pools = [B.sp(x1, k) for k in B.SPP_POOL_KS]
    y1 = ghost_conv(p["cv6"], ghost_conv(p["cv5"], torch.cat([x1] + pools, dim=-1)))
    return ghost_conv(p["cv7"], torch.cat([y1, ghost_conv(p["cv2"], x)], dim=-1))


def stem_init(gen: torch.Generator, c1: int, c2: int, ghost: bool = False) -> Params:
    c_ = int(c2 / 2)
    if ghost:  # GhostStem
        return {"cv1": ghost_conv_init(gen, c1, c_, 3), "cv2": ghost_conv_init(gen, c_, c_, 1),
                "cv3": ghost_conv_init(gen, c_, c_, 3), "cv4": ghost_conv_init(gen, 2 * c_, c2, 1)}
    return {"cv1": _conv_init(gen, c1, c_, 3), "cv2": _conv_init(gen, c_, c_, 1),
            "cv3": _conv_init(gen, c_, c_, 3), "cv4": _conv_init(gen, 2 * c_, c2, 1)}


def stem_forward(p: Params, x: torch.Tensor, ghost: bool = False) -> torch.Tensor:
    cv = ghost_conv if ghost else _conv
    x = cv(p["cv1"], x, s=2)
    a = cv(p["cv3"], cv(p["cv2"], x), s=2)
    return cv(p["cv4"], torch.cat([a, B.mp(x)], dim=-1))


# ---------------------------------------------------------------------------
# Swin transformer family (v1)
# ---------------------------------------------------------------------------

def relative_position_index(ws: int) -> np.ndarray:
    """The static (ws^2, ws^2) index into the (2 ws - 1)^2 bias table."""
    coords = np.stack(np.meshgrid(np.arange(ws), np.arange(ws), indexing="ij"))
    flat = coords.reshape(2, -1)
    rel = (flat[:, :, None] - flat[:, None, :]).transpose(1, 2, 0)
    rel[:, :, 0] += ws - 1
    rel[:, :, 1] += ws - 1
    rel[:, :, 0] *= 2 * ws - 1
    return rel.sum(-1)


def shift_mask(H: int, W: int, ws: int, shift: int) -> np.ndarray:
    """The shifted windows' (nW, ws^2, ws^2) attention mask: -100 between
    tokens of different regions of the rolled map, else 0."""
    img = np.zeros((H, W), np.int32)
    cnt = 0
    for hs in (slice(0, -ws), slice(-ws, -shift), slice(-shift, None)):
        for wsl in (slice(0, -ws), slice(-ws, -shift), slice(-shift, None)):
            img[hs, wsl] = cnt
            cnt += 1
    win = img.reshape(H // ws, ws, W // ws, ws).transpose(0, 2, 1, 3).reshape(-1, ws * ws)
    diff = win[:, None, :] - win[:, :, None]
    return np.where(diff != 0, -100.0, 0.0).astype(np.float32)


@functools.lru_cache(maxsize=None)
def _rpi_tensor(ws: int, device: torch.device) -> torch.Tensor:
    """relative_position_index flat on ``device``, made once (a host copy in
    a forward would keep it from a CUDA graph capture)."""
    return torch.from_numpy(relative_position_index(ws).reshape(-1)).to(device)


@functools.lru_cache(maxsize=None)
def _mask_tensor(H: int, W: int, ws: int, shift: int, device: torch.device) -> torch.Tensor:
    return torch.from_numpy(shift_mask(H, W, ws, shift)).to(device)


def window_attention_init(gen: torch.Generator, dim: int, num_heads: int, ws: int) -> Params:
    dev = gen.device
    return {"qkv": {"w": nn.kaiming_uniform((dim, 3 * dim), dim, gen),
                    "b": torch.zeros(3 * dim, device=dev)},
            "proj": {"w": nn.kaiming_uniform((dim, dim), dim, gen),
                     "b": torch.zeros(dim, device=dev)},
            "rpb": 0.02 * torch.randn(((2 * ws - 1) ** 2, num_heads), generator=gen,
                                      device=dev)}


def window_attention(p: Params, x: torch.Tensor, num_heads: int, ws: int,
                     mask: torch.Tensor = None) -> torch.Tensor:
    """x (nW * B, N, C) windows; mask (nW, N, N) or None."""
    Bn, N, C = x.shape
    hd = C // num_heads
    qkv = nn.linear(p["qkv"], x).reshape(Bn, N, 3, num_heads, hd)
    q, k, v = (qkv[:, :, i].permute(0, 2, 1, 3) for i in range(3))
    attn = nn._scaled(q, hd) @ k.transpose(-2, -1)  # (Bn, nh, N, N)
    bias = p["rpb"][_rpi_tensor(ws, x.device)].reshape(N, N, num_heads)
    attn = attn + bias.permute(2, 0, 1)[None]
    if mask is not None:
        nW = mask.shape[0]
        attn = attn.reshape(Bn // nW, nW, num_heads, N, N) + mask[:, None][None]
        attn = attn.reshape(Bn, num_heads, N, N)
    attn = nn.softmax(attn, dim=-1)
    out = attn @ v.to(attn.dtype)  # JAX promotes bf16 v to the f32 probabilities
    return nn.linear(p["proj"], out.permute(0, 2, 1, 3).reshape(Bn, N, C))


def swin_layer_init(gen: torch.Generator, dim: int, num_heads: int, ws: int,
                    mlp_ratio: float = 4.0) -> Params:
    return {"norm1": nn.layer_norm_init(dim, gen.device),
            "attn": window_attention_init(gen, dim, num_heads, ws),
            "norm2": nn.layer_norm_init(dim, gen.device),
            "mlp": nn.mlp_init(gen, dim, int(dim * mlp_ratio))}


def swin_layer(p: Params, x: torch.Tensor, num_heads: int, ws: int, shift: int) -> torch.Tensor:
    """x (B, H, W, C): padded to whole windows, cyclically shifted by
    ``shift`` where it is > 0, window attention, shifted back; then the SiLU
    MLP (the reference's yolov7 Swin uses nn.SiLU). Pre-norm residuals."""
    Bz, H_, W_, C = x.shape
    pad_b, pad_r = (ws - H_ % ws) % ws, (ws - W_ % ws) % ws
    if pad_b or pad_r:
        x = torch.nn.functional.pad(x, (0, 0, 0, pad_r, 0, pad_b))
    H, W = H_ + pad_b, W_ + pad_r
    shortcut = x.reshape(Bz, H * W, C)
    t = nn.layer_norm(p["norm1"], shortcut).reshape(Bz, H, W, C)
    mask = None
    if shift > 0:
        t = torch.roll(t, (-shift, -shift), dims=(1, 2))
        mask = _mask_tensor(H, W, ws, shift, x.device)
    win = t.reshape(Bz, H // ws, ws, W // ws, ws, C).permute(0, 1, 3, 2, 4, 5)
    win = window_attention(p["attn"], win.reshape(-1, ws * ws, C), num_heads, ws, mask)
    t = win.reshape(Bz, H // ws, W // ws, ws, ws, C).permute(0, 1, 3, 2, 4, 5)
    t = t.reshape(Bz, H, W, C)
    if shift > 0:
        t = torch.roll(t, (shift, shift), dims=(1, 2))
    t = shortcut + t.reshape(Bz, H * W, C)  # f32 from here: the bias table promoted it
    t = t + nn.linear(p["mlp"]["fc2"], B.silu(nn.linear(p["mlp"]["fc1"],
                                                         nn.layer_norm(p["norm2"], t))))
    return t.reshape(Bz, H, W, C)[:, :H_, :W_]


def swin_block_init(gen: torch.Generator, c1: int, c2: int, num_heads: int, n: int,
                    ws: int = 8) -> Params:
    p: Params = {"layers": [swin_layer_init(gen, c2, num_heads, ws) for _ in range(n)]}
    if c1 != c2:
        p["conv"] = _conv_init(gen, c1, c2, 1)
    return p


def swin_block(p: Params, x: torch.Tensor, num_heads: int, ws: int = 8) -> torch.Tensor:
    if "conv" in p:
        x = _conv(p["conv"], x)
    for i, lp in enumerate(p["layers"]):
        x = swin_layer(lp, x, num_heads, ws, 0 if i % 2 == 0 else ws // 2)
    return x


def _stcsp_width(c2: int, variant: str) -> int:
    return int(c2 * 0.5) if variant in ("a", "c") else int(c2)


def stcsp_init(gen: torch.Generator, c1: int, c2: int, n: int, variant: str) -> Params:
    c_ = _stcsp_width(c2, variant)
    p = _csp_init(gen, c1, c2, 0, variant, None)
    p["m"] = swin_block_init(gen, c_, c_, c_ // 32, n)
    return p


def stcsp_forward(p: Params, x: torch.Tensor, variant: str, c2: int) -> torch.Tensor:
    heads = _stcsp_width(c2, variant) // 32
    return _csp_forward(p, x, variant, lambda q, y: swin_block(q, y, heads))


# ---------------------------------------------------------------------------
# spec dispatch (models/yolov7/model.py)
# ---------------------------------------------------------------------------

def _arg(args: tuple, i: int, default: int) -> int:
    return int(args[i]) if len(args) > i else default


def init_variant(op: str, gen: torch.Generator, c1: int, args: tuple) -> Params:
    c2 = int(args[0])
    if op == GHOSTC:
        return ghost_conv_init(gen, c1, c2, _arg(args, 1, 1))
    if op == GHOST:
        return ghost_bottleneck_init(gen, c1, c2, _arg(args, 1, 3), _arg(args, 2, 1))
    if op in _CSP:
        return _csp_init(gen, c1, c2, _arg(args, 1, 1), _CSP[op],
                         lambda g, c: ghost_bottleneck_init(g, c, c, 3, 1))
    if op == GSPP:
        return ghost_sppcspc_init(gen, c1, c2)
    if op in (STEM, GSTEM):
        return stem_init(gen, c1, c2, ghost=op == GSTEM)
    if op == SWINB:
        return swin_block_init(gen, c1, c2, int(args[1]), _arg(args, 2, 1))
    if op in (STCSPA, STCSPB, STCSPC):
        return stcsp_init(gen, c1, c2, _arg(args, 1, 1), op[-1].lower())
    raise ValueError(op)


def apply_variant(op: str, p: Params, x: torch.Tensor, args: tuple) -> torch.Tensor:
    if op == GHOSTC:
        return ghost_conv(p, x, s=_arg(args, 2, 1))
    if op == GHOST:
        return ghost_bottleneck(p, x, s=_arg(args, 2, 1))
    if op in _CSP:
        return _csp_forward(p, x, _CSP[op], _ghost_chain)
    if op == GSPP:
        return ghost_sppcspc(p, x)
    if op in (STEM, GSTEM):
        return stem_forward(p, x, ghost=op == GSTEM)
    if op == SWINB:
        return swin_block(p, x, int(args[1]))
    if op in (STCSPA, STCSPB, STCSPC):
        return stcsp_forward(p, x, op[-1].lower(), int(args[0]))
    raise ValueError(op)
