"""W8A8 int8 ViT and detector (port of hamer_yolo_tpu/core/quant.py).

- weights: per-output-channel symmetric int8, quantized once
  (``quantize_vit_params``; on the card with the K-major copies the int8
  GEMM reads, ops/int8_matmul.kmajor_weight); the tree keeps JAX's
  structure, {"wq": {"q", "scale"}, "b"} per linear, so JAX trees load
  through core/bridge.py;
- activations: dynamic per-row absmax int8, or a calibrated static
  per-tensor scale ("sx", attached by ``attach_static_act_scales`` from the
  stats of ``collect_vit_act_stats``);
- int32 sums, dequantized to the compute dtype.

The detector's convs (``quantize_yolo_params``: {"w": {"q", "scale"}} per
conv, the pointwise ones or all but the head) take nn.conv2d's int8 routes
(core/int8_conv.py); ``calibrate_yolo_act_scales`` attaches each one's
static scale "sx" from an eager pass over a few frames.

``vit_forward_int8`` runs either the unfused composition (``int8_linear`` +
the einsum or K7 attention, in the compute dtype, as JAX's ``fused=False``)
or the kernels, with JAX's accelerator dispatch: K3 for the attention block
when both of its static scales are present, else K5 + K7 + K5; K4 for the
MLP when both of its static scales are present, else K5 twice. ``fused=None``
takes the kernels where the tokens are on CUDA (JAX: on a TPU); on CPU
tensors each kernel runs its plain version. One divergence: with a static
scale K5 quantizes by it at every M, as JAX's kernel does in interpret mode
(on the TPU JAX's small-M kernel quantizes per row whatever it is given).

The dispatch functions read JAX's own switches from the environment, at call
time, with JAX's values (where JAX asks "on a TPU, or interpret" the port is
already inside the kernel path: its tokens are on CUDA or ``fused`` was
forced):

- ``HYT_ATTN``: unset or ``megaproj`` gives K3 with both static scales;
  ``megakernel`` K6 + the pre-quantized proj product; ``pallas_fusedqkv`` K8
  and ``pallas_direct`` K7 for the attention between two K5; ``pallas`` K7 on
  the crop batch as given, ``auto`` K7 where qkv is on the card with at least
  short_attention.MIN_PALLAS_CROPS crops (JAX: on a TPU, or in interpret
  mode), the einsum otherwise (the port has no vmap: its crop batch is the
  collapsed one JAX's custom_vmap rule builds); ``xla`` (and any other value)
  the einsum attention there.
- ``HYT_SOFTMAX=exp2|exp2p`` and ``HYT_ATTN_MATH=int8``: K3's softmax flavour
  and attention products (ops/attn_proj_block.py); no other kernel reads them.
- ``HYT_ATTN_PREQUANT=0`` turns off K3, K6 and the int8 epilogue of K7 / K8:
  the proj GEMM then quantizes its own input (K5 with the static scale).
- ``HYT_INT8_MLP``: unset or ``megakernel`` gives K4 with both static scales,
  ``megakernel1`` K10 (``HYT_INT8_MLP_HC``: the chunk of its plain version),
  ``off`` (and any other value) K5 twice.
- ``HYT_INT8_FUSED=0`` keeps the unfused composition where ``fused`` and
  ``cfg.fused_attn`` leave the choice to the device.
- ``HYT_INT8_EP=bf16``: K5's chain form dequantizes in bf16
  (ops/int8_matmul.py), read by the kernel's wrapper.
- The TPU's group and tile knobs (``HYT_ATTN_MEGA_G``, ``HYT_ATTN_MEGAPROJ_G``,
  ``HYT_ATTN_BF16_G``, ``HYT_INT8_MLP_TM``) are bit-identical across their
  values in JAX and have no counterpart on this card: the port ignores them.

One place where JAX's tree surprises, kept as it is: under
``HYT_ATTN=megakernel`` with a static proj scale but no static qkv scale, K6
cannot run, and the attention falls to K7 with the int8 epilogue (``force``
becomes ``pallas_direct``), not to K8; with no static proj scale at all it is
the einsum, since ``megakernel`` is not a value ``softmax_attention_qkv``
knows.
"""
from __future__ import annotations

import os
from typing import Any, Dict, Optional

import numpy as np
import torch

from hamer_yolo_tpu_torch.core import nn
from hamer_yolo_tpu_torch.ops.attn_block_int8 import fused_int8_attn_block
from hamer_yolo_tpu_torch.ops.attn_proj_block import fused_int8_attn_proj_block
from hamer_yolo_tpu_torch.ops.int8_matmul import (RECIP_127, fused_int8_matmul,
                                                  fused_int8_mlp_block, fused_int8_mlp_block1,
                                                  gelu_prologue, int8_dot_prequant, int_dot,
                                                  kmajor_weight)
from hamer_yolo_tpu_torch.ops.short_attention import FORCES as ATTN_FORCES
from hamer_yolo_tpu_torch.ops.short_attention import (attn_math_flavor, softmax_attention_qkv,
                                                       softmax_flavor)

Params = Dict[str, Any]
STAT_KEYS = ("qkv", "proj", "fc1", "fc2")


def _div127(t: torch.Tensor) -> torch.Tensor:
    """t / 127 as JAX's compiled program computes it: times f32(1 / 127),
    rounded to t's dtype."""
    return (t.float() * RECIP_127).to(t.dtype)


def quantize_weight_int8(w: torch.Tensor) -> Dict[str, torch.Tensor]:
    """(in, out) f32 -> {q (in, out) int8, scale (out,) f32} per channel."""
    absmax = torch.amax(torch.abs(w), dim=0)
    scale = torch.clamp(_div127(absmax), min=1e-8)
    q = torch.clamp(torch.round(w / scale), -127, 127).to(torch.int8)
    return {"q": q, "scale": scale.float()}


def quantize_act_int8(x: torch.Tensor):
    """(..., d) -> (int8 values, per-row scale (..., 1)), in x's dtype."""
    absmax = torch.amax(torch.abs(x), dim=-1, keepdim=True)
    scale = torch.clamp(_div127(absmax), min=nn.weak_scalar(1e-8, x.dtype))
    return torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8), scale


def int8_linear(wq: Dict[str, torch.Tensor], x: torch.Tensor,
                bias: Optional[torch.Tensor] = None,
                sx_static: Optional[torch.Tensor] = None) -> torch.Tensor:
    """y = dequant(quant(x) @ wq) + b with int32 sums; ``sx_static`` a
    calibrated per-tensor scale in place of the dynamic per-row one. The
    int8 product is a plain exact torch op (ops/int8_matmul.int_dot), as
    JAX leaves it to dot_general."""
    if sx_static is None:
        qx, sx = quantize_act_int8(x)
    else:
        sx = sx_static.float()
        qx = torch.clamp(torch.round(x / sx.to(x.dtype)), -127, 127).to(torch.int8)
    y = (int_dot(qx, wq["q"]) * sx * wq["scale"]).to(x.dtype)
    if bias is not None:
        y = y + bias.to(x.dtype)
    return y


def quantize_linear_params(p: Params) -> Params:
    """A linear's int8 weight and its bias. On the card it also makes the
    weight's K-major copy, which the int8 GEMM reads
    (ops/int8_matmul.kmajor_weight), so that no forward makes one."""
    out: Params = {"wq": quantize_weight_int8(p["w"])}
    if out["wq"]["q"].is_cuda:
        kmajor_weight(out["wq"]["q"])
    if "b" in p:
        out["b"] = p["b"]
    return out


def quantize_vit_params(vit_params: Params) -> Params:
    """Quantize every transformer-block linear; embeddings and norms stay f32."""
    qblocks = [{
        "norm1": blk["norm1"],
        "attn": {"qkv": quantize_linear_params(blk["attn"]["qkv"]),
                 "proj": quantize_linear_params(blk["attn"]["proj"])},
        "norm2": blk["norm2"],
        "mlp": {"fc1": quantize_linear_params(blk["mlp"]["fc1"]),
                "fc2": quantize_linear_params(blk["mlp"]["fc2"])},
    } for blk in vit_params["blocks"]]
    return {"patch_embed": vit_params["patch_embed"], "pos_embed": vit_params["pos_embed"],
            "blocks": qblocks, "last_norm": vit_params["last_norm"]}


def default_fused(tok: torch.Tensor, cfg) -> bool:
    """Whether the int8 blocks take the kernels when neither the caller nor
    ``cfg.fused_attn`` says: where the tokens are on CUDA (JAX: on a TPU),
    unless HYT_INT8_FUSED is "0"."""
    if cfg.fused_attn is not None:
        return cfg.fused_attn
    return tok.is_cuda and os.environ.get("HYT_INT8_FUSED", "1") != "0"


def _attn_math(qkv: torch.Tensor, num_heads: int, kernels: Optional[bool] = None) -> torch.Tensor:
    """(B, N, 3D) -> (B, N, D) pre-proj attention. HYT_ATTN unset: K7 where
    ``kernels`` (None: qkv is on the card; JAX's accelerator default,
    "pallas_direct"), the einsum elsewhere. HYT_ATTN set: that form where
    softmax_attention_qkv has it ("pallas" and "auto" included), else the
    einsum."""
    env = os.environ.get("HYT_ATTN")
    if env is None:
        kernels = qkv.is_cuda if kernels is None else kernels
        force = "pallas_direct" if kernels else "xla"
    else:
        force = env if env in ATTN_FORCES else "xla"
    return softmax_attention_qkv(qkv, num_heads, force=force)


def int8_mha_self_attention(p: Params, x: torch.Tensor, num_heads: int) -> torch.Tensor:
    """nn.mha_self_attention over int8-quantized params."""
    qkv = int8_linear(p["qkv"]["wq"], x, p["qkv"].get("b"), p["qkv"].get("sx"))
    out = _attn_math(qkv, num_heads)
    return int8_linear(p["proj"]["wq"], out, p["proj"].get("b"), p["proj"].get("sx"))


def int8_mlp_gelu(p: Params, x: torch.Tensor) -> torch.Tensor:
    h = nn.gelu(int8_linear(p["fc1"]["wq"], x, p["fc1"].get("b"), p["fc1"].get("sx")))
    return int8_linear(p["fc2"]["wq"], h, p["fc2"].get("b"), p["fc2"].get("sx"))


def collect_vit_act_stats(params_q: Params, x: torch.Tensor, cfg) -> Params:
    """Calibration pass: the absmax of every quantized GEMM's input (post-LN
    for qkv and fc1, the attention output for proj, post-GELU for fc2),
    through the unfused int8 forward. ``x`` is the backbone input (the
    256x192 crop). Returns {"blocks": [{"qkv", "proj", "fc1", "fc2"}: ()
    f32]}; reduce batches with ``max_act_stats``."""
    from hamer_yolo_tpu_torch.models.vit import embed_tokens

    def amax(t):
        return torch.amax(torch.abs(t.float()))

    tok = embed_tokens(params_q, x, cfg)
    stats = []
    for blk in params_q["blocks"]:
        s = {}
        h = nn.layer_norm(blk["norm1"], tok)
        s["qkv"] = amax(h)
        p = blk["attn"]
        ao = _attn_math(int8_linear(p["qkv"]["wq"], h, p["qkv"].get("b")), cfg.num_heads)
        s["proj"] = amax(ao)
        tok = tok + int8_linear(p["proj"]["wq"], ao, p["proj"].get("b"))
        h2 = nn.layer_norm(blk["norm2"], tok)
        s["fc1"] = amax(h2)
        m = blk["mlp"]
        g = nn.gelu(int8_linear(m["fc1"]["wq"], h2, m["fc1"].get("b")))
        s["fc2"] = amax(g)
        tok = tok + int8_linear(m["fc2"]["wq"], g, m["fc2"].get("b"))
        stats.append(s)
    return {"blocks": stats}


def max_act_stats(a: Params, b: Params) -> Params:
    """Elementwise max of two stats trees (reduction over batches)."""
    return {"blocks": [{k: torch.maximum(x[k], y[k].to(x[k].device)) for k in x}
                       for x, y in zip(a["blocks"], b["blocks"])]}


def attach_static_act_scales(params_q: Params, stats: Params, margin: float = 1.0) -> Params:
    """Attach calibrated per-tensor activation scales "sx" = max(absmax *
    margin / 127, 1e-8) to quantized ViT params; every int8 path then skips
    its dynamic absmax. The scales are f32 scalars on the device of each
    block's weights."""
    def scale(a, like):
        a = torch.as_tensor(a, dtype=torch.float32, device=like.device)
        return torch.clamp(_div127(a * margin), min=1e-8)

    qblocks = []
    for blk, s in zip(params_q["blocks"], stats["blocks"]):
        like = blk["attn"]["qkv"]["wq"]["scale"]
        attn = {k: {**blk["attn"][k], "sx": scale(s[k], like)} for k in ("qkv", "proj")}
        mlp = {k: {**blk["mlp"][k], "sx": scale(s[k], like)} for k in ("fc1", "fc2")}
        qblocks.append({**blk, "attn": attn, "mlp": mlp})
    return {**params_q, "blocks": qblocks}


def save_act_stats(path: str, stats: Params) -> None:
    """collect_vit_act_stats output -> a flat .npz (``blk{i:02d}_{k}``), the
    JAX package's format."""
    flat = {f"blk{i:02d}_{k}": np.asarray(torch.as_tensor(v).detach().cpu().numpy(), np.float32)
            for i, s in enumerate(stats["blocks"]) for k, v in s.items()}
    np.savez(path, **flat)


def load_act_stats(path: str, device="cpu") -> Params:
    """Inverse of save_act_stats."""
    z = np.load(path)
    n = max(int(k[3:5]) for k in z.files) + 1
    return {"blocks": [{k.split("_", 1)[1]: torch.from_numpy(np.asarray(z[k], np.float32))
                        .to(device) for k in z.files if k.startswith(f"blk{i:02d}_")}
                       for i in range(n)]}


# ---------------------------------------------------------------- dispatch
def int8_block_attn_fused(blk: Params, tok: torch.Tensor, num_heads: int) -> torch.Tensor:
    """LN(norm1) + qkv + attention + proj on the kernels, without the
    residual, by JAX's decision tree (the module docstring has the switches):
    K6 + the pre-quantized proj product; or K5 (LN prologue), the attention
    (K7 or K8 with the int8 epilogue where the proj scale is static and
    HYT_ATTN_PREQUANT is not 0, then the pre-quantized product; else K7, K8
    or the einsum, then K5)."""
    p = blk["attn"]
    sx_qkv, sx_proj = p["qkv"].get("sx"), p["proj"].get("sx")
    env = os.environ.get("HYT_ATTN")
    if env in ("pallas_direct", "pallas_fusedqkv", "megakernel"):
        kern = env
    elif env is None:
        kern = "megakernel" if sx_qkv is not None and sx_proj is not None else "pallas_direct"
    else:
        kern = None
    prequant = (sx_proj is not None and kern is not None
                and os.environ.get("HYT_ATTN_PREQUANT") != "0")
    proj = (p["proj"]["wq"]["q"], p["proj"]["wq"]["scale"], p["proj"].get("b"))
    if prequant and kern == "megakernel" and sx_qkv is not None:
        aq = fused_int8_attn_block(tok, p["qkv"]["wq"]["q"], p["qkv"]["wq"]["scale"],
                                   p["qkv"].get("b"), blk["norm1"]["scale"],
                                   blk["norm1"]["bias"], sx_qkv, sx_proj, num_heads)
        return int8_dot_prequant(aq, *proj, sx_proj, out_dtype=tok.dtype)
    qkv = fused_int8_matmul(tok, p["qkv"]["wq"]["q"], p["qkv"]["wq"]["scale"],
                            p["qkv"].get("b"), blk["norm1"]["scale"], blk["norm1"]["bias"],
                            prologue="ln", static_scale=sx_qkv)
    if prequant:
        aq = softmax_attention_qkv(qkv, num_heads, out_scale=sx_proj,
                                   force="pallas_direct" if kern == "megakernel" else kern)
        return int8_dot_prequant(aq, *proj, sx_proj, out_dtype=tok.dtype)
    out = _attn_math(qkv, num_heads, kernels=True)
    return fused_int8_matmul(out, *proj, prologue="id", static_scale=sx_proj)


def int8_block_attn_residual(blk: Params, tok: torch.Tensor, num_heads: int) -> torch.Tensor:
    """tok + attention block: K3 with both static scales under HYT_ATTN unset
    or "megaproj" (and HYT_ATTN_PREQUANT not 0), its softmax flavour and
    attention products from HYT_SOFTMAX and HYT_ATTN_MATH; else
    tok + int8_block_attn_fused."""
    p = blk["attn"]
    sx_qkv, sx_proj = p["qkv"].get("sx"), p["proj"].get("sx")
    if (os.environ.get("HYT_ATTN") in (None, "megaproj") and sx_qkv is not None
            and sx_proj is not None and os.environ.get("HYT_ATTN_PREQUANT") != "0"):
        return fused_int8_attn_proj_block(
            tok, p["qkv"]["wq"]["q"], p["qkv"]["wq"]["scale"], p["qkv"].get("b"),
            blk["norm1"]["scale"], blk["norm1"]["bias"], sx_qkv, sx_proj,
            p["proj"]["wq"]["q"], p["proj"]["wq"]["scale"], p["proj"].get("b"), num_heads,
            softmax=softmax_flavor(), attn_math=attn_math_flavor())
    return tok + int8_block_attn_fused(blk, tok, num_heads)


def int8_block_mlp_fused(blk: Params, tok: torch.Tensor, gelu: str = "gelu") -> torch.Tensor:
    """LN(norm2) + fc1 + GELU + fc2 on K5 twice (LN fused into fc1's
    quantize, the GELU into fc2's), without the residual."""
    p = blk["mlp"]
    h = fused_int8_matmul(tok, p["fc1"]["wq"]["q"], p["fc1"]["wq"]["scale"], p["fc1"].get("b"),
                          blk["norm2"]["scale"], blk["norm2"]["bias"], prologue="ln",
                          static_scale=p["fc1"].get("sx"))
    return fused_int8_matmul(h, p["fc2"]["wq"]["q"], p["fc2"]["wq"]["scale"], p["fc2"].get("b"),
                             prologue=gelu, static_scale=p["fc2"].get("sx"))


def int8_block_mlp_residual(blk: Params, tok: torch.Tensor, gelu: str = "gelu") -> torch.Tensor:
    """tok + MLP block: with both static scales K4 (HYT_INT8_MLP unset or
    "megakernel") or K10 ("megakernel1"), else tok + int8_block_mlp_fused."""
    env = os.environ.get("HYT_INT8_MLP")
    m = blk["mlp"]
    if (env in (None, "megakernel", "megakernel1") and m["fc1"].get("sx") is not None
            and m["fc2"].get("sx") is not None):
        args = (tok, m["fc1"]["wq"]["q"], m["fc1"]["wq"]["scale"], m["fc1"].get("b"),
                m["fc2"]["wq"]["q"], m["fc2"]["wq"]["scale"], m["fc2"].get("b"),
                blk["norm2"]["scale"], blk["norm2"]["bias"], m["fc1"]["sx"], m["fc2"]["sx"])
        if env == "megakernel1":
            return fused_int8_mlp_block1(*args, gelu=gelu,
                                         hc=int(os.environ.get("HYT_INT8_MLP_HC", "1280")))
        return fused_int8_mlp_block(*args, gelu=gelu)
    return tok + int8_block_mlp_fused(blk, tok, gelu)


def vit_forward_int8(params_q: Params, x: torch.Tensor, cfg, fused: Optional[bool] = None,
                     gelu: Optional[str] = None) -> torch.Tensor:
    """models/vit.vit_forward over quantize_vit_params output.

    ``fused``: the kernels (None: ``default_fused``) or the unfused
    composition.
    ``gelu``: the MLP kernels' GELU, "gelu" or "gelu_poly"; None takes the
    polynomial on the card and the exact form elsewhere, as JAX's
    gelu_prologue picks on and off the TPU.
    """
    from hamer_yolo_tpu_torch.models.vit import embed_tokens

    return vit_blocks_int8(params_q, embed_tokens(params_q, x, cfg), cfg, fused, gelu)


def vit_blocks_int8(params_q: Params, tok: torch.Tensor, cfg, fused: Optional[bool] = None,
                    gelu: Optional[str] = None) -> torch.Tensor:
    """The blocks and the last LayerNorm of vit_forward_int8, from the
    embedded tokens (B, N, D)."""
    if fused is None:
        fused = default_fused(tok, cfg)
    gelu = gelu or gelu_prologue(tok.device)
    for blk in params_q["blocks"]:
        if fused:
            tok = int8_block_attn_residual(blk, tok, cfg.num_heads)
            tok = int8_block_mlp_residual(blk, tok, gelu)
        else:
            tok = tok + int8_mha_self_attention(blk["attn"], nn.layer_norm(blk["norm1"], tok),
                                                cfg.num_heads)
            tok = tok + int8_mlp_gelu(blk["mlp"], nn.layer_norm(blk["norm2"], tok))
    return nn.layer_norm(params_q["last_norm"], tok)


# ------------------------------------------------------------ the detector
def quantize_conv_weight(w: torch.Tensor) -> Dict[str, torch.Tensor]:
    """(O, C, kh, kw) f32 -> {q int8 (O, C, kh, kw), scale (O,) f32}, per
    output channel."""
    absmax = torch.amax(torch.abs(w), dim=(1, 2, 3))
    scale = torch.clamp(_div127(absmax), min=1e-8)
    q = torch.clamp(torch.round(w / scale[:, None, None, None]), -127, 127).to(torch.int8)
    return {"q": q, "scale": scale.float()}


def quantize_conv_tree(tree: Any, only_1x1: bool = False) -> Any:
    """W8A8 every conv ({"w": 4-d, ...}) of a tree, recursively; with
    ``only_1x1`` only the pointwise ones. Linears and norms stay as they are."""
    if isinstance(tree, dict):
        w = tree.get("w")
        if isinstance(w, torch.Tensor) and w.ndim == 4:
            if only_1x1 and w.shape[2:] != (1, 1):
                return tree
            return {**tree, "w": quantize_conv_weight(w)}
        return {k: quantize_conv_tree(v, only_1x1) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(quantize_conv_tree(v, only_1x1) for v in tree)
    return tree


def quantize_yolo_params(params: Params, quant_detect: bool = False,
                         only_1x1: bool = True) -> Params:
    """W8A8 the detector's convs (``only_1x1``: the pointwise ones, JAX's
    default; else every conv). The last layer, the detect / bin / keypoint
    head, keeps its f32 weights unless ``quant_detect``."""
    layers = params["layers"]
    qlayers = [quantize_conv_tree(layer, only_1x1) for layer in layers[:-1]]
    qlayers.append(quantize_conv_tree(layers[-1], only_1x1) if quant_detect else layers[-1])
    return {**params, "layers": qlayers}


def calibrate_yolo_act_scales(params_q: Params, images, cfg=None, spec=None) -> Params:
    """Static per-tensor activation scales for a quantize_yolo_params tree:
    runs the int8 forward eagerly over ``images`` ((H, W, 3) RGB frames in
    [0, 1] at the detector's input size), one frame a call, on the tree's
    device, recording each int8 conv's input absmax (core/int8_conv.
    record_conv_absmax), so the statistics see the quantized upstream
    activations. Returns the tree with "sx" = max(absmax / 127, 1e-8), an
    f32 scalar, on every conv that ran; raises where none did."""
    from hamer_yolo_tpu_torch.core.int8_conv import record_conv_absmax
    from hamer_yolo_tpu_torch.models.yolov7.model import YoloConfig, yolov7_forward

    cfg = cfg or YoloConfig()
    device = next(t.device for layer in params_q["layers"] if layer is not None
                  for t in _tensors(layer))
    with torch.no_grad(), record_conv_absmax() as stats:
        for img in images:
            x = torch.as_tensor(np.asarray(img, np.float32), device=device)[None]
            yolov7_forward(params_q, x, cfg, spec)
    if not stats:
        raise RuntimeError("calibration saw no quantized conv: pass a quantize_yolo_params tree")

    def attach(tree):
        if isinstance(tree, dict):
            w = tree.get("w")
            if isinstance(w, dict) and w["q"] in stats:
                sx = np.float32(max(stats[w["q"]] / 127.0, 1e-8))
                return {**tree, "sx": torch.tensor(sx, device=w["q"].device)}
            return {k: attach(v) for k, v in tree.items()}
        if isinstance(tree, (list, tuple)):
            return type(tree)(attach(v) for v in tree)
        return tree

    return attach(params_q)


def _tensors(tree: Any):
    """The tensors of a tree, depth first."""
    if isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, dict):
        for v in tree.values():
            yield from _tensors(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _tensors(v)
