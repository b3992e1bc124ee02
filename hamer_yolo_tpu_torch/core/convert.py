"""The reference's torch checkpoints -> parameter trees in JAX layout (port of
hamer_yolo_tpu/core/convert.py: the YOLOv7, HaMeR, SAR and KPFusion
converters, and the eight of KeypointFusion's pointNet zoo).

Converters for the reference's model files, ``yolov7_best.pt``,
``hamer.ckpt``, ``SAR-resnet34-Root.pth`` and KPFusion's ``.pth``
(``convert_kpfusion_checkpoint``; also its centerNet head). Every step is numpy arithmetic
in float32, the same steps in the same order as the JAX package's, so the
trees come out leaf for leaf equal to JAX's; torch only deserializes. The
trees are what ``core/bridge.from_jax_params`` reads and what
``core/checkpoint.save_checkpoint`` writes; the zoo's converters hand that
tree through the bridge themselves and return the port's tensors.

Layouts: torch conv OIHW -> HWIO; torch linear (out, in) -> (in, out); BN
folded into the conv before it; YOLO's RepConv and OREPA branches fused into
one 3x3 conv; IDetect's ImplicitA/M fused into the head convs (the
reference's IDetect.fuse); HaMeR's fused qkv keeps torch's [q; k; v] rows.
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

import numpy as np

from hamer_yolo_tpu_torch.core.bridge import from_jax_params
from hamer_yolo_tpu_torch.geometry.affine import resize_weights
from hamer_yolo_tpu_torch.models.yolov7 import model as M


def load_torch_state_dict(path: str, key: Optional[str] = None) -> Dict[str, np.ndarray]:
    """A torch checkpoint -> {name: numpy array}: ``ckpt[key]`` where the
    file is a dict holding ``key``; a pickled ``nn.Module`` gives its float
    state dict."""
    import torch

    ckpt = torch.load(path, map_location="cpu", weights_only=False)
    if key is not None and isinstance(ckpt, dict) and key in ckpt:
        ckpt = ckpt[key]
    if hasattr(ckpt, "state_dict"):  # a whole nn.Module, as yolov7 saves it
        ckpt = ckpt.float().state_dict()
    return {k: np.asarray(v.detach().cpu().numpy() if hasattr(v, "detach") else v)
            for k, v in ckpt.items()}


def conv_w(w: np.ndarray) -> np.ndarray:
    """OIHW -> HWIO."""
    return np.transpose(w, (2, 3, 1, 0))


def linear_w(w: np.ndarray) -> np.ndarray:
    """(out, in) -> (in, out)."""
    return np.transpose(w)


def fold_conv_bn(sd, conv_key: str, bn_key: str, eps: float = 1e-3) -> Dict[str, np.ndarray]:
    """conv (no bias) + BN -> {w (HWIO), b}."""
    w = conv_w(sd[f"{conv_key}.weight"])
    gamma, beta = sd[f"{bn_key}.weight"], sd[f"{bn_key}.bias"]
    mean, var = sd[f"{bn_key}.running_mean"], sd[f"{bn_key}.running_var"]
    scale = gamma / np.sqrt(var + eps)
    return {"w": w * scale[None, None, None, :], "b": beta - mean * scale}


# ---------------------------------------------------------------------------
# YOLOv7
# ---------------------------------------------------------------------------

def _convert_conv_block(sd, prefix: str, eps: float = 1e-3) -> Dict[str, Any]:
    if f"{prefix}.bn.weight" in sd:
        return {"conv": fold_conv_bn(sd, f"{prefix}.conv", f"{prefix}.bn", eps)}
    p = {"w": conv_w(sd[f"{prefix}.conv.weight"])}
    if f"{prefix}.conv.bias" in sd:
        p["b"] = sd[f"{prefix}.conv.bias"]
    return {"conv": p}


def _convert_repconv(sd, prefix: str) -> Dict[str, Any]:
    if f"{prefix}.rbr_reparam.weight" in sd:  # already deploy-fused
        return {"reparam": {"w": conv_w(sd[f"{prefix}.rbr_reparam.weight"]),
                            "b": sd[f"{prefix}.rbr_reparam.bias"]}}
    dense = fold_conv_bn(sd, f"{prefix}.rbr_dense.0", f"{prefix}.rbr_dense.1", eps=1e-3)
    one = fold_conv_bn(sd, f"{prefix}.rbr_1x1.0", f"{prefix}.rbr_1x1.1", eps=1e-3)
    w = dense["w"] + np.pad(one["w"], ((1, 1), (1, 1), (0, 0), (0, 0)))
    b = dense["b"] + one["b"]
    if f"{prefix}.rbr_identity.weight" in sd:
        c = w.shape[3]
        gamma = sd[f"{prefix}.rbr_identity.weight"]
        beta = sd[f"{prefix}.rbr_identity.bias"]
        mean = sd[f"{prefix}.rbr_identity.running_mean"]
        var = sd[f"{prefix}.rbr_identity.running_var"]
        scale = gamma / np.sqrt(var + 1e-3)
        ident = np.zeros((3, 3, c, c), np.float32)
        ident[1, 1, np.arange(c), np.arange(c)] = 1.0
        w = w + ident * scale[None, None, None, :]
        b = b + beta - mean * scale
    return {"reparam": {"w": w, "b": b}}


def _convert_sppcspc(sd, prefix: str) -> Dict[str, Any]:
    return {f"cv{i}": _convert_conv_block(sd, f"{prefix}.cv{i}") for i in range(1, 8)}


def _convert_ghost_conv(sd, prefix: str) -> Dict[str, Any]:
    return {"cv1": _convert_conv_block(sd, f"{prefix}.cv1"),
            "cv2": _convert_conv_block(sd, f"{prefix}.cv2")}


def _convert_ghost_bottleneck(sd, prefix: str) -> Dict[str, Any]:
    p = {"g1": _convert_ghost_conv(sd, f"{prefix}.conv.0"),
         "g2": _convert_ghost_conv(sd, f"{prefix}.conv.2")}
    if f"{prefix}.conv.1.conv.weight" in sd:  # the stride-2 form
        p["dw"] = _convert_conv_block(sd, f"{prefix}.conv.1")
        p["sc_dw"] = _convert_conv_block(sd, f"{prefix}.shortcut.0")
        p["sc_pw"] = _convert_conv_block(sd, f"{prefix}.shortcut.1")
    return p


def _convert_ghost_csp(sd, prefix: str, variant: str) -> Dict[str, Any]:
    n_cv = 4 if variant == "c" else 3
    p = {f"cv{i}": _convert_conv_block(sd, f"{prefix}.cv{i}") for i in range(1, n_cv + 1)}
    p["m"] = []
    i = 0
    while f"{prefix}.m.{i}.conv.0.cv1.conv.weight" in sd:
        p["m"].append(_convert_ghost_bottleneck(sd, f"{prefix}.m.{i}"))
        i += 1
    return p


def _convert_ghost_sppcspc(sd, prefix: str) -> Dict[str, Any]:
    return {f"cv{i}": _convert_ghost_conv(sd, f"{prefix}.cv{i}") for i in range(1, 8)}


def _convert_stem(sd, prefix: str) -> Dict[str, Any]:
    ghost = f"{prefix}.cv1.cv1.conv.weight" in sd
    conv = _convert_ghost_conv if ghost else _convert_conv_block
    return {f"cv{i}": conv(sd, f"{prefix}.cv{i}") for i in range(1, 5)}


def _convert_swin_block(sd, prefix: str) -> Dict[str, Any]:
    p: Dict[str, Any] = {"layers": []}
    if f"{prefix}.conv.conv.weight" in sd:
        p["conv"] = _convert_conv_block(sd, f"{prefix}.conv")
    i = 0
    while f"{prefix}.blocks.{i}.norm1.weight" in sd:
        b = f"{prefix}.blocks.{i}"
        p["layers"].append({
            "norm1": {"scale": sd[f"{b}.norm1.weight"], "bias": sd[f"{b}.norm1.bias"]},
            "attn": {
                "qkv": {"w": linear_w(sd[f"{b}.attn.qkv.weight"]), "b": sd[f"{b}.attn.qkv.bias"]},
                "proj": {"w": linear_w(sd[f"{b}.attn.proj.weight"]),
                         "b": sd[f"{b}.attn.proj.bias"]},
                "rpb": sd[f"{b}.attn.relative_position_bias_table"],
            },
            "norm2": {"scale": sd[f"{b}.norm2.weight"], "bias": sd[f"{b}.norm2.bias"]},
            "mlp": {"fc1": {"w": linear_w(sd[f"{b}.mlp.fc1.weight"]), "b": sd[f"{b}.mlp.fc1.bias"]},
                    "fc2": {"w": linear_w(sd[f"{b}.mlp.fc2.weight"]),
                            "b": sd[f"{b}.mlp.fc2.bias"]}},
        })
        i += 1
    return p


def _convert_stcsp(sd, prefix: str, variant: str) -> Dict[str, Any]:
    n_cv = 4 if variant == "c" else 3
    p = {f"cv{i}": _convert_conv_block(sd, f"{prefix}.cv{i}") for i in range(1, n_cv + 1)}
    p["m"] = _convert_swin_block(sd, f"{prefix}.m")
    return p


def _convert_orepa(sd, prefix: str, eps: float = 1e-3) -> Dict[str, Any]:
    """RepConv_OREPA -> one fused 3x3 conv: the reference's switch_to_deploy,
    its five dense branches (origin, avg, prior, 1x1-kxk, depthwise-separable)
    summed, BN folded, the 1x1 branch and the identity BN added."""
    if f"{prefix}.rbr_reparam.weight" in sd:  # already deployed
        return {"reparam": {"w": conv_w(sd[f"{prefix}.rbr_reparam.weight"]),
                            "b": sd[f"{prefix}.rbr_reparam.bias"]}}
    d = f"{prefix}.rbr_dense"
    vec = sd[f"{d}.vector"]  # (5, out)

    def scale_o(w, v):
        return w * v[:, None, None, None]

    w_origin = scale_o(sd[f"{d}.weight_rbr_origin"], vec[0])
    w_avg = scale_o(sd[f"{d}.weight_rbr_avg_conv"] * sd[f"{d}.weight_rbr_avg_avg"][None, None],
                    vec[1])
    w_pfir = scale_o(sd[f"{d}.weight_rbr_pfir_conv"] * sd[f"{d}.weight_rbr_prior"][:, None],
                     vec[2])
    if f"{d}.weight_rbr_1x1_kxk_idconv1" in sd:
        c1x1 = (sd[f"{d}.weight_rbr_1x1_kxk_idconv1"]
                + sd[f"{d}.id_tensor"]).squeeze(-1).squeeze(-1)
    else:
        c1x1 = sd[f"{d}.weight_rbr_1x1_kxk_conv1"].squeeze(-1).squeeze(-1)
    c2kxk = sd[f"{d}.weight_rbr_1x1_kxk_conv2"]
    w_1x1_kxk = scale_o(np.einsum("ti,othw->oihw", c1x1, c2kxk), vec[3])
    dw = sd[f"{d}.weight_rbr_gconv_dw"]  # (in * 8, 1, k, k)
    pw = sd[f"{d}.weight_rbr_gconv_pw"]  # (out, in * 8, 1, 1)
    cin = dw.shape[0] // 8
    # the depthwise-separable pair as one dense kernel, groups = in channels
    w_gconv = np.einsum("gtihw,ogt->ogihw",
                        dw.reshape(cin, 8, 1, dw.shape[2], dw.shape[3]),
                        pw.squeeze(-1).squeeze(-1).reshape(pw.shape[0], cin, 8))
    w_gconv = scale_o(w_gconv.reshape(pw.shape[0], cin, dw.shape[2], dw.shape[3]), vec[4])
    kernel_dense = w_origin + w_avg + w_pfir + w_1x1_kxk + w_gconv

    def fold(kernel, bnp):
        gamma, beta = sd[f"{bnp}.weight"], sd[f"{bnp}.bias"]
        mean, var = sd[f"{bnp}.running_mean"], sd[f"{bnp}.running_var"]
        t = gamma / np.sqrt(var + eps)
        return kernel * t[:, None, None, None], beta - mean * t

    k3, b3 = fold(kernel_dense, f"{d}.bn")
    k1, b1 = fold(sd[f"{prefix}.rbr_1x1.conv.weight"], f"{prefix}.rbr_1x1.bn")
    k = k3 + np.pad(k1, ((0, 0), (0, 0), (1, 1), (1, 1)))
    b = b3 + b1
    if f"{prefix}.rbr_identity.weight" in sd:
        c = k.shape[0]
        ident = np.zeros_like(k3)
        ident[np.arange(c), np.arange(c) % k.shape[1], 1, 1] = 1.0
        ki, bi = fold(ident, f"{prefix}.rbr_identity")
        k = k + ki
        b = b + bi
    return {"reparam": {"w": conv_w(k), "b": b}}


def _convert_detect(sd, prefix: str, n_heads: int = 3) -> Dict[str, Any]:
    """Detect / IDetect head: 1x1 convs, ImplicitA/M fused in."""
    heads: List[Dict[str, np.ndarray]] = []
    has_implicit = f"{prefix}.ia.0.implicit" in sd
    for j in range(n_heads):
        w = sd[f"{prefix}.m.{j}.weight"]  # (out, in, 1, 1)
        b = sd[f"{prefix}.m.{j}.bias"]
        if has_implicit:
            ia = sd[f"{prefix}.ia.{j}.implicit"][0, :, 0, 0]  # (in,)
            im = sd[f"{prefix}.im.{j}.implicit"][0, :, 0, 0]  # (out,)
            b = b + (w[:, :, 0, 0] @ ia)
            b = b * im
            w = w * im[:, None, None, None]
        heads.append({"w": conv_w(w), "b": b})
    return {"m": heads}


def _convert_keypoint(sd, prefix: str, n_heads: int = 3) -> Dict[str, Any]:
    """IKeypoint: the detect convs with ImplicitA/M fused (IDetect's algebra)
    and one plain keypoint conv a level (the dw_conv_kpt stack raises: no
    reference config uses it)."""
    det = _convert_detect(sd, prefix, n_heads)
    if f"{prefix}.m_kpt.0.0.conv.weight" in sd:
        raise NotImplementedError("dw_conv_kpt IKeypoint variant")
    det["m_kpt"] = [{"w": conv_w(sd[f"{prefix}.m_kpt.{j}.weight"]),
                     "b": sd[f"{prefix}.m_kpt.{j}.bias"]} for j in range(n_heads)]
    return det


_VARIANT_CONVERTERS = {
    "GHOSTC": _convert_ghost_conv, "GHOST": _convert_ghost_bottleneck,
    "GSPP": _convert_ghost_sppcspc, "STEM": _convert_stem, "GSTEM": _convert_stem,
    "SWINB": _convert_swin_block,
}


def convert_yolov7_state_dict(sd: Dict[str, np.ndarray], spec=None) -> Dict[str, Any]:
    """A yolov7 state dict, training form (IDetect / IBin / IKeypoint,
    RepConv branches, BN) or deploy form, -> the deploy tree of ``spec``
    (default: the built-in deploy yolov7; pass ``yaml_spec`` output for
    other family members). Layers without parameters, and DownC as in JAX,
    are None."""
    spec = spec if spec is not None else M.yolov7_spec()
    layers: List[Any] = []
    for i, (frm, op, _) in enumerate(spec):
        prefix = f"model.{i}"
        n_heads = len(frm) if isinstance(frm, tuple) else 1
        if op == M.C:
            layers.append(_convert_conv_block(sd, prefix))
        elif op == M.SPP:
            layers.append(_convert_sppcspc(sd, prefix))
        elif op == M.REP:
            if f"{prefix}.rbr_dense.weight_rbr_origin" in sd:
                layers.append(_convert_orepa(sd, prefix))  # RepConv_OREPA
            else:
                layers.append(_convert_repconv(sd, prefix))
        elif op in _VARIANT_CONVERTERS:
            layers.append(_VARIANT_CONVERTERS[op](sd, prefix))
        elif op in ("GCSPA", "GCSPB", "GCSPC"):
            layers.append(_convert_ghost_csp(sd, prefix, op[-1].lower()))
        elif op in ("STCSPA", "STCSPB", "STCSPC"):
            layers.append(_convert_stcsp(sd, prefix, op[-1].lower()))
        elif op in (M.DET, M.BIN):
            layers.append(_convert_detect(sd, prefix, n_heads))
        elif op == M.KPT:
            layers.append(_convert_keypoint(sd, prefix, n_heads))
        else:
            layers.append(None)
    return {"layers": layers}


# ---------------------------------------------------------------------------
# HaMeR (ViT-H + MANO head)
# ---------------------------------------------------------------------------

def resize_pos_embed(pos: np.ndarray, grid_hw: Tuple[int, int]) -> np.ndarray:
    """A (1, 1 + HW, D) learned position embedding resized bicubically onto
    the token grid ``grid_hw`` (the cls slot passes through), as the JAX
    package resizes it with ``jax.image.resize(..., "bicubic")``: Keys' cubic
    with a = -0.5 and antialiasing on a downscale, which torch's
    ``interpolate(mode="bicubic")`` (a = -0.75, no antialias) is not. The
    source grid must be square; the same grid returns ``pos`` itself."""
    h, w = grid_hw
    n = pos.shape[1] - 1
    if n == h * w:
        return pos
    side = int(round(float(n) ** 0.5))
    if side * side != n:
        raise ValueError(f"cannot infer source grid from {n} tokens")
    grid = np.asarray(pos[:, 1:], np.float32).reshape(side, side, -1)
    if h != side:
        grid = np.einsum("hwd,hH->Hwd", grid, resize_weights(side, h, "cubic"))
    if w != side:
        grid = np.einsum("hwd,wW->hWd", grid, resize_weights(side, w, "cubic"))
    return np.concatenate([np.asarray(pos[:, :1], np.float32),
                           grid.astype(np.float32).reshape(1, h * w, -1)], axis=1)


def convert_vit_state_dict(sd: Dict[str, np.ndarray], prefix: str = "backbone.",
                           depth: int = 32, grid_hw: Optional[Tuple[int, int]] = None
                           ) -> Dict[str, Any]:
    def g(k):
        return sd[prefix + k]

    pos = g("pos_embed")
    if grid_hw is not None:
        pos = resize_pos_embed(np.asarray(pos), grid_hw)
    params: Dict[str, Any] = {
        "patch_embed": {"w": conv_w(g("patch_embed.proj.weight")), "b": g("patch_embed.proj.bias")},
        "pos_embed": pos,
        "blocks": [],
        "last_norm": {"scale": g("last_norm.weight"), "bias": g("last_norm.bias")},
    }
    for i in range(depth):
        b = f"blocks.{i}."
        params["blocks"].append({
            "norm1": {"scale": g(b + "norm1.weight"), "bias": g(b + "norm1.bias")},
            "attn": {"qkv": {"w": linear_w(g(b + "attn.qkv.weight")), "b": g(b + "attn.qkv.bias")},
                     "proj": {"w": linear_w(g(b + "attn.proj.weight")),
                              "b": g(b + "attn.proj.bias")}},
            "norm2": {"scale": g(b + "norm2.weight"), "bias": g(b + "norm2.bias")},
            "mlp": {"fc1": {"w": linear_w(g(b + "mlp.fc1.weight")), "b": g(b + "mlp.fc1.bias")},
                    "fc2": {"w": linear_w(g(b + "mlp.fc2.weight")), "b": g(b + "mlp.fc2.bias")}},
        })
    return params


def convert_mano_head_state_dict(sd: Dict[str, np.ndarray], prefix: str = "mano_head.",
                                 depth: int = 6) -> Dict[str, Any]:
    def g(k):
        return sd[prefix + k]

    def lin(k, bias=True):
        p = {"w": linear_w(g(k + ".weight"))}
        if bias:
            p["b"] = g(k + ".bias")
        return p

    layers = []
    for i in range(depth):
        t = f"transformer.transformer.layers.{i}."
        # PreNorm-wrapped [self-attention, cross-attention, feed-forward]
        layers.append({
            "sa_norm": {"scale": g(t + "0.norm.weight"), "bias": g(t + "0.norm.bias")},
            "sa": {"qkv": lin(t + "0.fn.to_qkv", bias=False), "proj": lin(t + "0.fn.to_out.0")},
            "ca_norm": {"scale": g(t + "1.norm.weight"), "bias": g(t + "1.norm.bias")},
            "ca": {"to_q": lin(t + "1.fn.to_q", bias=False),
                   "to_kv": lin(t + "1.fn.to_kv", bias=False),
                   "proj": lin(t + "1.fn.to_out.0")},
            "ff_norm": {"scale": g(t + "2.norm.weight"), "bias": g(t + "2.norm.bias")},
            "ff": {"fc1": lin(t + "2.fn.net.0"), "fc2": lin(t + "2.fn.net.3")},
        })
    return {
        "token_embed": lin("transformer.to_token_embedding"),
        "pos_embed": g("transformer.pos_embedding"),
        "layers": layers,
        "decpose": lin("decpose"),
        "decshape": lin("decshape"),
        "deccam": lin("deccam"),
        "init_hand_pose": g("init_hand_pose"),
        "init_betas": g("init_betas"),
        "init_cam": g("init_cam"),
    }


def convert_hamer_checkpoint(path: str) -> Dict[str, Any]:
    """hamer.ckpt (a Lightning checkpoint) -> {"backbone", "mano_head"}."""
    sd = load_torch_state_dict(path, key="state_dict")
    return {"backbone": convert_vit_state_dict(sd, "backbone."),
            "mano_head": convert_mano_head_state_dict(sd, "mano_head.")}


# ---------------------------------------------------------------------------
# SAR / RootNet (ResNet-34 trunk)
# ---------------------------------------------------------------------------

def _bn(sd, prefix: str) -> Dict[str, np.ndarray]:
    return {"scale": sd[f"{prefix}.weight"], "bias": sd[f"{prefix}.bias"],
            "mean": sd[f"{prefix}.running_mean"], "var": sd[f"{prefix}.running_var"]}


def _convert_resnet_basic_block(sd, prefix: str) -> Dict[str, Any]:
    p = {"conv1": {"w": conv_w(sd[f"{prefix}.conv1.weight"])}, "bn1": _bn(sd, f"{prefix}.bn1"),
         "conv2": {"w": conv_w(sd[f"{prefix}.conv2.weight"])}, "bn2": _bn(sd, f"{prefix}.bn2")}
    if f"{prefix}.downsample.0.weight" in sd:
        p["down"] = {"w": conv_w(sd[f"{prefix}.downsample.0.weight"])}
        p["down_bn"] = _bn(sd, f"{prefix}.downsample.1")
    return p


def convert_sar_resnet34(sd: Dict[str, np.ndarray], prefix: str = "") -> Dict[str, Any]:
    """ResNet-34 keys in either layout: torchvision's (conv1, bn1,
    layer1..4) or SARresnet34's (extract_mid / extract_high Sequentials)."""
    def find(*cands):
        for c in cands:
            if prefix + c in sd:
                return prefix + c
        raise KeyError(cands)

    params: Dict[str, Any] = {
        "conv1": {"w": conv_w(sd[find("conv1.weight", "extract_mid.0.weight")])},
        "bn1": _bn(sd, find("bn1.weight", "extract_mid.1.weight")[:-7]),
        "stages": [],
    }
    layer_names = ["layer1", "layer2", "layer3", "layer4"]
    seq_names = ["extract_mid.4", "extract_mid.5", "extract_high.0.0", "extract_high.0.1"]
    for li, n in enumerate((3, 4, 6, 3)):
        blocks = []
        for b in range(n):
            try:
                blocks.append(_convert_resnet_basic_block(sd, prefix + f"{layer_names[li]}.{b}"))
            except KeyError:
                blocks.append(_convert_resnet_basic_block(sd, prefix + f"{seq_names[li]}.{b}"))
        params["stages"].append(blocks)
    return params


def _convert_sar_head(sd: Dict[str, np.ndarray], template: np.ndarray) -> Dict[str, Any]:
    def g(k):
        return sd["head." + k]

    def gc(prefix):  # GraphConv
        return {"fc": {"w": linear_w(g(prefix + ".fc.weight")), "b": g(prefix + ".fc.bias")},
                "adj": g(prefix + ".adj")}

    return {
        "saigb": {"group": {"w": conv_w(g("saigb.group.0.weight")), "b": g("saigb.group.0.bias")},
                  "template": np.asarray(template)},
        "reg_xy1": gc("gbbmr.reg_xy.0"),
        "reg_xy2": gc("gbbmr.reg_xy.3"),
        "reg_z1": gc("gbbmr.reg_z.0"),
        "reg_z2": gc("gbbmr.reg_z.3"),
        "mesh2pose_hm": {"w": linear_w(g("gbbmr.mesh2pose_hm.weight")),
                         "b": g("gbbmr.mesh2pose_hm.bias")},
        "mesh2pose_dm": {"w": linear_w(g("gbbmr.mesh2pose_dm.weight")),
                         "b": g("gbbmr.mesh2pose_dm.bias")},
        "soft_heatmap": {"beta": g("gbbmr.soft_heatmap.beta.weight")[:, 0, 0, 0]},
    }


def convert_sar_checkpoint(path: str, template: np.ndarray) -> Dict[str, Any]:
    """SAR-resnet34-Root.pth ({'network', 'rootnet'} state dicts, keys with
    or without a ``module.`` prefix) -> {"backbone", "head", "rootnet"}; the
    head keeps ``template``, the MANO model's (778, 3) v_template."""
    import torch

    ckpt = torch.load(path, map_location="cpu", weights_only=False)

    def strip(sd):
        return {(k[7:] if k.startswith("module.") else k): np.asarray(v.cpu().numpy())
                for k, v in sd.items()}

    net_sd, root_sd = strip(ckpt["network"]), strip(ckpt["rootnet"])
    return {"backbone": convert_sar_resnet34(net_sd, prefix="backbone."),
            "head": _convert_sar_head(net_sd, template),
            "rootnet": {"depth_layer": {"w": conv_w(root_sd["depth_layer.weight"]),
                                        "b": root_sd["depth_layer.bias"]}}}


def convert_pipeline_checkpoints(yolo_pt: Optional[str], hamer_ckpt: Optional[str],
                                 sar_pth: Optional[str], template: Optional[np.ndarray] = None
                                 ) -> Dict[str, Any]:
    """The reference's three files -> one pipeline tree {"yolo", "hamer",
    "sar"}; a path of None leaves its branch out. The yolov7 ``.pt`` pickles
    whole ``nn.Module`` objects (the reference's train.py format), so its
    classes must be importable to unpickle it; the EMA model is taken where
    the file has one, as the reference's attempt_load does. SAR needs the
    MANO ``template``."""
    params: Dict[str, Any] = {}
    if yolo_pt is not None:
        import torch

        ckpt = torch.load(yolo_pt, map_location="cpu", weights_only=False)
        module = ckpt["ema" if ckpt.get("ema") else "model"] if isinstance(ckpt, dict) else ckpt
        sd = {k: np.asarray(v.detach().cpu().float().numpy())
              for k, v in module.state_dict().items()}
        params["yolo"] = convert_yolov7_state_dict(sd)
    if hamer_ckpt is not None:
        params["hamer"] = convert_hamer_checkpoint(hamer_ckpt)
    if sar_pth is not None:
        if template is None:
            raise ValueError("SAR conversion needs the MANO template")
        params["sar"] = convert_sar_checkpoint(sar_pth, template)
    return params


# ---------------------------------------------------------------------------
# KeypointFusion RGB-D (models/kpfusion_rgbd)
# ---------------------------------------------------------------------------

def _kpf_bn(sd, prefix: str) -> Dict[str, np.ndarray]:
    return _bn(sd, prefix)


def _kpf_conv(sd, prefix: str, bias: bool) -> Dict[str, np.ndarray]:
    p = {"w": conv_w(sd[f"{prefix}.weight"])}
    if bias:
        p["b"] = sd[f"{prefix}.bias"]
    return p


def _convert_hg_residual(sd, prefix: str) -> Dict[str, Any]:
    """hourglass.Residual; its Conv wraps an nn.Conv2d as ``.conv`` with a bias."""
    p = {
        "bn1": _kpf_bn(sd, f"{prefix}.bn1"),
        "conv1": _kpf_conv(sd, f"{prefix}.conv1.conv", True),
        "bn2": _kpf_bn(sd, f"{prefix}.bn2"),
        "conv2": _kpf_conv(sd, f"{prefix}.conv2.conv", True),
        "bn3": _kpf_bn(sd, f"{prefix}.bn3"),
        "conv3": _kpf_conv(sd, f"{prefix}.conv3.conv", True),
    }
    # skip_layer is in the module even where it is unused; it is mapped only
    # where the widths differ
    w_in = sd[f"{prefix}.conv1.conv.weight"].shape[1]
    w_out = sd[f"{prefix}.conv3.conv.weight"].shape[0]
    if w_in != w_out:
        p["skip"] = _kpf_conv(sd, f"{prefix}.skip_layer.conv", True)
    return p


def _convert_kpf_resnet18(sd, prefix: str) -> Dict[str, Any]:
    p: Dict[str, Any] = {"conv1": {"w": conv_w(sd[f"{prefix}.conv1.weight"])},
                         "bn1": _kpf_bn(sd, f"{prefix}.bn1"), "stages": []}
    for li, n in enumerate((2, 2, 2, 2)):
        blocks = []
        for b in range(n):
            bp = f"{prefix}.layer{li + 1}.{b}"
            blk = {"conv1": {"w": conv_w(sd[f"{bp}.conv1.weight"])},
                   "bn1": _kpf_bn(sd, f"{bp}.bn1"),
                   "conv2": {"w": conv_w(sd[f"{bp}.conv2.weight"])},
                   "bn2": _kpf_bn(sd, f"{bp}.bn2")}
            if f"{bp}.downsample.0.weight" in sd:
                blk["down"] = {"w": conv_w(sd[f"{bp}.downsample.0.weight"])}
                blk["down_bn"] = _kpf_bn(sd, f"{bp}.downsample.1")
            blocks.append(blk)
        p["stages"].append(blocks)
    return p


def convert_kpf_unet(sd, prefix: str) -> Dict[str, Any]:
    """OfficialResNetUnet(_RGB2offset_3D) -> resunet parameters. ``up{n}`` is
    Sequential(Residual, Upsample), so its Residual is at ``.0``."""
    p: Dict[str, Any] = {
        "backbone": _convert_kpf_resnet18(sd, f"{prefix}.backbone"),
        "skip4": _convert_hg_residual(sd, f"{prefix}.skip_layer4"),
        "up4": _convert_hg_residual(sd, f"{prefix}.up4.0"),
        "fuse4": _convert_hg_residual(sd, f"{prefix}.fusion_layer4"),
        "skip3": _convert_hg_residual(sd, f"{prefix}.skip_layer3"),
        "up3": _convert_hg_residual(sd, f"{prefix}.up3.0"),
        "fuse3": _convert_hg_residual(sd, f"{prefix}.fusion_layer3"),
        "skip2": _convert_hg_residual(sd, f"{prefix}.skip_layer2"),
        "up2": _convert_hg_residual(sd, f"{prefix}.up2.0"),
        "fuse2": _convert_hg_residual(sd, f"{prefix}.fusion_layer2"),
        "finals": [],
    }
    i = 0
    while f"{prefix}.finals.{i}.weight" in sd:
        p["finals"].append(_kpf_conv(sd, f"{prefix}.finals.{i}", True))
        i += 1
    return p


def _conv1d_w(w: np.ndarray) -> np.ndarray:
    """torch Conv1d (out, in, 1) -> linear (in, out)."""
    return np.transpose(w[:, :, 0])


def _bn1d(sd, prefix: str) -> Dict[str, np.ndarray]:
    return _bn(sd, prefix)


def _convert_kpf_emb(sd, prefix: str) -> Dict[str, Any]:
    """nn.Sequential(Conv1d(k=1), BatchNorm1d)."""
    return {"conv": {"w": _conv1d_w(sd[f"{prefix}.0.weight"]), "b": sd[f"{prefix}.0.bias"]},
            "bn": _bn1d(sd, f"{prefix}.1")}


def _convert_desa(sd, prefix: str, n_scales: int = 3) -> Dict[str, Any]:
    def conv_bn(conv, bn):
        return {"conv": {"w": conv_w(sd[f"{conv}.weight"]), "b": sd[f"{conv}.bias"]},
                "bn": _bn(sd, bn)}

    scales = []
    for i in range(n_scales):
        sp = {"l0": conv_bn(f"{prefix}.conv_l0_blocks.{i}", f"{prefix}.bn_l0_blocks.{i}"),
              "f0": conv_bn(f"{prefix}.conv_f0_blocks.{i}", f"{prefix}.bn_f0_blocks.{i}"),
              "mlp": []}
        j = 0
        while f"{prefix}.conv_blocks.{i}.{j}.weight" in sd:
            sp["mlp"].append(conv_bn(f"{prefix}.conv_blocks.{i}.{j}",
                                     f"{prefix}.bn_blocks.{i}.{j}"))
            j += 1
        scales.append(sp)
    fusion_w = _conv1d_w(sd[f"{prefix}.fusion.0.weight"])[None, None]
    return {"scales": scales,
            "fusion": {"conv": {"w": fusion_w, "b": sd[f"{prefix}.fusion.0.bias"]},
                       "bn": _bn1d(sd, f"{prefix}.fusion.1")}}


def _kpf_linear(sd, prefix: str) -> Dict[str, np.ndarray]:
    return {"w": linear_w(sd[f"{prefix}.weight"]), "b": sd[f"{prefix}.bias"]}


def _kpf_ln(sd, prefix: str) -> Dict[str, np.ndarray]:
    return {"scale": sd[f"{prefix}.weight"], "bias": sd[f"{prefix}.bias"]}


def _convert_bert_encoder(sd, prefix: str, n_layers: int = 4) -> Dict[str, Any]:
    layers = []
    for i in range(n_layers):
        lp = f"{prefix}.encoder.layer.{i}"
        layers.append({
            "q": _kpf_linear(sd, f"{lp}.attention.self.query"),
            "k": _kpf_linear(sd, f"{lp}.attention.self.key"),
            "v": _kpf_linear(sd, f"{lp}.attention.self.value"),
            "attn_out": _kpf_linear(sd, f"{lp}.attention.output.dense"),
            "attn_ln": _kpf_ln(sd, f"{lp}.attention.output.LayerNorm"),
            "inter": _kpf_linear(sd, f"{lp}.intermediate.dense"),
            "out": _kpf_linear(sd, f"{lp}.output.dense"),
            "out_ln": _kpf_ln(sd, f"{lp}.output.LayerNorm"),
        })
    return {"pos_embed": sd[f"{prefix}.position_embeddings.weight"],
            "img_embed": _kpf_linear(sd, f"{prefix}.img_embedding"), "layers": layers}


def _convert_kp_interaction(sd, prefix: str, n_layers: int = 4) -> Dict[str, Any]:
    return {"bert": _convert_bert_encoder(sd, f"{prefix}.bert", n_layers),
            "cls_head": _kpf_linear(sd, f"{prefix}.cls_head"),
            "residual": _kpf_linear(sd, f"{prefix}.residual")}


def _convert_transfusion_decoder(sd, prefix: str, n_layers: int = 4) -> Dict[str, Any]:
    layers = []
    for i in range(n_layers):
        lp = f"{prefix}.decoder.{i}"
        p = {
            "attn": {"in_proj_w": linear_w(sd[f"{lp}.multihead_attn.in_proj_weight"]),
                     "in_proj_b": sd[f"{lp}.multihead_attn.in_proj_bias"],
                     "out_proj": _kpf_linear(sd, f"{lp}.multihead_attn.out_proj")},
            "linear1": _kpf_linear(sd, f"{lp}.linear1"),
            "linear2": _kpf_linear(sd, f"{lp}.linear2"),
            "norm2": _kpf_ln(sd, f"{lp}.norm2"),
            "norm3": _kpf_ln(sd, f"{lp}.norm3"),
        }
        for name in ("self_posembed", "cross_posembed"):
            if f"{lp}.{name}.weight" in sd:
                p[name] = sd[f"{lp}.{name}.weight"]
        layers.append(p)
    return {"layers": layers}


def _convert_kpf_block(sd, prefix: str) -> Dict[str, Any]:
    p: Dict[str, Any] = {name: _convert_kpf_emb(sd, f"{prefix}.{name}") for name in (
        "pcl_feat_emb", "pcl_xyz_emb", "pcl_pose_emb", "joint_feat_emb", "joint_xyz_emb",
        "pcl_feat_emb_RGB")}
    p.update({
        "FA": _convert_desa(sd, f"{prefix}.FA"),
        "init_TR": _convert_kp_interaction(sd, f"{prefix}.init_TR"),
        "final_TR": _convert_kp_interaction(sd, f"{prefix}.final_TR"),
        "crossTR": _convert_transfusion_decoder(sd, f"{prefix}.crossTR"),
        "atten_spatial": {"w": np.transpose(sd[f"{prefix}.atten_spatial.weight"][:, :, 0, 0]),
                          "b": sd[f"{prefix}.atten_spatial.bias"]},
        "fc_spatial": _kpf_linear(sd, f"{prefix}.fc_spatial2joint_feature"),
        "weight_dis": sd[f"{prefix}.weight_dis"],
    })
    return p


def convert_kpfusion_state_dict(sd: Dict[str, np.ndarray], prefix: str = "",
                                num_stages: int = 2) -> Dict[str, Any]:
    """KPFusion's state dict -> kpfusion_rgbd parameters (strip a
    DataParallel ``module.`` prefix first)."""
    return {
        "backbone_rgb": convert_kpf_unet(sd, f"{prefix}backbone_rgb"),
        "backbone_d": convert_kpf_unet(sd, f"{prefix}backbone_d"),
        "blocks": [_convert_kpf_block(sd, f"{prefix}block{i + 1}") for i in range(num_stages)],
    }


def convert_centernet(sd, prefix: str) -> Dict[str, Any]:
    """The centerNet ResNet-18 regression head."""
    return {"backbone": _convert_kpf_resnet18(sd, prefix),
            "fc": _kpf_linear(sd, f"{prefix}.fc")}


def convert_kpfusion_checkpoint(path: str, num_stages: int = 2) -> Dict[str, Any]:
    """A KPFusion .pth (Model_RGBD's format: {'model': state_dict}, keys with
    DataParallel's ``module.`` prefix) -> parameters."""
    sd = load_torch_state_dict(path, key="model")
    sd = {(k[7:] if k.startswith("module.") else k): v for k, v in sd.items()}
    return convert_kpfusion_state_dict(sd, num_stages=num_stages)


# ---------------------------------------------------------------------------
# KeypointFusion's pointNet zoo: BN folded into the linears, for the zoo's
# forwards in models/pointnet2.py. These return the port's tree itself
# (bridge.from_jax_params of the numpy tree: every leaf a linear's (in, out)
# weight, a bias or pointMLP's affine, so the layout is JAX's).
# ---------------------------------------------------------------------------

def _fold_bn_into_linear(w, bn_g, bn_b, bn_m, bn_v,
                         eps: float = 1e-5) -> Dict[str, np.ndarray]:
    """torch 1x1-conv/linear weight (out, in[, 1[, 1]]) + eval-mode BN ->
    our {"w" (in, out), "b"}: y = gamma*(Wx - mean)/sqrt(var+eps) + beta
    is an affine of Wx, foldable per output channel."""
    w = np.asarray(w, np.float32).reshape(np.asarray(w).shape[0], -1)
    scale = np.asarray(bn_g, np.float32) / np.sqrt(
        np.asarray(bn_v, np.float32) + eps)
    return {"w": np.ascontiguousarray((w * scale[:, None]).T),
            "b": (np.asarray(bn_b, np.float32)
                  - np.asarray(bn_m, np.float32) * scale)}


def _fold_bn_seq(sd: Dict[str, np.ndarray], prefix: str,
                 conv_idx, bn_idx) -> Dict[str, np.ndarray]:
    return _fold_bn_into_linear(
        sd[f"{prefix}.{conv_idx}.weight"], sd[f"{prefix}.{bn_idx}.weight"],
        sd[f"{prefix}.{bn_idx}.bias"], sd[f"{prefix}.{bn_idx}.running_mean"],
        sd[f"{prefix}.{bn_idx}.running_var"])


def _shared_mlp_from_sd(sd: Dict[str, np.ndarray], prefix: str) -> Dict[str, Any]:
    """build_shared_mlp Sequential (Conv2d@3j, BN@3j+1, ReLU) -> mlp stack."""
    layers = []
    j = 0
    while f"{prefix}.{3 * j}.weight" in sd:
        layers.append(_fold_bn_seq(sd, prefix, 3 * j, 3 * j + 1))
        j += 1
    if not layers:
        raise KeyError(f"no shared-mlp layers under {prefix}")
    return {"layers": layers}


def _plain_linear(sd: Dict[str, np.ndarray], key: str) -> Dict[str, np.ndarray]:
    w = np.asarray(sd[f"{key}.weight"], np.float32)
    p = {"w": np.ascontiguousarray(w.reshape(w.shape[0], -1).T)}
    if f"{key}.bias" in sd:
        p["b"] = np.asarray(sd[f"{key}.bias"], np.float32)
    return p


def _pointnet2_cls_ssg_tree(sd: Dict[str, np.ndarray]) -> Dict[str, Any]:
    """PointNet2ClassificationSSG -> ref_cls_ssg_forward's tree."""
    sas = [_shared_mlp_from_sd(sd, f"SA_modules.{i}.mlps.0")
           for i in range(3)]
    fc = [
        _fold_bn_seq(sd, "fc_layer", 0, 1),
        _fold_bn_seq(sd, "fc_layer", 3, 4),
        _plain_linear(sd, "fc_layer.7"),
    ]
    return {"sa": sas, "fc": fc}


def _pointnet2_sem_seg_tree(sd: Dict[str, np.ndarray]) -> Dict[str, Any]:
    """PointNet2SemSegSSG state dict (point2_ssg_sem.py:8-60) -> params
    for models/pointnet2.ref_sem_seg_forward."""
    sas = [_shared_mlp_from_sd(sd, f"SA_modules.{i}.mlps.0")
           for i in range(4)]
    fps = []
    # C1 = skip (unknow_feats) channels per FP level: input feats 6,
    # then the SA output dims
    dense_dims = (6, 64, 128, 256)
    for i in range(4):
        mlp = _shared_mlp_from_sd(sd, f"FP_modules.{i}.mlp")
        # reference FP concatenates [interpolated(C2), skip(C1)]
        # (pointnet2_modules.py:200-203); our feature_propagation uses
        # [skip(C1), interpolated(C2)] — rotate the first layer's input
        # rows so the folded weights see our order
        w = mlp["layers"][0]["w"]
        c1 = dense_dims[i]
        c2 = w.shape[0] - c1
        mlp["layers"][0]["w"] = np.ascontiguousarray(
            np.concatenate([w[c2:], w[:c2]], axis=0))
        fps.append(mlp)
    head = [_fold_bn_seq(sd, "fc_lyaer", 0, 1), _plain_linear(sd, "fc_lyaer.4")]
    return {"sa": sas, "fp": fps, "head": head}


def _dgcnn_semseg_tree(sd: Dict[str, np.ndarray]) -> Dict[str, Any]:
    """DGCNN_semseg state dict (DGCNN.py:231-270) -> params for
    models/pointnet2.ref_dgcnn_semseg_forward."""
    def seq(names):
        return {"layers": [_fold_bn_seq(sd, n, 0, 1) for n in names]}

    return {
        "conv12": seq(["conv1", "conv2"]),
        "conv34": seq(["conv3", "conv4"]),
        "conv5": seq(["conv5"]),
        "conv6": seq(["conv6"]),
        "conv7": seq(["conv7"]),
        "conv8": seq(["conv8"]),
        "conv9": _plain_linear(sd, "conv9"),
        "finals": [_plain_linear(sd, f"finals.{j}") for j in range(3)],
    }


def _fold_bn_biased(w, conv_b, bn_g, bn_b, bn_m, bn_v,
                    eps: float = 1e-5) -> Dict[str, np.ndarray]:
    """Conv-with-bias + eval BN fold: b' = beta + (b - mean)*scale."""
    w = np.asarray(w, np.float32).reshape(np.asarray(w).shape[0], -1)
    scale = np.asarray(bn_g, np.float32) / np.sqrt(
        np.asarray(bn_v, np.float32) + eps)
    b = np.zeros(w.shape[0], np.float32) if conv_b is None \
        else np.asarray(conv_b, np.float32)
    return {"w": np.ascontiguousarray((w * scale[:, None]).T),
            "b": (np.asarray(bn_b, np.float32)
                  + (b - np.asarray(bn_m, np.float32)) * scale)}


def _yanx_mlp(sd: Dict[str, np.ndarray], conv_prefix: str,
              bn_prefix: str) -> Dict[str, Any]:
    """mlp_convs.{j} (biased Conv) + mlp_bns.{j} ModuleList pair ->
    folded mlp stack (pointNet/pointnet2_utils.py flavor)."""
    layers = []
    j = 0
    while f"{conv_prefix}.{j}.weight" in sd:
        layers.append(_fold_bn_biased(
            sd[f"{conv_prefix}.{j}.weight"],
            sd.get(f"{conv_prefix}.{j}.bias"),
            sd[f"{bn_prefix}.{j}.weight"], sd[f"{bn_prefix}.{j}.bias"],
            sd[f"{bn_prefix}.{j}.running_mean"],
            sd[f"{bn_prefix}.{j}.running_var"]))
        j += 1
    if not layers:
        raise KeyError(f"no layers under {conv_prefix}")
    return {"layers": layers}


def _pointnet2_part_seg_ref_tree(sd: Dict[str, np.ndarray]) -> Dict[str, Any]:
    """PointNet2 part-seg state dict (pointnet2_part_seg_ssg.py:7-21) ->
    params for models/pointnet2.ref_part_seg_forward."""
    out = {}
    for name in ("sa1", "sa2", "sa3"):
        out[name] = _yanx_mlp(sd, f"{name}.mlp_convs", f"{name}.mlp_bns")
    for name in ("fp1", "fp2", "fp3"):
        out[name] = _yanx_mlp(sd, f"{name}.mlp_convs", f"{name}.mlp_bns")
    out["fc"] = _fold_bn_biased(
        sd["conv1.weight"], sd.get("conv1.bias"), sd["bn1.weight"],
        sd["bn1.bias"], sd["bn1.running_mean"], sd["bn1.running_var"])
    out["head"] = _plain_linear(sd, "conv2")
    return out


def _pointnet2_msg_large_tree(sd: Dict[str, np.ndarray]) -> Dict[str, Any]:
    """PointNet2_MSG_large state dict (pointnet2_part_seg_ssg.py:81-106)
    -> params for models/pointnet2.ref_msg_large_forward."""
    sas = []
    for i in range(1, 5):
        scales = []
        s = 0
        while f"sa{i}.conv_blocks.{s}.0.weight" in sd:
            scales.append(_yanx_mlp(sd, f"sa{i}.conv_blocks.{s}",
                                    f"sa{i}.bn_blocks.{s}"))
            s += 1
        sas.append({"scales": scales})
    fps = [_yanx_mlp(sd, f"fp{i}.mlp_convs", f"fp{i}.mlp_bns")
           for i in range(1, 5)]
    fc = _fold_bn_biased(
        sd["conv1.weight"], sd.get("conv1.bias"), sd["bn1.weight"],
        sd["bn1.bias"], sd["bn1.running_mean"], sd["bn1.running_var"])
    finals = [_plain_linear(sd, f"finals.{j}") for j in range(3)]
    return {"sa": sas, "fp": fps, "fc": fc, "finals": finals}


def _cbr(sd: Dict[str, np.ndarray], prefix: str) -> Dict[str, np.ndarray]:
    """pointMLP ConvBNReLU1D `net` Sequential (conv@0 biased, BN@1)."""
    return _fold_bn_biased(
        sd[f"{prefix}.net.0.weight"], sd.get(f"{prefix}.net.0.bias"),
        sd[f"{prefix}.net.1.weight"], sd[f"{prefix}.net.1.bias"],
        sd[f"{prefix}.net.1.running_mean"], sd[f"{prefix}.net.1.running_var"])


def _res1d(sd: Dict[str, np.ndarray], prefix: str) -> Dict[str, Any]:
    """ConvBNReLURes1D, groups=1 (net1 conv+BN+act, net2 conv+BN)."""
    return {
        "net1": _fold_bn_biased(
            sd[f"{prefix}.net1.0.weight"], sd.get(f"{prefix}.net1.0.bias"),
            sd[f"{prefix}.net1.1.weight"], sd[f"{prefix}.net1.1.bias"],
            sd[f"{prefix}.net1.1.running_mean"],
            sd[f"{prefix}.net1.1.running_var"]),
        "net2": _fold_bn_biased(
            sd[f"{prefix}.net2.0.weight"], sd.get(f"{prefix}.net2.0.bias"),
            sd[f"{prefix}.net2.1.weight"], sd[f"{prefix}.net2.1.bias"],
            sd[f"{prefix}.net2.1.running_mean"],
            sd[f"{prefix}.net2.1.running_var"]),
    }


def _res_seq(sd: Dict[str, np.ndarray], prefix: str):
    blocks = []
    j = 0
    while f"{prefix}.{j}.net1.0.weight" in sd:
        blocks.append(_res1d(sd, f"{prefix}.{j}"))
        j += 1
    return blocks


def _pointmlp_tree(sd: Dict[str, np.ndarray],
                     n_stages: int = 4) -> Dict[str, Any]:
    """PointMLP state dict (pointMLP.py:334-410) -> params for
    models/pointnet2.ref_pointmlp_forward (BN folded, groups=1)."""
    out = {
        "groupers": [
            {"alpha": np.asarray(sd[f"local_grouper_list.{i}.affine_alpha"],
                                 np.float32),
             "beta": np.asarray(sd[f"local_grouper_list.{i}.affine_beta"],
                                np.float32)}
            for i in range(n_stages)
        ],
        "pre": [
            {"transfer": _cbr(sd, f"pre_blocks_list.{i}.transfer"),
             "blocks": _res_seq(sd, f"pre_blocks_list.{i}.operation")}
            for i in range(n_stages)
        ],
        "pos": [_res_seq(sd, f"pos_blocks_list.{i}.operation")
                for i in range(n_stages)],
        "decode": [
            {"fuse": _cbr(sd, f"decode_list.{i}.fuse"),
             "extraction": _res_seq(sd, f"decode_list.{i}.extraction.operation")}
            for i in range(n_stages)
        ],
        "gmp_map": [_cbr(sd, f"gmp_map_list.{i}")
                    for i in range(n_stages + 1)],
        "gmp_end": _cbr(sd, "gmp_map_end"),
        "conv": _fold_bn_biased(
            sd["conv.0.weight"], sd.get("conv.0.bias"), sd["conv.1.weight"],
            sd["conv.1.bias"], sd["conv.1.running_mean"],
            sd["conv.1.running_var"]),
        "finals": [_plain_linear(sd, f"finals.{j}") for j in range(3)],
    }
    if "embedding.net.0.weight" in sd:  # absent in PointMLP_refine
        out["embedding"] = _cbr(sd, "embedding")
    return out


def _dgcnn_pointnet_tree(sd: Dict[str, np.ndarray]) -> Dict[str, Any]:
    """PointNet state dict (DGCNN.py:58-77) -> params for
    models/pointnet2.ref_pointnet_cls_forward (plain convs + separate
    bn{i} registrations, BN folded)."""
    convs = [
        _fold_bn_into_linear(
            sd[f"conv{i}.weight"], sd[f"bn{i}.weight"], sd[f"bn{i}.bias"],
            sd[f"bn{i}.running_mean"], sd[f"bn{i}.running_var"])
        for i in range(1, 6)
    ]
    fc1 = _fold_bn_into_linear(
        sd["linear1.weight"], sd["bn6.weight"], sd["bn6.bias"],
        sd["bn6.running_mean"], sd["bn6.running_var"])
    return {"convs": {"layers": convs}, "fc1": fc1,
            "fc2": _plain_linear(sd, "linear2")}


def _dgcnn_partseg_tree(sd: Dict[str, np.ndarray]) -> Dict[str, Any]:
    """DGCNN_partseg state dict (DGCNN.py:137-185) -> params for
    models/pointnet2.ref_dgcnn_partseg_forward."""
    def seq(names):
        return {"layers": [_fold_bn_seq(sd, n, 0, 1) for n in names]}

    tnet_prefix = "transform_net"
    tnet = {
        "conv12": seq([f"{tnet_prefix}.conv1", f"{tnet_prefix}.conv2"]),
        "conv3": seq([f"{tnet_prefix}.conv3"]),
        # linear1/linear2 are bias-free; their BNs are the REASSIGNED
        # bn3 (512) and bn4 (256) module attributes (DGCNN.py:110-112 —
        # the 1024 BN lives inside the conv3 Sequential)
        "fc1": _fold_bn_into_linear(
            sd[f"{tnet_prefix}.linear1.weight"], sd[f"{tnet_prefix}.bn3.weight"],
            sd[f"{tnet_prefix}.bn3.bias"], sd[f"{tnet_prefix}.bn3.running_mean"],
            sd[f"{tnet_prefix}.bn3.running_var"]),
        "fc2": _fold_bn_into_linear(
            sd[f"{tnet_prefix}.linear2.weight"], sd[f"{tnet_prefix}.bn4.weight"],
            sd[f"{tnet_prefix}.bn4.bias"], sd[f"{tnet_prefix}.bn4.running_mean"],
            sd[f"{tnet_prefix}.bn4.running_var"]),
        "transform": _plain_linear(sd, f"{tnet_prefix}.transform"),
    }
    return {
        "tnet": tnet,
        "conv12": seq(["conv1", "conv2"]),
        "conv34": seq(["conv3", "conv4"]),
        "conv5": seq(["conv5"]),
        "conv6": seq(["conv6"]),
        "conv8": seq(["conv8"]),
        "conv9": seq(["conv9"]),
        "conv10": seq(["conv10"]),
        "conv11": _plain_linear(sd, "conv11"),
    }



def convert_pointnet2_cls_ssg(sd: Dict[str, np.ndarray], device="cpu") -> Dict[str, Any]:
    """PointNet2ClassificationSSG (point2_ssg_cls.py) ->
    models/pointnet2.ref_cls_ssg_forward (the port's tree on ``device``)."""
    return from_jax_params(_pointnet2_cls_ssg_tree(sd), device)


def convert_pointnet2_sem_seg(sd: Dict[str, np.ndarray], device="cpu") -> Dict[str, Any]:
    """PointNet2SemSegSSG (point2_ssg_sem.py) -> models/pointnet2.ref_sem_seg_forward (the
    port's tree on ``device``)."""
    return from_jax_params(_pointnet2_sem_seg_tree(sd), device)


def convert_dgcnn_semseg(sd: Dict[str, np.ndarray], device="cpu") -> Dict[str, Any]:
    """DGCNN_semseg (DGCNN.py) -> models/pointnet2.ref_dgcnn_semseg_forward (the port's
    tree on ``device``)."""
    return from_jax_params(_dgcnn_semseg_tree(sd), device)


def convert_pointnet2_part_seg_ref(sd: Dict[str, np.ndarray], device="cpu") -> Dict[str, Any]:
    """PointNet2 part segmentation (pointnet2_part_seg_ssg.py) ->
    models/pointnet2.ref_part_seg_forward (the port's tree on ``device``)."""
    return from_jax_params(_pointnet2_part_seg_ref_tree(sd), device)


def convert_pointnet2_msg_large(sd: Dict[str, np.ndarray], device="cpu") -> Dict[str, Any]:
    """PointNet2_MSG_large (pointnet2_part_seg_ssg.py) ->
    models/pointnet2.ref_msg_large_forward (the port's tree on ``device``)."""
    return from_jax_params(_pointnet2_msg_large_tree(sd), device)


def convert_pointmlp(sd: Dict[str, np.ndarray], n_stages: int = 4, device="cpu") -> Dict[str, Any]:
    """PointMLP or PointMLP_refine (pointMLP.py) -> models/pointnet2.ref_pointmlp_forward
    / ref_pointmlp_refine_forward (the port's tree on ``device``)."""
    return from_jax_params(_pointmlp_tree(sd, n_stages), device)


def convert_dgcnn_pointnet(sd: Dict[str, np.ndarray], device="cpu") -> Dict[str, Any]:
    """PointNet (DGCNN.py) -> models/pointnet2.ref_pointnet_cls_forward (the port's tree
    on ``device``)."""
    return from_jax_params(_dgcnn_pointnet_tree(sd), device)


def convert_dgcnn_partseg(sd: Dict[str, np.ndarray], device="cpu") -> Dict[str, Any]:
    """DGCNN_partseg (DGCNN.py) -> models/pointnet2.ref_dgcnn_partseg_forward (the port's
    tree on ``device``)."""
    return from_jax_params(_dgcnn_partseg_tree(sd), device)
