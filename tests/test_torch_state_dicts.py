"""Reference-format torch state dicts and checkpoint files made from parameter
trees in JAX layout, the inverse of core/convert, and the port's converters
on them. The builders serve tests/test_torch_convert.py and
tests/test_torch_checkpoint.py, which hold the converters to the JAX
package's, and chip_smoke.py's phase "checkpoint" at full width; this file
imports no JAX, so chip_smoke can use it on a machine without it.

Layouts: HWIO conv -> OIHW, (in, out) linear -> (out, in); BN dicts {scale,
bias, mean, var} -> weight, bias, running_mean, running_var.
"""
import contextlib
import os

import numpy as np
import pytest
import torch

from hamer_yolo_tpu_torch.core import convert
from hamer_yolo_tpu_torch.models.yolov7 import model as M

torch.set_num_threads(1)

BN_KEYS = (("scale", "weight"), ("bias", "bias"), ("mean", "running_mean"),
           ("var", "running_var"))


def t_conv(w):
    return np.ascontiguousarray(np.transpose(np.asarray(w), (3, 2, 0, 1)))


def t_lin(w):
    return np.ascontiguousarray(np.transpose(np.asarray(w)))


def _bn(sd, prefix, bn):
    for ours, theirs in BN_KEYS:
        sd[f"{prefix}.{theirs}"] = np.asarray(bn[ours])


def _conv_block(sd, prefix, p):
    """{"conv": {w, b?}, "bn"?} -> prefix.conv.weight / .bias, prefix.bn.*"""
    sd[f"{prefix}.conv.weight"] = t_conv(p["conv"]["w"])
    if "b" in p["conv"]:
        sd[f"{prefix}.conv.bias"] = np.asarray(p["conv"]["b"])
    if "bn" in p:
        _bn(sd, f"{prefix}.bn", p["bn"])


def _linear(sd, prefix, p):
    sd[f"{prefix}.weight"] = t_lin(p["w"])
    if "b" in p:
        sd[f"{prefix}.bias"] = np.asarray(p["b"])


def _ghost_conv(sd, prefix, p):
    _conv_block(sd, f"{prefix}.cv1", p["cv1"])
    _conv_block(sd, f"{prefix}.cv2", p["cv2"])


def _ghost_bottleneck(sd, prefix, p):
    _ghost_conv(sd, f"{prefix}.conv.0", p["g1"])
    _ghost_conv(sd, f"{prefix}.conv.2", p["g2"])
    if "dw" in p:
        _conv_block(sd, f"{prefix}.conv.1", p["dw"])
        _conv_block(sd, f"{prefix}.shortcut.0", p["sc_dw"])
        _conv_block(sd, f"{prefix}.shortcut.1", p["sc_pw"])


def _swin_block(sd, prefix, p):
    if "conv" in p:
        _conv_block(sd, f"{prefix}.conv", p["conv"])
    for i, lp in enumerate(p["layers"]):
        b = f"{prefix}.blocks.{i}"
        _bn_free_ln(sd, f"{b}.norm1", lp["norm1"])
        _linear(sd, f"{b}.attn.qkv", lp["attn"]["qkv"])
        _linear(sd, f"{b}.attn.proj", lp["attn"]["proj"])
        sd[f"{b}.attn.relative_position_bias_table"] = np.asarray(lp["attn"]["rpb"])
        _bn_free_ln(sd, f"{b}.norm2", lp["norm2"])
        _linear(sd, f"{b}.mlp.fc1", lp["mlp"]["fc1"])
        _linear(sd, f"{b}.mlp.fc2", lp["mlp"]["fc2"])


def _bn_free_ln(sd, prefix, p):
    sd[f"{prefix}.weight"] = np.asarray(p["scale"])
    sd[f"{prefix}.bias"] = np.asarray(p["bias"])


def yolo_state_dict(tree, spec=None, implicit_seed=None):
    """A yolov7 tree (deploy form, or the training form with BN and RepConv
    branches) -> the reference's model.{i}.* state dict. With
    ``implicit_seed`` the detect heads get IDetect's ImplicitA / ImplicitM
    vectors, drawn from it (ia near 0, im near 1)."""
    spec = spec if spec is not None else M.yolov7_spec()
    rng = np.random.default_rng(implicit_seed)
    sd = {}
    for i, (frm, op, _) in enumerate(spec):
        p, pre = tree["layers"][i], f"model.{i}"
        if op == M.C:
            _conv_block(sd, pre, p)
        elif op == M.SPP:
            for j in range(1, 8):
                _conv_block(sd, f"{pre}.cv{j}", p[f"cv{j}"])
        elif op == M.REP:
            if "reparam" in p:
                sd[f"{pre}.rbr_reparam.weight"] = t_conv(p["reparam"]["w"])
                sd[f"{pre}.rbr_reparam.bias"] = np.asarray(p["reparam"]["b"])
            else:
                sd[f"{pre}.rbr_dense.0.weight"] = t_conv(p["dense"]["w"])
                _bn(sd, f"{pre}.rbr_dense.1", p["dense_bn"])
                sd[f"{pre}.rbr_1x1.0.weight"] = t_conv(p["1x1"]["w"])
                _bn(sd, f"{pre}.rbr_1x1.1", p["1x1_bn"])
                if "id_bn" in p:
                    _bn(sd, f"{pre}.rbr_identity", p["id_bn"])
        elif op == "GHOSTC":
            _ghost_conv(sd, pre, p)
        elif op == "GHOST":
            _ghost_bottleneck(sd, pre, p)
        elif op in ("GCSPA", "GCSPB", "GCSPC", "STCSPA", "STCSPB", "STCSPC"):
            for j in range(1, 5):
                if f"cv{j}" in p:
                    _conv_block(sd, f"{pre}.cv{j}", p[f"cv{j}"])
            if op.startswith("G"):
                for j, bp in enumerate(p["m"]):
                    _ghost_bottleneck(sd, f"{pre}.m.{j}", bp)
            else:
                _swin_block(sd, f"{pre}.m", p["m"])
        elif op == "GSPP":
            for j in range(1, 8):
                _ghost_conv(sd, f"{pre}.cv{j}", p[f"cv{j}"])
        elif op in ("STEM", "GSTEM"):
            for j in range(1, 5):
                (_ghost_conv if op == "GSTEM" else _conv_block)(sd, f"{pre}.cv{j}", p[f"cv{j}"])
        elif op == "SWINB":
            _swin_block(sd, pre, p)
        elif op in (M.DET, M.BIN, M.KPT):
            for j, head in enumerate(p["m"]):
                sd[f"{pre}.m.{j}.weight"] = t_conv(head["w"])
                sd[f"{pre}.m.{j}.bias"] = np.asarray(head["b"])
                if implicit_seed is not None:
                    c_in, c_out = np.asarray(head["w"]).shape[2:]
                    sd[f"{pre}.ia.{j}.implicit"] = (
                        0.02 * rng.normal(size=(1, c_in, 1, 1))).astype(np.float32)
                    sd[f"{pre}.im.{j}.implicit"] = (
                        1.0 + 0.02 * rng.normal(size=(1, c_out, 1, 1))).astype(np.float32)
            for j, head in enumerate(p.get("m_kpt", [])):
                sd[f"{pre}.m_kpt.{j}.weight"] = t_conv(head["w"])
                sd[f"{pre}.m_kpt.{j}.bias"] = np.asarray(head["b"])
    return sd


def hamer_state_dict(hamer):
    """{"backbone", "mano_head"} -> the Lightning checkpoint's state dict
    (backbone.*, mano_head.*)."""
    vit, head = hamer["backbone"], hamer["mano_head"]
    sd = {"backbone.patch_embed.proj.weight": t_conv(vit["patch_embed"]["w"]),
          "backbone.patch_embed.proj.bias": np.asarray(vit["patch_embed"]["b"]),
          "backbone.pos_embed": np.asarray(vit["pos_embed"])}
    _bn_free_ln(sd, "backbone.last_norm", vit["last_norm"])
    for i, blk in enumerate(vit["blocks"]):
        b = f"backbone.blocks.{i}."
        _bn_free_ln(sd, b + "norm1", blk["norm1"])
        _bn_free_ln(sd, b + "norm2", blk["norm2"])
        _linear(sd, b + "attn.qkv", blk["attn"]["qkv"])
        _linear(sd, b + "attn.proj", blk["attn"]["proj"])
        _linear(sd, b + "mlp.fc1", blk["mlp"]["fc1"])
        _linear(sd, b + "mlp.fc2", blk["mlp"]["fc2"])
    h = "mano_head."
    _linear(sd, h + "transformer.to_token_embedding", head["token_embed"])
    sd[h + "transformer.pos_embedding"] = np.asarray(head["pos_embed"])
    for name in ("decpose", "decshape", "deccam"):
        _linear(sd, h + name, head[name])
    for name in ("init_hand_pose", "init_betas", "init_cam"):
        sd[h + name] = np.asarray(head[name])
    for i, layer in enumerate(head["layers"]):
        t = h + f"transformer.transformer.layers.{i}."
        _bn_free_ln(sd, t + "0.norm", layer["sa_norm"])
        _linear(sd, t + "0.fn.to_qkv", layer["sa"]["qkv"])
        _linear(sd, t + "0.fn.to_out.0", layer["sa"]["proj"])
        _bn_free_ln(sd, t + "1.norm", layer["ca_norm"])
        _linear(sd, t + "1.fn.to_q", layer["ca"]["to_q"])
        _linear(sd, t + "1.fn.to_kv", layer["ca"]["to_kv"])
        _linear(sd, t + "1.fn.to_out.0", layer["ca"]["proj"])
        _bn_free_ln(sd, t + "2.norm", layer["ff_norm"])
        _linear(sd, t + "2.fn.net.0", layer["ff"]["fc1"])
        _linear(sd, t + "2.fn.net.3", layer["ff"]["fc2"])
    return sd


SAR_SEQ = ("extract_mid.4", "extract_mid.5", "extract_high.0.0", "extract_high.0.1")


def sar_state_dicts(sar, layout="torchvision", module_prefix=True):
    """{"backbone", "head", "rootnet"} -> SAR's {"network", "rootnet"} state
    dicts, the trunk's keys in torchvision's layout (conv1, bn1, layer1..4)
    or SARresnet34's (extract_mid / extract_high), every key with a
    ``module.`` prefix where ``module_prefix`` says (DataParallel's)."""
    net, bb = {}, sar["backbone"]
    first = ("backbone.conv1", "backbone.bn1") if layout == "torchvision" else (
        "backbone.extract_mid.0", "backbone.extract_mid.1")
    net[f"{first[0]}.weight"] = t_conv(bb["conv1"]["w"])
    _bn(net, first[1], bb["bn1"])
    for si, blocks in enumerate(bb["stages"]):
        for bi, blk in enumerate(blocks):
            stage = f"layer{si + 1}" if layout == "torchvision" else SAR_SEQ[si]
            pre = f"backbone.{stage}.{bi}"
            net[f"{pre}.conv1.weight"] = t_conv(blk["conv1"]["w"])
            _bn(net, f"{pre}.bn1", blk["bn1"])
            net[f"{pre}.conv2.weight"] = t_conv(blk["conv2"]["w"])
            _bn(net, f"{pre}.bn2", blk["bn2"])
            if "down" in blk:
                net[f"{pre}.downsample.0.weight"] = t_conv(blk["down"]["w"])
                _bn(net, f"{pre}.downsample.1", blk["down_bn"])
    hd = sar["head"]
    net["head.saigb.group.0.weight"] = t_conv(hd["saigb"]["group"]["w"])
    net["head.saigb.group.0.bias"] = np.asarray(hd["saigb"]["group"]["b"])
    for ours, theirs in (("reg_xy1", "reg_xy.0"), ("reg_xy2", "reg_xy.3"),
                         ("reg_z1", "reg_z.0"), ("reg_z2", "reg_z.3")):
        _linear(net, f"head.gbbmr.{theirs}.fc", hd[ours]["fc"])
        net[f"head.gbbmr.{theirs}.adj"] = np.asarray(hd[ours]["adj"])
    _linear(net, "head.gbbmr.mesh2pose_hm", hd["mesh2pose_hm"])
    _linear(net, "head.gbbmr.mesh2pose_dm", hd["mesh2pose_dm"])
    net["head.gbbmr.soft_heatmap.beta.weight"] = np.asarray(
        hd["soft_heatmap"]["beta"]).reshape(-1, 1, 1, 1)
    root = {"depth_layer.weight": t_conv(sar["rootnet"]["depth_layer"]["w"]),
            "depth_layer.bias": np.asarray(sar["rootnet"]["depth_layer"]["b"])}
    pre = "module." if module_prefix else ""
    return ({pre + k: v for k, v in net.items()}, {pre + k: v for k, v in root.items()})


def module_of(sd):
    """A tree of plain ``torch.nn.Module`` objects whose state dict is ``sd``
    (each leaf a buffer), as the reference's yolov7 .pt pickles its model."""
    root = torch.nn.Module()
    for key, value in sd.items():
        *path, leaf = key.split(".")
        node = root
        for name in path:
            if not hasattr(node, name):
                node.add_module(name, torch.nn.Module())
            node = getattr(node, name)
        node.register_buffer(leaf, torch.from_numpy(np.array(value)))
    return root


def write_reference_files(out_dir, params, sar_layout="sar"):
    """The three reference files of a pipeline tree (numpy leaves, JAX
    layout), written with ``torch.save`` into ``out_dir``: yolov7_best.pt (a
    pickled module tree: "model" a decoy of zeros, "ema" the weights, which
    the converter must take), hamer.ckpt ({'state_dict': ...}) and
    SAR-resnet34-Root.pth ({'network', 'rootnet'}, ``module.`` prefixes).
    -> the three paths."""
    tensors = lambda sd: {k: torch.from_numpy(np.array(v)) for k, v in sd.items()}  # noqa: E731
    paths = [os.path.join(out_dir, n) for n in
             ("yolov7_best.pt", "hamer.ckpt", "SAR-resnet34-Root.pth")]
    ysd = yolo_state_dict(params["yolo"])
    torch.save({"epoch": -1, "model": module_of({k: np.zeros_like(v) for k, v in ysd.items()}),
                "ema": module_of(ysd)}, paths[0])
    torch.save({"state_dict": tensors(hamer_state_dict(params["hamer"]))}, paths[1])
    net, root = sar_state_dicts(params["sar"], sar_layout)
    torch.save({"network": tensors(net), "rootnet": tensors(root)}, paths[2])
    return paths


def _kpf_resnet18(sd, prefix, p):
    """resunet.resnet18 parameters -> torchvision's conv1 / bn1 / layer1..4."""
    sd[f"{prefix}.conv1.weight"] = t_conv(p["conv1"]["w"])
    _bn(sd, f"{prefix}.bn1", p["bn1"])
    for li, blocks in enumerate(p["stages"]):
        for b, blk in enumerate(blocks):
            bp = f"{prefix}.layer{li + 1}.{b}"
            sd[f"{bp}.conv1.weight"] = t_conv(blk["conv1"]["w"])
            _bn(sd, f"{bp}.bn1", blk["bn1"])
            sd[f"{bp}.conv2.weight"] = t_conv(blk["conv2"]["w"])
            _bn(sd, f"{bp}.bn2", blk["bn2"])
            if "down" in blk:
                sd[f"{bp}.downsample.0.weight"] = t_conv(blk["down"]["w"])
                _bn(sd, f"{bp}.downsample.1", blk["down_bn"])


def _kpf_residual(sd, prefix, p, rng):
    """An hourglass Residual; its skip_layer is in the module whatever the
    widths, so one of equal widths gets random weights the converter must
    leave out."""
    for i in (1, 2, 3):
        _bn(sd, f"{prefix}.bn{i}", p[f"bn{i}"])
        sd[f"{prefix}.conv{i}.conv.weight"] = t_conv(p[f"conv{i}"]["w"])
        sd[f"{prefix}.conv{i}.conv.bias"] = np.asarray(p[f"conv{i}"]["b"])
    if "skip" in p:
        sd[f"{prefix}.skip_layer.conv.weight"] = t_conv(p["skip"]["w"])
        sd[f"{prefix}.skip_layer.conv.bias"] = np.asarray(p["skip"]["b"])
    else:
        c_in, c_out = np.asarray(p["conv1"]["w"]).shape[2], np.asarray(p["conv3"]["w"]).shape[3]
        sd[f"{prefix}.skip_layer.conv.weight"] = rng.normal(size=(c_out, c_in, 1, 1)).astype(
            np.float32)
        sd[f"{prefix}.skip_layer.conv.bias"] = np.zeros(c_out, np.float32)


def _kpf_unet(sd, prefix, p, rng):
    _kpf_resnet18(sd, f"{prefix}.backbone", p["backbone"])
    for ours, theirs in (("skip4", "skip_layer4"), ("up4", "up4.0"), ("fuse4", "fusion_layer4"),
                         ("skip3", "skip_layer3"), ("up3", "up3.0"), ("fuse3", "fusion_layer3"),
                         ("skip2", "skip_layer2"), ("up2", "up2.0"), ("fuse2", "fusion_layer2")):
        _kpf_residual(sd, f"{prefix}.{theirs}", p[ours], rng)
    for i, fp in enumerate(p["finals"]):
        sd[f"{prefix}.finals.{i}.weight"] = t_conv(fp["w"])
        sd[f"{prefix}.finals.{i}.bias"] = np.asarray(fp["b"])


def _kpf_emb(sd, prefix, p):
    """{"conv": (in, out) linear, "bn"} -> Sequential(Conv1d(k=1), BatchNorm1d)."""
    sd[f"{prefix}.0.weight"] = t_lin(p["conv"]["w"])[:, :, None]
    sd[f"{prefix}.0.bias"] = np.asarray(p["conv"]["b"])
    _bn(sd, f"{prefix}.1", p["bn"])


def _kpf_bert(sd, prefix, p):
    sd[f"{prefix}.bert.position_embeddings.weight"] = np.asarray(p["bert"]["pos_embed"])
    _linear(sd, f"{prefix}.bert.img_embedding", p["bert"]["img_embed"])
    for i, lp in enumerate(p["bert"]["layers"]):
        b = f"{prefix}.bert.encoder.layer.{i}"
        for ours, theirs in (("q", "attention.self.query"), ("k", "attention.self.key"),
                             ("v", "attention.self.value"), ("attn_out", "attention.output.dense"),
                             ("inter", "intermediate.dense"), ("out", "output.dense")):
            _linear(sd, f"{b}.{theirs}", lp[ours])
        _bn_free_ln(sd, f"{b}.attention.output.LayerNorm", lp["attn_ln"])
        _bn_free_ln(sd, f"{b}.output.LayerNorm", lp["out_ln"])
    _linear(sd, f"{prefix}.cls_head", p["cls_head"])
    _linear(sd, f"{prefix}.residual", p["residual"])


def _kpf_block(sd, prefix, p):
    for name in ("pcl_feat_emb", "pcl_xyz_emb", "pcl_pose_emb", "joint_feat_emb",
                 "joint_xyz_emb", "pcl_feat_emb_RGB"):
        _kpf_emb(sd, f"{prefix}.{name}", p[name])
    fa = p["FA"]
    for i, sp in enumerate(fa["scales"]):
        for ours, conv, bn in (("l0", "conv_l0_blocks", "bn_l0_blocks"),
                               ("f0", "conv_f0_blocks", "bn_f0_blocks")):
            sd[f"{prefix}.FA.{conv}.{i}.weight"] = t_conv(sp[ours]["conv"]["w"])
            sd[f"{prefix}.FA.{conv}.{i}.bias"] = np.asarray(sp[ours]["conv"]["b"])
            _bn(sd, f"{prefix}.FA.{bn}.{i}", sp[ours]["bn"])
        for j, mp in enumerate(sp["mlp"]):
            sd[f"{prefix}.FA.conv_blocks.{i}.{j}.weight"] = t_conv(mp["conv"]["w"])
            sd[f"{prefix}.FA.conv_blocks.{i}.{j}.bias"] = np.asarray(mp["conv"]["b"])
            _bn(sd, f"{prefix}.FA.bn_blocks.{i}.{j}", mp["bn"])
    sd[f"{prefix}.FA.fusion.0.weight"] = t_conv(fa["fusion"]["conv"]["w"])[:, :, :, 0]
    sd[f"{prefix}.FA.fusion.0.bias"] = np.asarray(fa["fusion"]["conv"]["b"])
    _bn(sd, f"{prefix}.FA.fusion.1", fa["fusion"]["bn"])
    _kpf_bert(sd, f"{prefix}.init_TR", p["init_TR"])
    _kpf_bert(sd, f"{prefix}.final_TR", p["final_TR"])
    for i, lp in enumerate(p["crossTR"]["layers"]):
        d = f"{prefix}.crossTR.decoder.{i}"
        sd[f"{d}.multihead_attn.in_proj_weight"] = t_lin(lp["attn"]["in_proj_w"])
        sd[f"{d}.multihead_attn.in_proj_bias"] = np.asarray(lp["attn"]["in_proj_b"])
        _linear(sd, f"{d}.multihead_attn.out_proj", lp["attn"]["out_proj"])
        _linear(sd, f"{d}.linear1", lp["linear1"])
        _linear(sd, f"{d}.linear2", lp["linear2"])
        _bn_free_ln(sd, f"{d}.norm2", lp["norm2"])
        _bn_free_ln(sd, f"{d}.norm3", lp["norm3"])
        for name in ("self_posembed", "cross_posembed"):
            if name in lp:
                sd[f"{d}.{name}.weight"] = np.asarray(lp[name])
    sd[f"{prefix}.atten_spatial.weight"] = t_lin(p["atten_spatial"]["w"])[:, :, None, None]
    sd[f"{prefix}.atten_spatial.bias"] = np.asarray(p["atten_spatial"]["b"])
    _linear(sd, f"{prefix}.fc_spatial2joint_feature", p["fc_spatial"])
    sd[f"{prefix}.weight_dis"] = np.asarray(p["weight_dis"])


def kpfusion_state_dict(tree, seed=0):
    """A kpfusion_rgbd tree (numpy leaves, JAX layout) -> KPFusion's state
    dict (backbone_rgb.*, backbone_d.*, block1.*, block2.*); the unused
    skip_layer of each equal-width Residual gets random weights drawn from
    ``seed``."""
    rng = np.random.default_rng(seed)
    sd = {}
    _kpf_unet(sd, "backbone_rgb", tree["backbone_rgb"], rng)
    _kpf_unet(sd, "backbone_d", tree["backbone_d"], rng)
    for i, bp in enumerate(tree["blocks"]):
        _kpf_block(sd, f"block{i + 1}", bp)
    return sd


def write_kpfusion_file(path, tree):
    """KPFusion's .pth as Model_RGBD saves it: {'model': state dict} with
    DataParallel's ``module.`` prefix on every key."""
    torch.save({"epoch": -1, "model": {f"module.{k}": torch.from_numpy(np.array(v))
                                       for k, v in kpfusion_state_dict(tree).items()}}, path)


def centernet_state_dict(tree, prefix="net"):
    """centernet parameters -> centerNet's ResNet-18 + fc keys under ``prefix``."""
    sd = {}
    _kpf_resnet18(sd, prefix, tree["backbone"])
    _linear(sd, f"{prefix}.fc", tree["fc"])
    return sd


@contextlib.contextmanager
def calibrating_batch_norm():
    """Within the block every core/nn.batch_norm first sets its running
    variance to its input's mean square, one value for all channels, so
    that it scales its input to O(1) as a trained BN would. One forward so
    keeps a seeded tree's activations O(1): with the init's stats the random
    ResNet-UNets' grow to 1e4 and more. (Per-channel batch statistics would
    also do that, but over the few pixels of a small map they amplify
    near-constant channels, and with them every rounding difference.) Run
    it under torch.no_grad: the variances are set in place."""
    from hamer_yolo_tpu_torch.core import nn

    plain = nn.batch_norm

    def calibrating(p, x, eps=1e-3):
        p["var"].fill_(float(x.square().mean()))
        return plain(p, x, eps)

    nn.batch_norm = calibrating
    try:
        yield
    finally:
        nn.batch_norm = plain


def port_tree_to_numpy(tree):
    """The port's parameters (tensors) -> numpy leaves in JAX layout, the
    inverse of core/bridge: OIHW conv weights back to HWIO."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: port_tree_to_numpy(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [port_tree_to_numpy(v) for v in tree]
    a = tree.detach().cpu().numpy()
    return np.ascontiguousarray(a.transpose(2, 3, 1, 0)) if a.ndim == 4 else a


def leaves(tree, path=()):
    """{path: leaf} of a tree, None layers and empty containers kept as
    markers, so two trees compare structure and values."""
    if tree is None:
        return {path: None}
    if isinstance(tree, dict):
        out = {path: ("dict", tuple(sorted(tree)))}
        for k, v in tree.items():
            out.update(leaves(v, path + (k,)))
        return out
    if isinstance(tree, (list, tuple)):
        out = {path: ("list", len(tree))}
        for i, v in enumerate(tree):
            out.update(leaves(v, path + (i,)))
        return out
    return {path: np.asarray(tree)}


def assert_leaf_equal(got, ref):
    """The same structure, every leaf of the same dtype, shape and bits."""
    g, r = leaves(got), leaves(ref)
    assert g.keys() == r.keys(), sorted(set(g) ^ set(r), key=str)[:10]
    for k, rv in r.items():
        gv = g[k]
        if isinstance(rv, np.ndarray):
            assert gv.dtype == rv.dtype and gv.shape == rv.shape, (k, gv.dtype, rv.dtype)
            np.testing.assert_array_equal(gv, rv, err_msg=str(k))
        else:
            assert gv == rv, k


# ---------------------------------------------------------------------------
# KeypointFusion's pointNet zoo: numpy-made state dicts with the reference's
# key names, at the published widths (div 1) or each hidden width divided by
# ``div`` (the CPU tests); a layer's input widths follow its producers'.
# Weights He-scaled, BN statistics away from the identity, so that folding
# them is not trivial.
# ---------------------------------------------------------------------------

def _zoo_conv(sd, key, c_in, c_out, rng, kdims=1, bias=False, scale=None):
    scale = np.sqrt(2.0 / max(c_in, 1)) if scale is None else scale
    sd[f"{key}.weight"] = (rng.normal(size=(c_out, c_in) + (1,) * kdims) * scale).astype(
        np.float32)
    if bias:
        sd[f"{key}.bias"] = rng.normal(0.0, 0.1, c_out).astype(np.float32)


def _zoo_bn(sd, key, c, rng):
    sd[f"{key}.weight"] = rng.uniform(0.5, 1.5, c).astype(np.float32)
    sd[f"{key}.bias"] = rng.normal(0.0, 0.1, c).astype(np.float32)
    sd[f"{key}.running_mean"] = rng.normal(0.0, 0.1, c).astype(np.float32)
    sd[f"{key}.running_var"] = rng.uniform(0.5, 2.0, c).astype(np.float32)
    sd[f"{key}.num_batches_tracked"] = np.array(0, np.int64)


def _conv_bn(sd, conv, bn, c_in, c_out, rng, kdims=1, bias=False):
    _zoo_conv(sd, conv, c_in, c_out, rng, kdims, bias)
    _zoo_bn(sd, bn, c_out, rng)


def _shared_mlp(sd, prefix, dims, rng):
    """build_shared_mlp: Conv2d 1x1 (no bias) at 3j, BN2d at 3j + 1."""
    for j in range(len(dims) - 1):
        _conv_bn(sd, f"{prefix}.{3 * j}", f"{prefix}.{3 * j + 1}", dims[j], dims[j + 1], rng, 2)


def _yanx_mlp(sd, conv, bn, dims, rng, kdims):
    """mlp_convs.{j} (biased) + mlp_bns.{j}."""
    for j in range(len(dims) - 1):
        _conv_bn(sd, f"{conv}.{j}", f"{bn}.{j}", dims[j], dims[j + 1], rng, kdims, bias=True)


def zoo_cls_ssg(rng, div=1, nc=40):
    """PointNet2ClassificationSSG: the cloud is xyz + 3 features."""
    d = lambda c: max(c // div, 4)  # noqa: E731
    sd = {}
    outs = [d(128), d(256), d(1024)]
    _shared_mlp(sd, "SA_modules.0.mlps.0", [6, d(64), d(64), outs[0]], rng)
    _shared_mlp(sd, "SA_modules.1.mlps.0", [outs[0] + 3, d(128), d(128), outs[1]], rng)
    _shared_mlp(sd, "SA_modules.2.mlps.0", [outs[1] + 3, d(256), d(512), outs[2]], rng)
    _conv_bn(sd, "fc_layer.0", "fc_layer.1", outs[2], d(512), rng, 0)
    _conv_bn(sd, "fc_layer.3", "fc_layer.4", d(512), d(256), rng, 0)
    _zoo_conv(sd, "fc_layer.7", d(256), nc, rng, 0, bias=True)
    return sd


def zoo_sem_seg(rng, div=1, nc=13):
    """PointNet2SemSegSSG on xyz + 6 features. The converter orders its FP
    inputs by the published skip widths (6, 64, 128, 256), so the first
    three SA levels keep their outputs at any ``div``."""
    d = lambda c: max(c // div, 4)  # noqa: E731
    sd = {}
    sa = [[9, d(32), d(32), 64], [67, d(64), d(64), 128], [131, d(128), d(128), 256],
          [259, d(256), d(256), d(512)]]
    for i, dims in enumerate(sa):
        _shared_mlp(sd, f"SA_modules.{i}.mlps.0", dims, rng)
    fp = {3: [d(512) + 256, d(256), d(256)], 2: [d(256) + 128, d(256), d(256)],
          1: [d(256) + 64, d(256), d(128)], 0: [d(128) + 6, d(128), d(128), d(128)]}
    for i, dims in fp.items():
        _shared_mlp(sd, f"FP_modules.{i}.mlp", dims, rng)
    _conv_bn(sd, "fc_lyaer.0", "fc_lyaer.1", d(128), d(128), rng)
    _zoo_conv(sd, "fc_lyaer.4", d(128), nc, rng, bias=True)
    return sd


def _dgcnn_trunk(sd, rng, d, c_in, emb):
    for name, (i, o) in (("conv1", (2 * c_in, d(64))), ("conv2", (d(64), d(64))),
                         ("conv3", (2 * d(64), d(64))), ("conv4", (d(64), d(64))),
                         ("conv5", (2 * d(64), d(64)))):
        _conv_bn(sd, f"{name}.0", f"{name}.1", i, o, rng, 2)
    _conv_bn(sd, "conv6.0", "conv6.1", 3 * d(64), emb, rng)
    return emb + 3 * d(64)


def zoo_dgcnn_semseg(rng, div=1, joints=21, channels=9):
    """DGCNN_semseg (emb_dims 1024) with the three per-point heads [3 J, J, J]
    after conv9 (256 -> 128)."""
    d = lambda c: max(c // div, 4)  # noqa: E731
    sd = {}
    cat = _dgcnn_trunk(sd, rng, d, channels, d(1024))
    _conv_bn(sd, "conv7.0", "conv7.1", cat, d(512), rng)
    _conv_bn(sd, "conv8.0", "conv8.1", d(512), d(256), rng)
    _zoo_conv(sd, "conv9", d(256), d(128), rng)
    for j, o in enumerate((3 * joints, joints, joints)):
        _zoo_conv(sd, f"finals.{j}", d(128), o, rng, bias=True)
    return sd


def zoo_dgcnn_partseg(rng, div=1, seg=50):
    """DGCNN_partseg (emb_dims 1024, no label input) with its Transform_Net."""
    d = lambda c: max(c // div, 4)  # noqa: E731
    sd = {}
    t = "transform_net"
    _conv_bn(sd, f"{t}.conv1.0", f"{t}.conv1.1", 6, d(64), rng, 2)
    _conv_bn(sd, f"{t}.conv2.0", f"{t}.conv2.1", d(64), d(128), rng, 2)
    _conv_bn(sd, f"{t}.conv3.0", f"{t}.conv3.1", d(128), d(1024), rng)
    _conv_bn(sd, f"{t}.linear1", f"{t}.bn3", d(1024), d(512), rng, 0)
    _conv_bn(sd, f"{t}.linear2", f"{t}.bn4", d(512), d(256), rng, 0)
    _zoo_conv(sd, f"{t}.transform", d(256), 9, rng, 0, bias=True, scale=0.01)
    sd[f"{t}.transform.bias"] = np.eye(3, dtype=np.float32).ravel()  # its init: the identity
    cat = _dgcnn_trunk(sd, rng, d, 3, d(1024))
    _conv_bn(sd, "conv8.0", "conv8.1", cat, d(256), rng)
    _conv_bn(sd, "conv9.0", "conv9.1", d(256), d(256), rng)
    _conv_bn(sd, "conv10.0", "conv10.1", d(256), d(128), rng)
    _zoo_conv(sd, "conv11", d(128), seg, rng)
    return sd


def zoo_pointnet(rng, div=1, nc=40):
    """DGCNN.py's PointNet (emb_dims 1024)."""
    d = lambda c: max(c // div, 4)  # noqa: E731
    sd = {}
    dims = [3, d(64), d(64), d(64), d(128), d(1024)]
    for i in range(1, 6):
        _conv_bn(sd, f"conv{i}", f"bn{i}", dims[i - 1], dims[i], rng)
    _conv_bn(sd, "linear1", "bn6", dims[-1], d(512), rng, 0)
    _zoo_conv(sd, "linear2", d(512), nc, rng, 0, bias=True)
    return sd


def zoo_part_seg(rng, div=1, joints=21):
    """The hand PointNet2 part segmenter: l0 = [xyz, 4 J joint offsets and
    closenesses], num_classes J."""
    d = lambda c: max(c // div, 4)  # noqa: E731
    sd = {}
    l0 = 3 + 4 * joints
    outs = (d(128), d(256), d(1024))
    _yanx_mlp(sd, "sa1.mlp_convs", "sa1.mlp_bns", [l0 + 3, d(64), d(64), outs[0]], rng, 2)
    _yanx_mlp(sd, "sa2.mlp_convs", "sa2.mlp_bns", [outs[0] + 3, d(128), d(128), outs[1]], rng, 2)
    _yanx_mlp(sd, "sa3.mlp_convs", "sa3.mlp_bns", [outs[1] + 3, d(256), d(512), outs[2]], rng, 2)
    _yanx_mlp(sd, "fp3.mlp_convs", "fp3.mlp_bns", [outs[1] + outs[2], d(256), d(256)], rng, 1)
    _yanx_mlp(sd, "fp2.mlp_convs", "fp2.mlp_bns", [outs[0] + d(256), d(256), d(128)], rng, 1)
    _yanx_mlp(sd, "fp1.mlp_convs", "fp1.mlp_bns", [3 + l0 + d(128), d(128), d(128), d(128)],
              rng, 1)
    _conv_bn(sd, "conv1", "bn1", d(128), d(128), rng, bias=True)
    _zoo_conv(sd, "conv2", d(128), joints, rng, bias=True)
    return sd


def zoo_msg_large(rng, div=1, joints=21):
    """PointNet2_MSG_large (the MSG levels of models/pointnet2.MSG_LARGE_LEVELS)
    with the heads [3 J, J, J]."""
    d = lambda c: max(c // div, 4)  # noqa: E731
    sd = {}
    mlps = (((16, 16, 32), (32, 32, 64)), ((64, 64, 128), (64, 96, 128)),
            ((128, 196, 256), (128, 196, 256)), ((256, 256, 512), (256, 384, 512)))
    c, outs = 3, []
    for i, scales in enumerate(mlps, 1):
        for s, mlp in enumerate(scales):
            _yanx_mlp(sd, f"sa{i}.conv_blocks.{s}", f"sa{i}.bn_blocks.{s}",
                      [c + 3] + [d(m) for m in mlp], rng, 2)
        c = sum(d(m[-1]) for m in scales)
        outs.append(c)
    fp = {4: [outs[3] + outs[2], d(256), d(256)], 3: [d(256) + outs[1], d(256), d(256)],
          2: [d(256) + outs[0], d(256), d(128)], 1: [d(128), d(128), d(128), d(128)]}
    for i, dims in fp.items():
        _yanx_mlp(sd, f"fp{i}.mlp_convs", f"fp{i}.mlp_bns", dims, rng, 1)
    _conv_bn(sd, "conv1", "bn1", d(128), d(128), rng, bias=True)
    for j, o in enumerate((3 * joints, joints, joints)):
        _zoo_conv(sd, f"finals.{j}", d(128), o, rng, bias=True)
    return sd


def _cbr1d(sd, prefix, c_in, c_out, rng):
    _conv_bn(sd, f"{prefix}.net.0", f"{prefix}.net.1", c_in, c_out, rng, bias=True)


def _res1d(sd, prefix, c, rng):
    """ConvBNReLURes1D; net2's weights a third of He's, so that the residual
    stacks (34 blocks) keep activations O(1-100), not O(1e6)."""
    _conv_bn(sd, f"{prefix}.net1.0", f"{prefix}.net1.1", c, c, rng, bias=True)
    _zoo_conv(sd, f"{prefix}.net2.0", c, c, rng, bias=True, scale=np.sqrt(2.0 / c) / 3)
    _zoo_bn(sd, f"{prefix}.net2.1", c, rng)


def zoo_pointmlp(rng, div=1, joints=21, refine=False, blocks=(2, 2, 4)):
    """pointMLP's joint regressor (PointMLP; ``refine``: PointMLP_refine, no
    embedding): embed 64, the stages doubling to 1024, k 16, pre and pos
    blocks ``blocks[:2]`` a stage, decoders de_dims 512, 256, 128, 128 with
    ``blocks[2]`` blocks each, gmp 64, the conv head 192 -> 128, the heads
    [3 J, J, J]."""
    d = lambda c: max(c // div, 4)  # noqa: E731
    sd = {}
    embed = d(64)
    if not refine:
        _cbr1d(sd, "embedding", 3, embed, rng)
    en = [embed]
    for i in range(4):
        c = en[-1]
        sd[f"local_grouper_list.{i}.affine_alpha"] = rng.uniform(
            0.5, 1.5, (1, 1, 1, c + 3)).astype(np.float32)
        sd[f"local_grouper_list.{i}.affine_beta"] = rng.normal(
            0.0, 0.1, (1, 1, 1, c + 3)).astype(np.float32)
        _cbr1d(sd, f"pre_blocks_list.{i}.transfer", 2 * c + 3, 2 * c, rng)
        for b in range(blocks[0]):
            _res1d(sd, f"pre_blocks_list.{i}.operation.{b}", 2 * c, rng)
        for b in range(blocks[1]):
            _res1d(sd, f"pos_blocks_list.{i}.operation.{b}", 2 * c, rng)
        en.append(2 * c)
    en_rev = en[::-1]
    de = [en_rev[0], d(512), d(256), d(128), d(128)]
    for i in range(4):
        _cbr1d(sd, f"decode_list.{i}.fuse", de[i] + en_rev[i + 1], de[i + 1], rng)
        for b in range(blocks[2]):
            _res1d(sd, f"decode_list.{i}.extraction.operation.{b}", de[i + 1], rng)
    gmp = d(64)
    for i, c in enumerate(en_rev):
        _cbr1d(sd, f"gmp_map_list.{i}", c, gmp, rng)
    _cbr1d(sd, "gmp_map_end", gmp * len(en_rev), gmp, rng)
    _conv_bn(sd, "conv.0", "conv.1", de[-1] + gmp, d(128), rng, bias=True)
    for j, o in enumerate((3 * joints, joints, joints)):
        _zoo_conv(sd, f"finals.{j}", d(128), o, rng, bias=True)
    return sd


# tests/test_pointnet2_models.py's oracle tolerances of the zoo's forwards
# (atol; rtol 1e-4): the CPU tests against JAX and chip_smoke's card against CPU
ZOO_TOL = {"cls_ssg": 2e-4, "sem_seg": 5e-4, "dgcnn_semseg": 5e-4, "part_seg": 5e-4,
           "msg_large": 5e-4, "pointmlp": 1e-3, "pointmlp_refine": 1e-3, "pointnet": 5e-4,
           "dgcnn_partseg": 1e-3}
# name -> (state dict builder, the port's converter)
ZOO = {
    "cls_ssg": (zoo_cls_ssg, convert.convert_pointnet2_cls_ssg),
    "sem_seg": (zoo_sem_seg, convert.convert_pointnet2_sem_seg),
    "dgcnn_semseg": (zoo_dgcnn_semseg, convert.convert_dgcnn_semseg),
    "part_seg": (zoo_part_seg, convert.convert_pointnet2_part_seg_ref),
    "msg_large": (zoo_msg_large, convert.convert_pointnet2_msg_large),
    "pointmlp": (zoo_pointmlp, convert.convert_pointmlp),
    "pointmlp_refine": (lambda rng, div=1: zoo_pointmlp(rng, div, refine=True),
                        convert.convert_pointmlp),
    "pointnet": (zoo_pointnet, convert.convert_dgcnn_pointnet),
    "dgcnn_partseg": (zoo_dgcnn_partseg, convert.convert_dgcnn_partseg),
}


# ---------------------------------------------------------------------------
# the port's converters undo the builders (no JAX)
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def port_tree():
    """The tiny pipeline's seeded init with SAR, as numpy in JAX layout."""
    from hamer_yolo_tpu_torch.cli.main import load_mano, pipeline_config
    from hamer_yolo_tpu_torch.core.checkpoint import init_pipeline_params

    cfg = pipeline_config(tiny=True)
    mano = load_mano(None, "cpu")
    params = init_pipeline_params(3, mano, cfg.yolo, cfg.hamer, cfg.sar, device="cpu")
    return port_tree_to_numpy(params), mano.v_template.numpy(), cfg


def test_yolo_round_trip(port_tree):
    tree, _, _ = port_tree
    assert_leaf_equal(convert.convert_yolov7_state_dict(yolo_state_dict(tree["yolo"])),
                      tree["yolo"])


def test_hamer_round_trip(port_tree):
    tree, _, cfg = port_tree
    sd = hamer_state_dict(tree["hamer"])
    got = {"backbone": convert.convert_vit_state_dict(sd, depth=cfg.hamer.vit.depth),
           "mano_head": convert.convert_mano_head_state_dict(sd, depth=cfg.hamer.head.depth)}
    assert_leaf_equal(got, tree["hamer"])


@pytest.mark.parametrize("layout", ["torchvision", "sar"])
def test_pipeline_files_round_trip(port_tree, tmp_path, layout):
    """The three files through convert_pipeline_checkpoints give the tree
    back (the tiny ViT's 2 blocks: the converter reads the first 2 of 32
    only where the file has 32, so the HaMeR file is checked on its own)."""
    tree, template, _ = port_tree
    paths = write_reference_files(str(tmp_path), tree, layout)
    got = convert.convert_pipeline_checkpoints(paths[0], None, paths[2], template)
    assert_leaf_equal(got, {"yolo": tree["yolo"], "sar": tree["sar"]})
    with pytest.raises(ValueError, match="MANO template"):
        convert.convert_pipeline_checkpoints(None, None, paths[2])


def test_kpfusion_round_trip(tmp_path):
    """A seeded kpfusion_rgbd tree (small widths: the UNets are ResNet-18 at
    64 x 64) written as KPFusion's .pth and read back by
    convert_kpfusion_checkpoint: leaf for leaf the tree that went in."""
    from hamer_yolo_tpu_torch.models.kpfusion_rgbd.model import KPFusionConfig, init_kpfusion

    gen = torch.Generator()
    gen.manual_seed(4)
    cfg = KPFusionConfig(dim=32, img_size=64, feature_size=16, sample_num=128)
    tree = port_tree_to_numpy(init_kpfusion(gen, cfg))
    path = str(tmp_path / "kpfusion.pth")
    write_kpfusion_file(path, tree)
    assert_leaf_equal(convert.convert_kpfusion_checkpoint(path), tree)
