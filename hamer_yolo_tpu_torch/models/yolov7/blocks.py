"""YOLOv7 blocks on NHWC tensors (port of hamer_yolo_tpu/models/yolov7/blocks.py):
fused Conv(+BN)+SiLU, max pools, ReOrg (space to depth), SPPCSPC, nearest 2x
upsample and deploy RepConv (one fused 3x3 conv). ``deploy=False`` gives the
training form: conv without bias + BN, and RepConv's 3x3, 1x1 and identity
branches each with its BN. Each forward takes the BN step ``bn(p, y) -> y``
(nn.batch_norm, the running stats, by default; the training forward's
normalises by the batch statistics and records the new running stats,
models/yolov7/model.yolov7_train_forward). JAX's peephole that fuses ReOrg
into the 3x3 conv after it (``HYT_FUSE_REORG``, on only on a TPU) is not
ported: ReOrg runs unfused."""
from __future__ import annotations

import torch

from hamer_yolo_tpu_torch.core import nn

SPP_POOL_KS = (5, 9, 13)


def silu(x: torch.Tensor) -> torch.Tensor:
    """x * sigmoid(x) with the product rounded in x's dtype, as jax.nn.silu."""
    return x * torch.sigmoid(x)


def conv_block_init(gen: torch.Generator, c1: int, c2: int, k: int = 1,
                    deploy: bool = True) -> nn.Params:
    p = {"conv": nn.conv_init(gen, k, c1, c2, bias=deploy)}
    if not deploy:
        p["bn"] = nn.batch_norm_init(c2, gen.device)
    return p


def conv_block(p: nn.Params, x: torch.Tensor, s: int = 1, bn=None, act=True) -> torch.Tensor:
    """Conv (+ BN) + activation: ``act`` True is SiLU (the reference's
    default), False none, or any function of core/activations.py."""
    k = nn.conv_kernel_size(p["conv"]["w"])
    y = nn.conv2d(p["conv"], x, stride=s, padding=k // 2)
    if "bn" in p:
        y = (bn or nn.batch_norm)(p["bn"], y)
    if callable(act):
        return act(y)
    return silu(y) if act else y


def mp(x: torch.Tensor, k: int = 2) -> torch.Tensor:
    return nn.max_pool(x, k, k)


def sp(x: torch.Tensor, k: int = 3) -> torch.Tensor:
    return nn.max_pool(x, k, 1, padding=k // 2)


def reorg(x: torch.Tensor) -> torch.Tensor:
    """(B, H, W, C) -> (B, H/2, W/2, 4C) space to depth, channels in the
    reference's order ([::2, ::2], [1::2, ::2], [::2, 1::2], [1::2, 1::2]),
    by JAX's reshape and transpose."""
    B, H, W, C = x.shape
    y = x.reshape(B, H // 2, 2, W // 2, 2, C).permute(0, 1, 3, 4, 2, 5)
    return y.reshape(B, H // 2, W // 2, 4 * C)


def upsample2x(x: torch.Tensor) -> torch.Tensor:
    """Nearest-neighbour 2x upsample, NHWC."""
    return x.repeat_interleave(2, dim=1).repeat_interleave(2, dim=2)


def sppcspc_init(gen: torch.Generator, c1: int, c2: int, deploy: bool = True) -> nn.Params:
    c_ = c2
    ins = {"cv1": (c1, 1), "cv2": (c1, 1), "cv3": (c_, 3), "cv4": (c_, 1), "cv5": (4 * c_, 1),
           "cv6": (c_, 3), "cv7": (2 * c_, 1)}
    return {name: conv_block_init(gen, c_in, c_, k, deploy) for name, (c_in, k) in ins.items()}


def sppcspc(p: nn.Params, x: torch.Tensor, bn=None) -> torch.Tensor:
    def cb(name, v):
        return conv_block(p[name], v, bn=bn)

    x1 = cb("cv4", cb("cv3", cb("cv1", x)))
    pools = [sp(x1, k) for k in SPP_POOL_KS]
    y1 = cb("cv6", cb("cv5", torch.cat([x1] + pools, dim=-1)))
    y2 = cb("cv2", x)
    return cb("cv7", torch.cat([y1, y2], dim=-1))


def repconv_init(gen: torch.Generator, c1: int, c2: int, s: int = 1,
                 deploy: bool = True) -> nn.Params:
    if deploy:
        return {"reparam": nn.conv_init(gen, 3, c1, c2, bias=True)}
    p = {"dense": nn.conv_init(gen, 3, c1, c2), "dense_bn": nn.batch_norm_init(c2, gen.device),
         "1x1": nn.conv_init(gen, 1, c1, c2), "1x1_bn": nn.batch_norm_init(c2, gen.device)}
    if c1 == c2 and s == 1:
        p["id_bn"] = nn.batch_norm_init(c1, gen.device)
    return p


def repconv(p: nn.Params, x: torch.Tensor, s: int = 1, bn=None) -> torch.Tensor:
    if "reparam" in p:
        return silu(nn.conv2d(p["reparam"], x, stride=s, padding=1))
    bn = bn or nn.batch_norm
    y = bn(p["dense_bn"], nn.conv2d(p["dense"], x, stride=s, padding=1))
    y = y + bn(p["1x1_bn"], nn.conv2d(p["1x1"], x, stride=s))
    if "id_bn" in p:
        y = y + bn(p["id_bn"], x)
    return silu(y)


def repconv_fuse(p: nn.Params) -> nn.Params:
    """Training-form RepConv -> the deploy form, one 3x3 conv (RepConv's
    fusion): the 3x3 and 1x1 branches with their BNs folded in, the 1x1
    padded to the centre tap, and the identity BN as eye(c) at the centre
    tap (OIHW: w[:, :, 1, 1]). A tree that has ``reparam`` already is
    returned unchanged."""
    if "reparam" in p:
        return p
    dense = nn.fold_bn_into_conv({"w": p["dense"]["w"]}, p["dense_bn"])
    one = nn.fold_bn_into_conv({"w": p["1x1"]["w"]}, p["1x1_bn"])
    w = dense["w"] + torch.nn.functional.pad(one["w"], (1, 1, 1, 1))
    b = dense["b"] + one["b"]
    if "id_bn" in p:
        c = p["dense"]["w"].shape[0]
        ident = torch.zeros((c, c, 3, 3), dtype=w.dtype, device=w.device)
        ident[:, :, 1, 1] = torch.eye(c, dtype=w.dtype, device=w.device)
        idf = nn.fold_bn_into_conv({"w": ident}, p["id_bn"])
        w = w + idf["w"]
        b = b + idf["b"]
    return {"reparam": {"w": w, "b": b}}
