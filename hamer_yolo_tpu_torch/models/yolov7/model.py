"""YOLOv7 detector: spec-driven graph walk and anchor decode (port of
hamer_yolo_tpu/models/yolov7/model.py), NHWC.

A spec is a list of (from, op, args) entries, the reference's yaml layer list
(models/yolov7/yaml_spec.py reads one); ``yolov7_spec`` is the built-in
deploy yolov7 (cfg/deploy/yolov7.yaml). The deploy ops: C (conv + SiLU, BN
folded), MP (2x2 max pool), SP_ (k x k max pool, stride 1), CAT, ADD, SPP
(SPPCSPC), UP (nearest 2x), REORG (space to depth), DOWNC, REP (fused
RepConv), the Ghost / Stem / Swin variants (models/yolov7/variants.py), and
the heads DET, BIN and KPT (models/yolov7/heads.py); AUXDET is IAuxDetect's
training form, nl lead heads and nl auxiliary ones over 2 nl inputs (the
auxiliary heads leave the deploy graph, so inference runs the lead ones
alone; the training forward gives lead then auxiliary maps, which
``split_aux_maps`` parts for the loss). The trunk runs in the
compute dtype (bf16 by default) and the decode in f32: xy = (2 sigmoid - 0.5
+ grid) stride, wh = (2 sigmoid)^2 anchor, flattened anchor-major per level,
P3 -> P4 -> P5, so (B, 25200, nc + 5) at 640. ``init_yolov7(deploy=False)``
gives the training form (BN unfused, RepConv's branches), which
``yolov7_train_forward`` runs over batch statistics for training/train_yolo.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, List, Tuple

import numpy as np
import torch

from hamer_yolo_tpu_torch.core import nn
from hamer_yolo_tpu_torch.models.yolov7 import blocks as B
from hamer_yolo_tpu_torch.models.yolov7 import heads as H
from hamer_yolo_tpu_torch.models.yolov7 import variants as V

C, MP_, CAT, SPP, UP, REP, DET = "C", "MP", "CAT", "SPP", "UP", "REP", "DET"
BIN, KPT = "BIN", "KPT"
AUXDET = "AUXDET"
ADD, REORG, SP_, DOWNC = "ADD", "REORG", "SP_", "DOWNC"
Spec = List[Tuple[Any, str, tuple]]


def _elan(c_mid: int, c_out: int) -> Spec:
    return [(-1, C, (c_mid, 1, 1)), (-2, C, (c_mid, 1, 1)), (-1, C, (c_mid, 3, 1)),
            (-1, C, (c_mid, 3, 1)), (-1, C, (c_mid, 3, 1)), (-1, C, (c_mid, 3, 1)),
            ((-1, -3, -5, -6), CAT, ()), (-1, C, (c_out, 1, 1))]


def _elan_head(c_mid: int, c_out: int) -> Spec:
    half = c_mid // 2
    return [(-1, C, (c_mid, 1, 1)), (-2, C, (c_mid, 1, 1)), (-1, C, (half, 3, 1)),
            (-1, C, (half, 3, 1)), (-1, C, (half, 3, 1)), (-1, C, (half, 3, 1)),
            ((-1, -2, -3, -4, -5, -6), CAT, ()), (-1, C, (c_out, 1, 1))]


def _down(c: int) -> Spec:
    return [(-1, MP_, ()), (-1, C, (c, 1, 1)), (-3, C, (c, 1, 1)), (-1, C, (c, 3, 2)),
            ((-1, -3), CAT, ())]


def yolov7_spec() -> Spec:
    """Deploy YOLOv7, 106 layers: (from, op, args) entries."""
    spec: Spec = [(-1, C, (32, 3, 1)), (-1, C, (64, 3, 2)), (-1, C, (64, 3, 1)),
                  (-1, C, (128, 3, 2))]
    spec += _elan(64, 256) + _down(128) + _elan(128, 512) + _down(256)
    spec += _elan(256, 1024) + _down(512) + _elan(256, 1024)
    spec += [(-1, SPP, (512,))]
    spec += [(-1, C, (256, 1, 1)), (-1, UP, ()), (37, C, (256, 1, 1)), ((-1, -2), CAT, ())]
    spec += _elan_head(256, 256)
    spec += [(-1, C, (128, 1, 1)), (-1, UP, ()), (24, C, (128, 1, 1)), ((-1, -2), CAT, ())]
    spec += _elan_head(128, 128)
    spec += [(-1, MP_, ()), (-1, C, (128, 1, 1)), (-3, C, (128, 1, 1)),
             (-1, C, (128, 3, 2)), ((-1, -3, 63), CAT, ())]
    spec += _elan_head(256, 256)
    spec += [(-1, MP_, ()), (-1, C, (256, 1, 1)), (-3, C, (256, 1, 1)),
             (-1, C, (256, 3, 2)), ((-1, -3, 51), CAT, ())]
    spec += _elan_head(512, 512)
    spec += [(75, REP, (256,)), (88, REP, (512,)), (101, REP, (1024,))]
    spec += [((102, 103, 104), DET, ())]
    return spec


YOLOV7_ANCHORS = np.array([[[12, 16], [19, 36], [40, 28]],
                           [[36, 75], [76, 55], [72, 146]],
                           [[142, 110], [192, 243], [459, 401]]], np.float32)




@dataclass(frozen=True)
class YoloConfig:
    nc: int = 3
    img_size: int = 640
    anchors: tuple = tuple(map(tuple, YOLOV7_ANCHORS.reshape(3, 6).tolist()))
    strides: tuple = (8, 16, 32)
    compute_dtype: str = "bfloat16"
    # the IBin and IKeypoint heads' parameters (used where a spec ends in BIN / KPT)
    bin_count: int = 21
    nkpt: int = 17

    @property
    def no(self) -> int:
        return self.nc + 5

    @property
    def nl(self) -> int:
        return len(self.strides)

    @property
    def na(self) -> int:
        return len(self.anchors[0]) // 2


def _resolve(frm, idx: int) -> List[int]:
    frs = frm if isinstance(frm, tuple) else (frm,)
    return [idx + f if f < 0 else f for f in frs]


def init_yolov7(gen: torch.Generator, cfg: YoloConfig = YoloConfig(), spec: Spec = None,
                deploy: bool = True) -> nn.Params:
    """Deploy-form parameters of ``spec`` (default: the built-in deploy
    yolov7), walking it and tracking channels; None for parameter-free ops.
    ``deploy=False``: the training form of its conv, SPPCSPC, DownC and
    RepConv layers (JAX's variant layers and heads take no training form
    here: they raise)."""
    channels: List[int] = []
    layers: List[Any] = []
    for i, (frm, op, args) in enumerate(spec if spec is not None else yolov7_spec()):
        srcs = _resolve(frm, i)
        c_srcs = [3] if i == 0 else [channels[s] for s in srcs]
        c1, c2, p = c_srcs[0], c_srcs[0], None
        if not deploy and op not in TRAIN_OPS:
            raise ValueError(f"init_yolov7(deploy=False): no training form of {op} is ported")
        if op == C:
            c2, k, _ = args
            p = B.conv_block_init(gen, c1, c2, k, deploy)
        elif op == CAT:
            c2 = sum(c_srcs)
        elif op == REORG:
            c2 = 4 * c1
        elif op == SPP:
            (c2,) = args
            p = B.sppcspc_init(gen, c1, c2, deploy)
        elif op == DOWNC:
            (c2,) = args
            p = {"cv1": B.conv_block_init(gen, c1, c1, 1, deploy),
                 "cv2": B.conv_block_init(gen, c1, c2 // 2, 3, deploy),
                 "cv3": B.conv_block_init(gen, c1, c2 // 2, 1, deploy)}
        elif op == REP:
            c2 = args[0]
            p = B.repconv_init(gen, c1, c2, deploy=deploy)
        elif op in V.VARIANT_OPS:
            p = V.init_variant(op, gen, c1, args)
            c2 = int(args[0])
        elif op == DET:
            p = {"m": [nn.conv_init(gen, 1, channels[s], cfg.na * cfg.no, bias=True)
                       for s in srcs]}
            c2 = 0
        elif op == AUXDET:
            half = len(srcs) // 2
            p = {"m": [nn.conv_init(gen, 1, channels[s], cfg.na * cfg.no, bias=True)
                       for s in srcs[:half]],
                 "m2": [nn.conv_init(gen, 1, channels[s], cfg.na * cfg.no, bias=True)
                        for s in srcs[half:]]}
            c2 = 0
        elif op == BIN:
            p = H.init_bin_head(gen, [channels[s] for s in srcs], cfg.na, cfg.nc, cfg.bin_count)
            c2 = 0
        elif op == KPT:
            p = H.init_keypoint_head(gen, [channels[s] for s in srcs], cfg.na, cfg.nc, cfg.nkpt)
            c2 = 0
        elif op not in (MP_, ADD, UP, SP_):
            raise ValueError(op)
        layers.append(p)
        channels.append(c2)
    return {"layers": layers}


def _save_set(spec: Spec) -> set:
    return {s for i, (frm, _, _) in enumerate(spec) for s in _resolve(frm, i) if s != i - 1}


def yolov7_backbone_forward(params: nn.Params, x: torch.Tensor, cfg: YoloConfig = YoloConfig(),
                            spec: Spec = None, bn=None, aux: bool = False) -> List[torch.Tensor]:
    """x (B, H, W, 3) in [0, 1] -> nl raw head maps (B, Hl, Wl, na * no)
    (KPT: the detect and keypoint channels concatenated). ``bn``: the BN
    step of a training-form tree (models/yolov7/blocks.py). ``aux``: an
    AUXDET head gives its nl auxiliary maps after the lead ones."""
    spec = spec if spec is not None else yolov7_spec()
    saved = _save_set(spec)
    y: Dict[int, torch.Tensor] = {}
    out = x.to(getattr(torch, cfg.compute_dtype))
    det_maps: List[torch.Tensor] = []
    for i, (frm, op, args) in enumerate(spec):
        inputs = [out if s == i - 1 else y[s] for s in _resolve(frm, i)]
        p = params["layers"][i]
        if op == C:
            out = B.conv_block(p, inputs[0], s=args[2], bn=bn)
        elif op == MP_:
            out = B.mp(inputs[0])
        elif op == CAT:
            out = torch.cat(inputs, dim=-1)
        elif op == ADD:
            out = inputs[0] + inputs[1]
        elif op == SPP:
            out = B.sppcspc(p, inputs[0], bn=bn)
        elif op == UP:
            out = B.upsample2x(inputs[0])
        elif op == REORG:
            out = B.reorg(inputs[0])
        elif op == SP_:
            out = B.sp(inputs[0], args[0] if args else 3)
        elif op == DOWNC:
            a = B.conv_block(p["cv2"], B.conv_block(p["cv1"], inputs[0], bn=bn), s=2, bn=bn)
            out = torch.cat([a, B.conv_block(p["cv3"], B.mp(inputs[0]), bn=bn)], dim=-1)
        elif op == REP:
            out = B.repconv(p, inputs[0], s=args[1] if len(args) > 1 else 1, bn=bn)
        elif op in V.VARIANT_OPS:
            out = V.apply_variant(op, p, inputs[0], args)
        elif op in (DET, BIN):
            det_maps = [nn.conv2d(hp, inp) for hp, inp in zip(p["m"], inputs)]
            out = inputs[-1]
        elif op == AUXDET:
            half = len(p["m"])
            det_maps = [nn.conv2d(hp, inp) for hp, inp in zip(p["m"], inputs[:half])]
            if aux:
                det_maps += [nn.conv2d(hp, inp) for hp, inp in zip(p["m2"], inputs[half:])]
            out = inputs[-1]
        elif op == KPT:
            det_maps = [torch.cat([nn.conv2d(hp, inp), nn.conv2d(kp, inp)], dim=-1)
                        for hp, kp, inp in zip(p["m"], p["m_kpt"], inputs)]
            out = inputs[-1]
        if i in saved:
            y[i] = out
    return det_maps


# The ops that JAX's yolov7_train_forward runs.
TRAIN_OPS = (C, MP_, CAT, ADD, SPP, UP, REORG, SP_, DOWNC, REP, DET, AUXDET)


def yolov7_train_forward(params: nn.Params, x: torch.Tensor, cfg: YoloConfig = YoloConfig(),
                         spec: Spec = None, bn_sync=None):
    """The training forward, BN over batch statistics (torch's semantics) in
    one pass: x (B, H, W, 3) -> (the nl raw head maps, an AUXDET head's nl
    auxiliary maps after them, a copy of params
    whose BN leaves hold the updated running stats, made without gradient).
    training/train_yolo sets the stats into the train state after the
    optimizer's step, as JAX's step does. ``bn_sync``: the data-parallel
    step's parallel/mesh.DataMean, the batch statistics of the global batch."""
    spec = spec if spec is not None else yolov7_spec()
    for _, op, _ in spec:
        if op not in TRAIN_OPS:
            raise ValueError(f"yolov7_train_forward: no training form of {op} is ported")
    new_stats: Dict[int, nn.Params] = {}

    def bn(p, y):
        y, new_stats[id(p)] = nn.batch_norm_train(p, y, sync=bn_sync)
        return y

    det_maps = yolov7_backbone_forward(params, x, cfg, spec, bn=bn, aux=True)

    def with_stats(tree):
        if id(tree) in new_stats:
            return new_stats[id(tree)]
        if isinstance(tree, dict):
            return {k: with_stats(v) for k, v in tree.items()}
        if isinstance(tree, list):
            return [with_stats(v) for v in tree]
        return tree

    return det_maps, with_stats(params)


def split_aux_maps(det_maps: List[torch.Tensor], spec: Spec) -> Tuple[list, list]:
    """(lead maps, auxiliary maps) of a training forward; no auxiliary maps
    unless the spec ends in AUXDET."""
    if spec[-1][1] != AUXDET:
        return list(det_maps), []
    nl = len(det_maps) // 2
    return list(det_maps[:nl]), list(det_maps[nl:])


def decode_detections(det_maps: List[torch.Tensor], cfg: YoloConfig = YoloConfig()) -> torch.Tensor:
    """Raw head maps -> (B, sum(Hl Wl na), nc + 5) decoded xywh + scores, in f32."""
    anchors = nn.constant(cfg.anchors, torch.float32, det_maps[0].device).reshape(
        cfg.nl, cfg.na, 2)
    outs = []
    for lvl, m in enumerate(det_maps):
        m = m.float()
        Bz, H, W, _ = m.shape
        stride = cfg.strides[lvl]
        m = m.reshape(Bz, H, W, cfg.na, cfg.no).permute(0, 3, 1, 2, 4)  # (B, na, H, W, no)
        ys = torch.sigmoid(m)
        gy, gx = torch.meshgrid(torch.arange(H, dtype=torch.float32, device=m.device),
                                torch.arange(W, dtype=torch.float32, device=m.device),
                                indexing="ij")
        grid = torch.stack([gx, gy], dim=-1)
        xy = (ys[..., 0:2] * 2.0 - 0.5 + grid) * stride
        wh = (ys[..., 2:4] * 2.0) ** 2 * anchors[lvl][None, :, None, None, :]
        outs.append(torch.cat([xy, wh, ys[..., 4:]], dim=-1).reshape(Bz, -1, cfg.no))
    return torch.cat(outs, dim=1)


def yolov7_forward(params: nn.Params, x: torch.Tensor, cfg: YoloConfig = YoloConfig(),
                   spec: Spec = None) -> torch.Tensor:
    """Image (B, H, W, 3) in [0, 1] -> decoded (B, N, nc + 5); a KPT spec
    appends 3 nkpt keypoint columns."""
    maps = yolov7_backbone_forward(params, x, cfg, spec)
    head_op = (spec if spec is not None else yolov7_spec())[-1][1]
    if head_op == BIN:
        return H.decode_bin_detections(maps, cfg, cfg.bin_count)
    if head_op == KPT:
        return H.decode_keypoint_detections(maps, cfg, cfg.nkpt)
    return decode_detections(maps, cfg)


def yolov7_ensemble_forward(params_list, x: torch.Tensor, cfg: YoloConfig = YoloConfig()
                            ) -> torch.Tensor:
    """Several checkpoints of the built-in spec as one detector: their
    decoded predictions concatenated along the candidates, for one NMS after
    (the reference's Ensemble)."""
    return torch.cat([yolov7_forward(p, x, cfg) for p in params_list], dim=1)
