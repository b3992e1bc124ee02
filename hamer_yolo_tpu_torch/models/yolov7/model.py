"""YOLOv7 detector: built-in deploy spec, graph walk and anchor decode
(port of hamer_yolo_tpu/models/yolov7/model.py).

Only the built-in deploy topology (cfg/deploy/yolov7.yaml, ops
C/MP/CAT/SPP/UP/REP/DET) is ported: a bf16 trunk of fused conv+SiLU and an
f32 decode, xy = (2 sigmoid - 0.5 + grid) stride, wh = (2 sigmoid)^2 anchor,
flattened anchor-major per level, P3 -> P4 -> P5 (B, 25200, nc + 5) at 640.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, List, Tuple

import numpy as np
import torch

from hamer_yolo_tpu_torch.core import nn
from hamer_yolo_tpu_torch.models.yolov7 import blocks as B

C, MP_, CAT, SPP, UP, REP, DET = "C", "MP", "CAT", "SPP", "UP", "REP", "DET"
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


def init_yolov7(gen: torch.Generator, cfg: YoloConfig = YoloConfig()) -> nn.Params:
    """Deploy-form parameters, walking the spec and tracking channels."""
    channels: List[int] = []
    layers: List[Any] = []
    for i, (frm, op, args) in enumerate(yolov7_spec()):
        srcs = _resolve(frm, i)
        c_srcs = [3] if i == 0 else [channels[s] for s in srcs]
        c1, c2, p = c_srcs[0], c_srcs[0], None
        if op == C:
            c2, k, _ = args
            p = B.conv_block_init(gen, c1, c2, k)
        elif op == CAT:
            c2 = sum(c_srcs)
        elif op == SPP:
            (c2,) = args
            p = B.sppcspc_init(gen, c1, c2)
        elif op == REP:
            c2 = args[0]
            p = B.repconv_init(gen, c1, c2)
        elif op == DET:
            p = {"m": [nn.conv_init(gen, 1, channels[s], cfg.na * cfg.no, bias=True)
                       for s in srcs]}
            c2 = 0
        layers.append(p)
        channels.append(c2)
    return {"layers": layers}


def _save_set(spec: Spec) -> set:
    return {s for i, (frm, _, _) in enumerate(spec) for s in _resolve(frm, i) if s != i - 1}


def yolov7_backbone_forward(params: nn.Params, x: torch.Tensor,
                            cfg: YoloConfig = YoloConfig()) -> List[torch.Tensor]:
    """x (B, H, W, 3) in [0, 1] -> nl raw head maps (B, Hl, Wl, na * no)."""
    spec = yolov7_spec()
    saved = _save_set(spec)
    y: Dict[int, torch.Tensor] = {}
    out = x.to(getattr(torch, cfg.compute_dtype))
    det_maps: List[torch.Tensor] = []
    for i, (frm, op, args) in enumerate(spec):
        inputs = [out if s == i - 1 else y[s] for s in _resolve(frm, i)]
        p = params["layers"][i]
        if op == C:
            out = B.conv_block(p, inputs[0], s=args[2])
        elif op == MP_:
            out = B.mp(inputs[0])
        elif op == CAT:
            out = torch.cat(inputs, dim=-1)
        elif op == SPP:
            out = B.sppcspc(p, inputs[0])
        elif op == UP:
            out = B.upsample2x(inputs[0])
        elif op == REP:
            out = B.repconv(p, inputs[0])
        elif op == DET:
            det_maps = [nn.conv2d(hp, inp) for hp, inp in zip(p["m"], inputs)]
            out = inputs[-1]
        if i in saved:
            y[i] = out
    return det_maps


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


def yolov7_forward(params: nn.Params, x: torch.Tensor, cfg: YoloConfig = YoloConfig()
                   ) -> torch.Tensor:
    """Image (B, H, W, 3) in [0, 1] -> decoded (B, N, nc + 5)."""
    return decode_detections(yolov7_backbone_forward(params, x, cfg), cfg)
