"""The reference's YOLOv7 model yamls -> specs (port of
hamer_yolo_tpu/models/yolov7/yaml_spec.py).

The reference defines its model family as yaml layer lists that its
``parse_model`` builds (cfg/deploy/yolov7x.yaml, yolov7-w6.yaml,
yolov7-tiny.yaml, ...). ``spec_from_yaml`` turns such a dict into the spec
list ``models/yolov7/model`` walks and its ``YoloConfig``:

- width_multiple / depth_multiple scaling (``make_divisible`` by 8);
- the module map: Conv, MP, SP, SPPCSPC, RepConv (RepConv_OREPA too: its
  branches fuse into one RepConv at conversion), Concat, Shortcut,
  Upsample, ReOrg, DownC, Detect / IDetect / IAuxDetect (the auxiliary
  heads dropped, as the reference does for inference, or kept as AUXDET
  with ``training_form``), IBin, IKeypoint and
  the Ghost / Stem / Swin variants;
- strides doubling from P3 = 8, one level per head input.

``load_yaml_model_cfg`` reads the file; it imports PyYAML only when called.
"""
from __future__ import annotations

import math
from typing import Any, Dict, List, Tuple

from hamer_yolo_tpu_torch.models.yolov7.model import (ADD, AUXDET, BIN, CAT, DET, DOWNC, KPT, MP_,
                                                      REORG, REP, SP_, SPP, UP, C, YoloConfig)
from hamer_yolo_tpu_torch.models.yolov7.variants import VARIANT_OPS

_MODULES = {
    "Conv": C, "MP": MP_, "SP": SP_, "SPPCSPC": SPP, "RepConv": REP, "Concat": CAT,
    "Shortcut": ADD, "nn.Upsample": UP, "Upsample": UP, "ReOrg": REORG, "DownC": DOWNC,
    "Detect": DET, "IDetect": DET, "IAuxDetect": DET, "IBin": BIN, "IKeypoint": KPT,
    "GhostConv": "GHOSTC", "Ghost": "GHOST", "GhostCSPA": "GCSPA", "GhostCSPB": "GCSPB",
    "GhostCSPC": "GCSPC", "GhostSPPCSPC": "GSPP", "Stem": "STEM", "GhostStem": "GSTEM",
    "SwinTransformerBlock": "SWINB", "STCSPA": "STCSPA", "STCSPB": "STCSPB", "STCSPC": "STCSPC",
    "RepConv_OREPA": REP,
}
# variant ops that take the repeat count n as their second argument
_N_REPEAT_OPS = ("GCSPA", "GCSPB", "GCSPC", "GSPP", "STCSPA", "STCSPB", "STCSPC")


def make_divisible(x: float, divisor: int = 8) -> int:
    return max(divisor, int(math.ceil(x / divisor) * divisor))


def spec_from_yaml(cfg_dict: Dict[str, Any], nc: int = None, training_form: bool = False
                   ) -> Tuple[List[Tuple[Any, str, tuple]], YoloConfig]:
    """A reference model yaml, as a dict -> (spec, YoloConfig). ``nc``
    overrides the yaml's class count. ``training_form`` keeps IAuxDetect's
    auxiliary heads (a cfg/training yaml run by the reference's
    train_aux.py): the spec ends in AUXDET over all 2 nl inputs."""
    gd = float(cfg_dict.get("depth_multiple", 1.0))
    gw = float(cfg_dict.get("width_multiple", 1.0))
    nc = nc if nc is not None else int(cfg_dict.get("nc", 80))
    spec: List[Tuple[Any, str, tuple]] = []
    det_from = None
    for frm, number, module, args in list(cfg_dict["backbone"]) + list(cfg_dict["head"]):
        op = _MODULES.get(module)
        if op is None:
            raise ValueError(f"unsupported module in yaml: {module}")
        frm_t = tuple(frm) if isinstance(frm, (list, tuple)) else frm
        n = max(round(number * gd), 1) if number > 1 else number
        if n != 1 and op != C:
            raise ValueError(f"repeat counts only supported for Conv, got {module}")
        if op == C:
            c2 = make_divisible(args[0] * gw) if args[0] != 3 else args[0]
            k = args[1] if len(args) > 1 else 1
            s = args[2] if len(args) > 2 else 1
            for _ in range(n):
                spec.append((frm_t, C, (c2, k, s)))
                frm_t = -1
        elif op in (SPP, DOWNC):
            spec.append((frm_t, op, (make_divisible(args[0] * gw),)))
        elif op == REP:
            s_ = int(args[2]) if len(args) > 2 else 1
            c2 = make_divisible(args[0] * gw)
            spec.append((frm_t, REP, (c2,) if s_ == 1 else (c2, s_)))
        elif op == SP_:
            spec.append((frm_t, SP_, (args[0] if args else 3,)))
        elif op in (MP_, CAT, UP, REORG, ADD):
            spec.append((frm_t, op, ()))
        elif op in VARIANT_OPS:
            rest = tuple(args[1:])
            if op in _N_REPEAT_OPS:
                rest = (n,) + rest
            elif op == "SWINB":  # [c2, num_heads, num_layers]
                rest = tuple(args[1:3])
            spec.append((frm_t, op, (make_divisible(args[0] * gw),) + rest))
        else:  # DET, BIN, KPT
            det_from = frm_t
            if module == "IAuxDetect":
                if training_form:
                    op = AUXDET
                else:  # inference drops the auxiliary heads
                    det_from = tuple(det_from[:len(det_from) // 2])
            head_args = (int(args[2]),) if op == KPT and len(args) > 2 else ()
            spec.append((det_from, op, head_args))
    nl = len(det_from) // 2 if spec[-1][1] == AUXDET else len(det_from)
    strides = tuple(8 * (2 ** i) for i in range(nl))
    kw = {"nkpt": spec[-1][2][0]} if spec[-1][1] == KPT and spec[-1][2] else {}
    cfg = YoloConfig(nc=nc, anchors=tuple(tuple(a) for a in cfg_dict["anchors"]),
                     strides=strides, **kw)
    return spec, cfg


def load_yaml_model_cfg(path: str, nc: int = None, training_form: bool = False):
    """``spec_from_yaml`` of a yaml file (PyYAML imported here, on first use)."""
    import yaml

    with open(path) as f:
        return spec_from_yaml(yaml.safe_load(f), nc, training_form)
