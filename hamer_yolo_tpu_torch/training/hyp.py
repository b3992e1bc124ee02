"""The reference's hyp yaml (yolo/yolov7/data/hyp.scratch.*.yaml, train.py
--hyp) mapped onto the port's knobs (port of hamer_yolo_tpu/training/hyp.py):

- optimizer: lr0 / lrf / momentum / weight_decay (training/optim.yolo_optimizer)
- loss gains: box / cls / obj / anchor_t (training/losses.yolo_loss);
  loss_ota=1 names the SimOTA assigner
- augmentation: hsv_h/s/v, degrees, translate, scale, shear, perspective,
  fliplr, mosaic, mixup (the data pipeline's)

Keys with no counterpart come back in ``extras``, to be warned about, not
dropped: cls_pw / obj_pw, iou_t, fl_gamma, flipud, copy_paste / paste_in,
warmup_* (warmup is scheduled in steps, not epochs).
"""
from __future__ import annotations

from typing import Any, Dict, Tuple

_OPT_KEYS = {"lr0": "lr0", "lrf": "lrf", "momentum": "momentum",
             "weight_decay": "weight_decay"}
_LOSS_KEYS = {"box": "box_w", "cls": "cls_w", "obj": "obj_w", "anchor_t": "anchor_t"}
_DATA_KEYS = ("hsv_h", "hsv_s", "hsv_v", "degrees", "translate", "scale", "shear",
              "perspective", "fliplr", "mixup")

HypSplit = Tuple[Dict[str, float], Dict[str, float], Dict[str, Any], Dict[str, Any]]


def load_hyp_yaml(path: str) -> HypSplit:
    """hyp yaml -> (optimizer kwargs, loss kwargs, data kwargs, extras).
    Needs PyYAML, imported here."""
    import yaml

    with open(path) as f:
        hyp = yaml.safe_load(f) or {}
    return map_hyp(hyp)


def map_hyp(hyp: Dict[str, Any]) -> HypSplit:
    """A hyp dict -> the same split as ``load_hyp_yaml``."""
    opt = {dst: float(hyp[src]) for src, dst in _OPT_KEYS.items() if src in hyp}
    loss = {dst: float(hyp[src]) for src, dst in _LOSS_KEYS.items() if src in hyp}
    data: Dict[str, Any] = {k: float(hyp[k]) for k in _DATA_KEYS if k in hyp}
    if "mosaic" in hyp:
        data["mosaic"] = float(hyp["mosaic"]) > 0.0
    extras = {k: v for k, v in hyp.items()
              if k not in _OPT_KEYS and k not in _LOSS_KEYS and k not in _DATA_KEYS
              and k not in ("mosaic", "loss_ota")}
    if hyp.get("loss_ota", 0):
        extras["_assigner"] = "simota"
    return opt, loss, data, extras
