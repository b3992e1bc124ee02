"""The detector's evaluation loop (port of hamer_yolo_tpu/utils/detect_eval.py;
the reference's yolov7 test.py harness): tools/train_yolo's ``--evolve``
fitness and its mAP.

Each image goes through the detect program: the host letterbox (cv2's
resize and a 114 border, io/images.letterbox_numpy, byte-equal to the JAX
package's), the detector's inference forward on the parameters' device
(a training-form tree runs its BN on the running stats) and
ops/nms.non_max_suppression, whose keep mask is kernel K1 on the card, one
launch an image. Boxes go back to the frame's pixels, are clipped to it, and
meet the labels in utils/metrics.
"""
from __future__ import annotations

from typing import Iterable, Iterator, Tuple

import numpy as np
import torch

from hamer_yolo_tpu_torch.io.datasets import imread, load_yolo_labels
from hamer_yolo_tpu_torch.io.images import letterbox_numpy
from hamer_yolo_tpu_torch.models.yolov7.model import BIN, KPT, yolov7_forward, yolov7_spec
from hamer_yolo_tpu_torch.ops.nms import non_max_suppression
from hamer_yolo_tpu_torch.training.optim import named_leaves
from hamer_yolo_tpu_torch.utils.metrics import ap_per_class, match_predictions


def eval_detector_images(params, cfg, pairs: Iterable[Tuple[str, str]], spec=None,
                         conf: float = 0.001, iou: float = 0.65, img_size: int = 640
                         ) -> Iterator[dict]:
    """One record a readable image of the (image, label txt) pairs:
    ``img_path``, ``boxes`` (N, 4) xyxy in the frame's pixels, ``scores``,
    ``classes``, ``gt_boxes`` (M, 4) xyxy, ``gt_cls`` (M,); test.py's conf
    0.001 and iou 0.65 by default. A BIN or KPT head raises: their rows hold
    columns that the plain NMS would read as class scores."""
    head_op = (spec if spec is not None else yolov7_spec())[-1][1]
    if head_op in (BIN, KPT):
        raise ValueError(f"eval_detector_images: the {head_op} head's rows hold extra columns "
                         "that the plain NMS would read as class scores")
    for img_path, lbl_path in pairs:
        img = imread(img_path)
        if img is None:
            continue
        dev = named_leaves(params)[0][1].device
        h0, w0 = img.shape[:2]
        padded, r, (dw, dh) = letterbox_numpy(img, img_size)
        x = torch.from_numpy(padded[:, :, ::-1].astype(np.float32) / 255.0)[None].to(dev)
        with torch.no_grad():
            nms = non_max_suppression(yolov7_forward(params, x, cfg, spec), conf, iou,
                                      max_det=300)
        valid = nms.valid[0].cpu().numpy()
        boxes = nms.boxes[0].cpu().numpy()[valid]
        boxes[:, [0, 2]] = ((boxes[:, [0, 2]] - dw) / r).clip(0, w0)
        boxes[:, [1, 3]] = ((boxes[:, [1, 3]] - dh) / r).clip(0, h0)
        labels = load_yolo_labels(lbl_path)
        gt_cls = labels[:, 0] if len(labels) else np.zeros((0,))
        gt_boxes = np.stack([(labels[:, 1] - labels[:, 3] / 2) * w0,
                             (labels[:, 2] - labels[:, 4] / 2) * h0,
                             (labels[:, 1] + labels[:, 3] / 2) * w0,
                             (labels[:, 2] + labels[:, 4] / 2) * h0], axis=1) \
            if len(labels) else np.zeros((0, 4))
        yield {"img_path": img_path, "boxes": boxes,
               "scores": nms.scores[0].cpu().numpy()[valid],
               "classes": nms.classes[0].cpu().numpy()[valid],
               "gt_boxes": gt_boxes, "gt_cls": gt_cls}


def detector_map(params, cfg, pairs, spec=None, conf: float = 0.001, iou: float = 0.65,
                 img_size: int = 640) -> Tuple[float, float, float, float]:
    """(mean P, mean R, mAP@.5, mAP@.5:.95) over the pairs: the fitness inputs."""
    iou_thresholds = np.linspace(0.5, 0.95, 10)
    all_tp, all_conf, all_cls, all_tcls = [], [], [], []
    for rec in eval_detector_images(params, cfg, pairs, spec=spec, conf=conf, iou=iou,
                                    img_size=img_size):
        all_tp.append(match_predictions(rec["boxes"], rec["classes"], rec["gt_boxes"],
                                        rec["gt_cls"], iou_thresholds))
        all_conf.append(rec["scores"])
        all_cls.append(rec["classes"])
        all_tcls.append(rec["gt_cls"])
    if not all_tp:
        return 0.0, 0.0, 0.0, 0.0
    res = ap_per_class(np.concatenate(all_tp), np.concatenate(all_conf),
                       np.concatenate(all_cls), np.concatenate(all_tcls))
    mp = float(np.mean(res["precision"])) if len(res["precision"]) else 0.0
    mr = float(np.mean(res["recall"])) if len(res["recall"]) else 0.0
    return mp, mr, float(res["map50"]), float(res["map"])
