"""Detector evaluation: COCO-style mAP over a labelled image dir (port of
tools/eval_detector.py; the reference's yolo/yolov7/test.py harness with
ap_per_class and the ConfusionMatrix).

  python -m hamer_yolo_tpu_torch.tools.eval_detector --data <images dir> [--labels DIR]
      [--checkpoint ckpt.npz] [--nc 3] [--img-size 640] [--conf 0.001] [--iou 0.65]
      [--save-json PATH] [--device cuda]

The per-image loop is utils/detect_eval.eval_detector_images (the one
train_yolo --evolve scores with); ``--checkpoint`` is a port checkpoint of
detector weights or a train state (its EMA weights preferred), else the
seeded init (seed 0). ``--save-json`` writes the predictions in the
cocoapi schema of test.py --save-json (test.py:167-176).
"""
from __future__ import annotations

import argparse
import json
import os
from typing import Optional

import numpy as np


def main(argv: Optional[list] = None) -> int:
    p = argparse.ArgumentParser(prog="eval_detector")
    p.add_argument("--data", required=True)
    p.add_argument("--labels", default=None)
    p.add_argument("--checkpoint", default=None)
    p.add_argument("--nc", type=int, default=3)
    p.add_argument("--img-size", type=int, default=640)
    p.add_argument("--conf", type=float, default=0.001)
    p.add_argument("--iou", type=float, default=0.65)
    p.add_argument("--save-json", default=None, metavar="PATH",
                   help="write a cocoapi-compatible results JSON "
                        "(test.py --save-json, test.py:167-176 schema)")
    p.add_argument("--device", default="cuda",
                   help="torch device (default: the card; cpu for a machine without one)")
    args = p.parse_args(argv)

    import torch

    from hamer_yolo_tpu_torch.core.checkpoint import load_checkpoint
    from hamer_yolo_tpu_torch.io.datasets import image_label_pairs
    from hamer_yolo_tpu_torch.models.yolov7.model import YoloConfig, init_yolov7
    from hamer_yolo_tpu_torch.utils.detect_eval import eval_detector_images
    from hamer_yolo_tpu_torch.utils.metrics import (ConfusionMatrix, ap_per_class,
                                                    match_predictions)

    device = torch.device(args.device)
    cfg = YoloConfig(nc=args.nc, img_size=args.img_size)
    if args.checkpoint and os.path.exists(args.checkpoint):
        params = load_checkpoint(args.checkpoint, device)
        if "params" in params:  # a train state; prefer the EMA weights
            params = params.get("ema", {}).get("params", params["params"])
    else:
        print("warning: random-init weights (no checkpoint)")
        gen = torch.Generator(device=device)
        gen.manual_seed(0)
        params = init_yolov7(gen, cfg)

    iou_thresholds = np.linspace(0.5, 0.95, 10)
    all_tp, all_conf, all_cls, all_target_cls = [], [], [], []
    jdict = []
    cm = ConfusionMatrix(args.nc)
    pairs = image_label_pairs(args.data, args.labels)
    for rec in eval_detector_images(params, cfg, pairs, conf=args.conf, iou=args.iou,
                                    img_size=args.img_size):
        boxes, scores, classes = rec["boxes"], rec["scores"], rec["classes"]
        gt_boxes, gt_cls = rec["gt_boxes"], rec["gt_cls"]
        if args.save_json is not None:
            stem = os.path.splitext(os.path.basename(rec["img_path"]))[0]
            image_id = int(stem) if stem.isnumeric() else stem
            for bx, sc, cl in zip(boxes, scores, classes):
                jdict.append({"image_id": image_id, "category_id": int(cl),
                              "bbox": [round(float(bx[0]), 3), round(float(bx[1]), 3),
                                       round(float(bx[2] - bx[0]), 3),
                                       round(float(bx[3] - bx[1]), 3)],
                              "score": round(float(sc), 5)})
        all_tp.append(match_predictions(boxes, classes, gt_boxes, gt_cls, iou_thresholds))
        all_conf.append(scores)
        all_cls.append(classes)
        all_target_cls.append(gt_cls)
        if len(boxes):
            dets6 = np.concatenate([boxes, scores[:, None], classes[:, None]], 1)
            cm.process_batch(dets6, np.concatenate([gt_cls[:, None], gt_boxes], 1)
                             if len(gt_boxes) else np.zeros((0, 5)))

    if args.save_json is not None:
        with open(args.save_json, "w") as f:
            json.dump(jdict, f)
        print(f"saved {len(jdict)} predictions to {args.save_json}")
    if not all_tp:
        print("no images evaluated")
        return 1
    res = ap_per_class(np.concatenate(all_tp), np.concatenate(all_conf),
                       np.concatenate(all_cls), np.concatenate(all_target_cls))
    print(f"images: {len(pairs)}  mAP@0.5: {res['map50']:.4f}  "
          f"mAP@0.5:0.95: {res['map']:.4f}")
    for i, c in enumerate(res["classes"]):
        print(f"  class {int(c)}: AP50={res['ap'][i, 0]:.4f} "
              f"P={res['precision'][i]:.4f} R={res['recall'][i]:.4f}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
