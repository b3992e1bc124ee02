"""Command line (port of hamer_yolo_tpu/cli/main.py, ``infer`` only):

  python -m hamer_yolo_tpu_torch.cli.main infer --input imgs/ --output out/
      [--intrinsics cam_K.txt] [--tiny] [--device cuda]
      [--fast-path int8 [--calib-scales scales.npz]]

image dir -> per-image .npy MANO dicts + obj/<name>.obj meshes. Weights
come from a random init seeded with 0; MANO from assets/mano_right.npz when
present, else the seeded synthetic model. It runs on the card unless
``--device`` names another device; without a card, pass ``--device cpu``.

``--fast-path int8`` quantizes the ViT's block linears to W8A8 int8
(core/quant.py); ``--calib-scales`` attaches the static activation scales
of a stats file written by ``hamer_yolo_tpu_torch.tools.calibrate_int8``
(or by the JAX package's tools/calibrate_int8.py: the format is shared).
"""
from __future__ import annotations

import argparse
import dataclasses
import sys
from typing import Optional

import torch

from hamer_yolo_tpu_torch.core.checkpoint import init_pipeline_params
from hamer_yolo_tpu_torch.core.mano_assets import load_mano_model, synthetic_mano_model
from hamer_yolo_tpu_torch.core.quant import (attach_static_act_scales, load_act_stats,
                                             quantize_vit_params)
from hamer_yolo_tpu_torch.models.hamer import HamerConfig
from hamer_yolo_tpu_torch.models.mano import ManoModel
from hamer_yolo_tpu_torch.models.mano_head import ManoHeadConfig
from hamer_yolo_tpu_torch.models.vit import ViTConfig
from hamer_yolo_tpu_torch.models.yolov7.model import YoloConfig
from hamer_yolo_tpu_torch.pipeline.frame import PipelineConfig
from hamer_yolo_tpu_torch.pipeline.runner import process_image_dir


def pipeline_config(tiny: bool = False, max_hands: int = 4, conf_thres: float = 0.25,
                    iou_thres: float = 0.35) -> PipelineConfig:
    """The default full-width pipeline, or the scaled-down ``--tiny`` one."""
    if not tiny:
        return PipelineConfig(max_hands=max_hands, conf_thres=conf_thres, iou_thres=iou_thres)
    return PipelineConfig(
        max_hands=max_hands, conf_thres=conf_thres, iou_thres=iou_thres,
        det_size=64, crop_size=64,
        yolo=YoloConfig(nc=3, img_size=64),
        hamer=HamerConfig(
            image_size=64, crop_margin=8,
            vit=ViTConfig(img_size=(64, 48), embed_dim=64, depth=2, num_heads=4),
            head=ManoHeadConfig(dim=32, context_dim=64, depth=2, heads=2, dim_head=8,
                                mlp_dim=32),
        ),
    )


def load_mano(mano_dir: Optional[str], device) -> ManoModel:
    try:
        data = load_mano_model("right", mano_dir)
    except (OSError, KeyError, ValueError) as e:
        print(f"warning: MANO assets unavailable ({e}); using synthetic model", file=sys.stderr)
        data = synthetic_mano_model()
    return ManoModel.from_arrays(data, device)


def apply_fast_path(params, cfg: PipelineConfig, fast_path: str = "none",
                    calib_scales: Optional[str] = None):
    """``--fast-path``: "int8" quantizes the backbone (and attaches the
    static scales of ``calib_scales``) and turns on the int8 backbone."""
    if fast_path == "none":
        if calib_scales:
            raise ValueError("--calib-scales needs --fast-path int8")
        return params, cfg
    if fast_path != "int8":
        raise ValueError(f"unknown fast path {fast_path!r}")
    backbone = quantize_vit_params(params["hamer"]["backbone"])
    if calib_scales:
        backbone = attach_static_act_scales(backbone, load_act_stats(calib_scales))
    params = {**params, "hamer": {**params["hamer"], "backbone": backbone}}
    return params, dataclasses.replace(
        cfg, hamer=dataclasses.replace(cfg.hamer, int8_backbone=True))


def cmd_infer(args) -> int:
    device = torch.device(args.device)
    cfg = pipeline_config(args.tiny, args.max_hands, args.conf_thres, args.iou_thres)
    mano = load_mano(args.mano_dir, device)
    params = init_pipeline_params(0, cfg.yolo, cfg.hamer, device)
    params, cfg = apply_fast_path(params, cfg, args.fast_path, args.calib_scales)
    stats = process_image_dir(args.input, args.output, params, mano, cfg,
                              intrinsics_path=args.intrinsics, save_obj=not args.no_obj,
                              device=device)
    print(f"processed {stats.frames} frames / {stats.hands} hands "
          f"({stats.skipped} skipped) in {stats.total_s:.1f}s")
    return 0


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(prog="hamer_yolo_tpu_torch")
    sub = parser.add_subparsers(dest="cmd", required=True)
    p = sub.add_parser("infer", help="full pipeline over an image dir")
    p.add_argument("--input", required=True)
    p.add_argument("--output", required=True)
    p.add_argument("--intrinsics", default=None, help="cam_K.txt path")
    p.add_argument("--no-obj", action="store_true")
    p.add_argument("--mano-dir", default=None, help="dir with MANO_*.pkl")
    p.add_argument("--max-hands", type=int, default=4)
    p.add_argument("--conf-thres", type=float, default=0.25)
    p.add_argument("--iou-thres", type=float, default=0.35)
    p.add_argument("--tiny", action="store_true", help="scaled-down models (CPU smoke)")
    p.add_argument("--device", default="cuda",
                   help="torch device (default: the card; cpu for a machine without one)")
    p.add_argument("--fast-path", default="none", choices=("none", "int8"),
                   help="int8: W8A8 int8 ViT blocks (K3/K4 with --calib-scales, else K5/K7)")
    p.add_argument("--calib-scales", default=None, metavar="NPZ",
                   help="static activation scales (calibrate_int8 stats) for --fast-path int8")
    p.set_defaults(fn=cmd_infer)
    return parser


def main(argv: Optional[list] = None) -> int:
    args = build_parser().parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    raise SystemExit(main())
