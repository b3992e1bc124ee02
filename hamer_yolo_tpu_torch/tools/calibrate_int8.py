"""Calibrate the int8 ViT's static activation scales on images (port of
tools/calibrate_int8.py).

The detector runs over the frames; the HaMeR crops the pipeline would feed
the ViT (detect -> hamer_box_params -> hamer_crop -> centre crop) go through
the unfused int8 forward, which records the absmax of every quantized GEMM
input (core/quant.collect_vit_act_stats, K7 on the card); the stats are
max-reduced over all batches and saved as the .npz that

  python -m hamer_yolo_tpu_torch.cli.main infer ... --fast-path int8 --calib-scales scales.npz

reads (the JAX package's format: either package reads the other's file).

  python -m hamer_yolo_tpu_torch.tools.calibrate_int8 --input imgs/ --out scales.npz \\
      [--max-images 64] [--batch 8] [--tiny] [--device cuda]

Reading the images (cv2) is split from ``calibrate_frames``, which takes
BGR uint8 frames, so a machine without cv2 can calibrate too.
"""
from __future__ import annotations

import argparse
import sys
from typing import Iterable, Optional, Tuple

import numpy as np
import torch

from hamer_yolo_tpu_torch.core.quant import (collect_vit_act_stats, max_act_stats,
                                             quantize_vit_params, save_act_stats)
from hamer_yolo_tpu_torch.geometry.boxes import hamer_box_params
from hamer_yolo_tpu_torch.pipeline.frame import PipelineConfig, detect_hands_batched
from hamer_yolo_tpu_torch.pipeline.preprocess import hamer_crop


@torch.inference_mode()
def frame_crops(yolo_params, frame_bgr: np.ndarray, cfg: PipelineConfig,
                device) -> torch.Tensor:
    """The ViT inputs (n, H, W - 2 margin, 3) of one frame's valid hand slots."""
    img = torch.from_numpy(np.ascontiguousarray(frame_bgr)).to(device).to(torch.float32)[None]
    hw = torch.tensor([frame_bgr.shape[:2]], dtype=torch.float32, device=device)
    det = detect_hands_batched(yolo_params, img, hw, cfg)
    center, size = hamer_box_params(det["boxes"])
    crops = hamer_crop(img, center, size, 1.0 - det["is_right"], cfg.crop_size)[0]
    m = cfg.hamer.crop_margin
    return crops[det["valid"][0]][:, :, m:-m, :]


@torch.inference_mode()
def calibrate_frames(params, frames: Iterable[np.ndarray], cfg: PipelineConfig, device,
                     batch: int = 8) -> Tuple[Optional[dict], int]:
    """(stats max-reduced over batches of ``batch`` crops, crops seen) for
    BGR uint8 frames; stats is None when no frame had a valid hand."""
    qbackbone = quantize_vit_params(params["hamer"]["backbone"])
    vit_cfg = cfg.hamer.vit
    stats, n_crops, pending = None, 0, []

    def flush(crops):
        nonlocal stats, n_crops
        s = collect_vit_act_stats(qbackbone, torch.cat(crops), vit_cfg)
        stats = s if stats is None else max_act_stats(stats, s)
        n_crops += sum(c.shape[0] for c in crops)

    for frame in frames:
        pending.append(frame_crops(params["yolo"], frame, cfg, device))
        while sum(c.shape[0] for c in pending) >= batch:
            allc = torch.cat(pending)
            flush([allc[:batch]])
            pending = [allc[batch:]]
    if pending and sum(c.shape[0] for c in pending):
        flush(pending)
    return stats, n_crops


def main(argv: Optional[list] = None) -> int:
    from hamer_yolo_tpu_torch.cli.main import load_mano, pipeline_config
    from hamer_yolo_tpu_torch.core.checkpoint import init_pipeline_params
    from hamer_yolo_tpu_torch.pipeline.runner import read_images

    p = argparse.ArgumentParser(prog="calibrate_int8")
    p.add_argument("--input", required=True, help="calibration image dir")
    p.add_argument("--out", required=True, help="output stats .npz")
    p.add_argument("--max-images", type=int, default=64)
    p.add_argument("--batch", type=int, default=8, help="crops per calibration pass")
    p.add_argument("--tiny", action="store_true")
    p.add_argument("--device", default="cuda",
                   help="torch device (default: the card; cpu for a machine without one)")
    args = p.parse_args(argv)

    device = torch.device(args.device)
    cfg = pipeline_config(args.tiny)
    params = init_pipeline_params(0, load_mano(None, device), cfg.yolo, cfg.hamer,
                                  with_sar=False, device=device)
    images = [img for _, img in read_images(args.input) if img is not None][:args.max_images]
    stats, n_crops = calibrate_frames(params, images, cfg, device, args.batch)
    if stats is None:
        print("error: no valid hand crops found in the calibration set", file=sys.stderr)
        return 1
    save_act_stats(args.out, stats)
    print(f"calibrated on {n_crops} crops from {len(images)} images -> {args.out}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
