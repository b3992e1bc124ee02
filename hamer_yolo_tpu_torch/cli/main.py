"""Command line (port of hamer_yolo_tpu/cli/main.py):

  infer        image dir -> per-image .npy MANO dicts + obj/<name>.obj meshes
               [--intrinsics cam_K.txt] [--depth-refine] [--batch N]
               [--mask-dir DIR [--mask-value V] [--mask-hand right|left]]
               [--profile DIR] [--no-obj]
  serve        batched video / image-dir / glob processing, one line a batch
               [--batch 16] [--max-frames N] [--upload-dtype uint8|float32]
               [--multi: --input is a comma list of live sources, one batch
               a tick [--detect-every K]] [--intrinsics cam_K.txt]
  serve-http   POST /infer an image, get its hands as JSON, with dynamic
               micro-batching [--host H] [--port P] [--batch 8]
               [--max-wait-ms MS] [--intrinsics cam_K.txt]
  detect       hand boxes only, one JSON line per image
               [--save-txt DIR [--save-conf]] [--augment: 3-scale + flip TTA]
  depth        RootNet's absolute root depth, one JSON line per image
  reconstruct  saved .npy dir -> .obj meshes
  rgbd         RGB-D KeypointFusion on one RGB + depth frame and a hand box, one
               JSON line: --rgb IMG --depth NPY|PNG (--bbox x,y,w,h |
               --bbox-file TXT) [--kpf-checkpoint PTH] [--seed S] [--device]

Every subcommand but rgbd takes [--tiny] [--device cuda] [--checkpoint NPZ]
[--mano-dir DIR] [--max-hands N] [--conf-thres T] [--iou-thres T] and the
ViT's fast paths [--fast-path none|int8|tome|int8-tome [--tome-r R]
[--calib-scales NPZ]].

Weights come from ``--checkpoint``, a port checkpoint (core/checkpoint.py:
made from the reference's torch files by core/convert, or from a JAX orbax
checkpoint), applied before a fast path quantizes; without one, or where its
path does not exist (a warning on stderr, as in JAX), from a random init
seeded with 0. A checkpoint leaf the port has no rule for raises. MANO comes
from assets/mano_right.npz when present, else the seeded synthetic model. It runs
on the card unless ``--device`` names another device; without a card, pass
``--device cpu``. On the card every program runs as a captured CUDA graph per
bucket (pipeline/captured.py).

``--fast-path int8`` quantizes the ViT's block linears to W8A8 int8
(core/quant.py); ``--calib-scales`` attaches the static activation scales
of a stats file written by ``hamer_yolo_tpu_torch.tools.calibrate_int8``
(or by the JAX package's tools/calibrate_int8.py: the format is shared).
``tome`` merges ``--tome-r`` tokens after each ViT block (models/tome.py);
``int8-tome`` does both. Not ported yet (ROADMAP.md, Queue 1): ``detect
--save-img``, ``reconstruct --overlay-images``, ``--int8-yolo``, and the
``bench`` subcommand.

``rgbd`` (models/kpfusion_rgbd/runtime.py) takes KPFusion's weights from the
reference's ``.pth`` (``--kpf-checkpoint``, through core/convert), else a
random init seeded with 0 (a warning on stderr), and samples the point cloud
with ``np.random.RandomState(--seed)``. cv2 reads the RGB image, and the
depth unless it is a ``.npy`` file.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import os
import sys
from typing import Optional

import numpy as np
import torch

from hamer_yolo_tpu_torch.core.bridge import from_jax_params
from hamer_yolo_tpu_torch.core.checkpoint import init_pipeline_params, load_checkpoint
from hamer_yolo_tpu_torch.core.mano_assets import load_mano_model, synthetic_mano_model
from hamer_yolo_tpu_torch.core.quant import (attach_static_act_scales, load_act_stats,
                                             quantize_vit_params)
from hamer_yolo_tpu_torch.io.writers import load_hand_npy, load_intrinsics
from hamer_yolo_tpu_torch.models.hamer import HamerConfig
from hamer_yolo_tpu_torch.models.kpfusion_rgbd.model import KPFusionConfig, init_kpfusion
from hamer_yolo_tpu_torch.models.mano import ManoModel
from hamer_yolo_tpu_torch.models.mano_head import ManoHeadConfig
from hamer_yolo_tpu_torch.models.sar import SarConfig
from hamer_yolo_tpu_torch.models.vit import ViTConfig
from hamer_yolo_tpu_torch.models.yolov7.model import YoloConfig
from hamer_yolo_tpu_torch.pipeline.frame import PipelineConfig
from hamer_yolo_tpu_torch.pipeline.reconstruct import reconstruct_and_save_obj
from hamer_yolo_tpu_torch.pipeline.runner import (FrameProgram, default_intrinsics,
                                                  process_image_dir, process_masked_dir,
                                                  read_images)
from hamer_yolo_tpu_torch.utils.profiling import trace

FAST_PATHS = ("none", "int8", "tome", "int8-tome")


def pipeline_config(tiny: bool = False, max_hands: int = 4, conf_thres: float = 0.25,
                    iou_thres: float = 0.35, depth_refine: bool = False) -> PipelineConfig:
    """The default full-width pipeline, or the scaled-down ``--tiny`` one."""
    if not tiny:
        return PipelineConfig(max_hands=max_hands, conf_thres=conf_thres, iou_thres=iou_thres,
                              use_depth_refine=depth_refine)
    return PipelineConfig(
        max_hands=max_hands, conf_thres=conf_thres, iou_thres=iou_thres,
        det_size=64, crop_size=64, use_depth_refine=depth_refine,
        yolo=YoloConfig(nc=3, img_size=64),
        hamer=HamerConfig(
            image_size=64, crop_margin=8,
            vit=ViTConfig(img_size=(64, 48), embed_dim=64, depth=2, num_heads=4),
            head=ManoHeadConfig(dim=32, context_dim=64, depth=2, heads=2, dim_head=8,
                                mlp_dim=32),
        ),
        sar=SarConfig(backbone="resnet34", input_size=64, feature_hw=2, heatmap_size=8),
    )


def load_mano(mano_dir: Optional[str], device) -> ManoModel:
    try:
        data = load_mano_model("right", mano_dir)
    except (OSError, KeyError, ValueError) as e:
        print(f"warning: MANO assets unavailable ({e}); using synthetic model", file=sys.stderr)
        data = synthetic_mano_model()
    return ManoModel.from_arrays(data, device)


def apply_fast_path(params, cfg: PipelineConfig, fast_path: str = "none",
                    calib_scales: Optional[str] = None, tome_r: int = 4):
    """``--fast-path``: "int8" quantizes the backbone (and attaches the
    static scales of ``calib_scales``) and turns on the int8 backbone;
    "tome" sets ``tome_r`` tokens merged per ViT layer; "int8-tome" both."""
    if fast_path not in FAST_PATHS:
        raise ValueError(f"unknown fast path {fast_path!r}")
    if calib_scales and "int8" not in fast_path:
        raise ValueError("--calib-scales needs --fast-path int8 or int8-tome")
    hcfg = cfg.hamer
    if "int8" in fast_path:
        backbone = quantize_vit_params(params["hamer"]["backbone"])
        if calib_scales:
            backbone = attach_static_act_scales(backbone, load_act_stats(calib_scales))
        params = {**params, "hamer": {**params["hamer"], "backbone": backbone}}
        hcfg = dataclasses.replace(hcfg, int8_backbone=True)
    if "tome" in fast_path:
        hcfg = dataclasses.replace(hcfg, tome_r=tome_r)
    return params, dataclasses.replace(cfg, hamer=hcfg)


def load_runtime(args):
    """(params, MANO model, config, device) for a subcommand's arguments:
    the weights of ``--checkpoint`` or the seeded init, then the fast path."""
    device = torch.device(args.device)
    cfg = pipeline_config(args.tiny, args.max_hands, args.conf_thres, args.iou_thres,
                          getattr(args, "depth_refine", False))
    mano = load_mano(args.mano_dir, device)
    if args.checkpoint and os.path.exists(args.checkpoint):
        params = load_checkpoint(args.checkpoint, device)
    else:
        if args.checkpoint:
            print(f"warning: checkpoint {args.checkpoint} not found; random init",
                  file=sys.stderr)
        params = init_pipeline_params(0, mano, cfg.yolo, cfg.hamer, cfg.sar, device=device)
    if getattr(args, "augment", False):
        cfg = dataclasses.replace(cfg, tta=True)
    params, cfg = apply_fast_path(params, cfg, args.fast_path, args.calib_scales, args.tome_r)
    return params, mano, cfg, device


def cmd_infer(args) -> int:
    params, mano, cfg, device = load_runtime(args)
    prof = trace(args.profile, device) if args.profile else contextlib.nullcontext()
    with prof:
        if args.mask_dir:
            stats = process_masked_dir(args.input, args.mask_dir, args.output, params, mano, cfg,
                                       intrinsics_path=args.intrinsics,
                                       mask_value=args.mask_value, mask_hand=args.mask_hand,
                                       save_obj=not args.no_obj, device=device)
        else:
            stats = process_image_dir(args.input, args.output, params, mano, cfg,
                                      intrinsics_path=args.intrinsics, save_obj=not args.no_obj,
                                      device=device, batch_size=args.batch)
    print(f"processed {stats.frames} frames / {stats.hands} hands "
          f"({stats.skipped} skipped) in {stats.total_s:.1f}s")
    return 0


def cmd_serve(args) -> int:
    """Batched processing of a video file / image dir / glob, or with
    ``--multi`` of N live sources, one batch a tick."""
    from hamer_yolo_tpu_torch.io.video import iter_media
    from hamer_yolo_tpu_torch.pipeline.serving import BatchedPipeline

    params, mano, cfg, device = load_runtime(args)
    K = load_intrinsics(args.intrinsics) if args.intrinsics else None
    K = K if K is not None else default_intrinsics((720, 1280))
    if args.multi:
        sources = [int(s) if s.isdigit() else s for s in args.input.split(",")]
        pipe = BatchedPipeline(params, mano, cfg, batch_size=len(sources),
                               detect_every=args.detect_every, upload_dtype=args.upload_dtype,
                               device=device)
        for tick in pipe.stream_multi(sources, K, max_batches=args.max_frames):
            n = int(np.asarray(tick["outputs"]["valid"]).sum())
            det = f" (detected: {tick['detected']})" if "detected" in tick else ""
            print(f"tick: sources {tick['source_idx']}, {n} hands{det}")
    else:
        pipe = BatchedPipeline(params, mano, cfg, batch_size=args.batch,
                               upload_dtype=args.upload_dtype, device=device)
        for out in pipe.stream(iter_media(args.input, args.max_frames), K):
            n = int(np.asarray(out["valid"]).sum())
            print(f"batch: {out['boxes'].shape[0]} frames, {n} hands")
    stats = pipe.last_stats
    print(f"{stats.frames} frames in {stats.total_s:.1f}s = {stats.fps:.1f} fps")
    return 0


def cmd_serve_http(args) -> int:
    """The HTTP front end over a BatchedPipeline (pipeline/http_server.py),
    until interrupted or shut down."""
    from hamer_yolo_tpu_torch.pipeline import http_server
    from hamer_yolo_tpu_torch.pipeline.serving import BatchedPipeline

    params, mano, cfg, device = load_runtime(args)
    K = load_intrinsics(args.intrinsics) if args.intrinsics else None
    pipe = BatchedPipeline(params, mano, cfg, batch_size=args.batch, device=device)
    srv = http_server.make_http_server(pipe, args.host, args.port, K_default=K,
                                       max_wait_ms=args.max_wait_ms)
    print(f"serving on http://{args.host}:{srv.server_address[1]} "
          f"(batch {args.batch}, window {args.max_wait_ms} ms); "
          "POST /infer, GET /healthz /stats", flush=True)
    try:
        srv.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        srv.server_close()
        srv.batcher.close()
    return 0


def detections(out) -> list:
    """One frame's valid slots as JSON-able records, slot order."""
    return [{"label": "right" if out["is_right"][i] > 0.5 else "left",
             "box": out["boxes"][i].tolist(), "score": float(out["scores"][i]),
             "class": int(out["classes"][i])}
            for i in range(len(out["valid"])) if out["valid"][i]]


def yolo_label_lines(dets: list, h: int, w: int, save_conf: bool = False) -> list:
    """The reference detect.py --save-txt rows: cls x_c y_c w h [conf],
    normalised by the image size, '%g' rendering."""
    lines = []
    for d in dets:
        x1, y1, x2, y2 = d["box"]
        row = [d["class"], (x1 + x2) / 2 / w, (y1 + y2) / 2 / h, (x2 - x1) / w, (y2 - y1) / h]
        if save_conf:
            row.append(d["score"])
        lines.append(" ".join(f"{v:g}" for v in row))
    return lines


def cmd_detect(args) -> int:
    params, mano, cfg, device = load_runtime(args)
    program = FrameProgram(params, mano, cfg, device)
    if args.save_txt:
        os.makedirs(args.save_txt, exist_ok=True)
    for name, img in read_images(args.input):
        if img is None:
            continue
        dets = detections(program(img.astype(np.float32), default_intrinsics(img.shape)))
        if args.save_txt:
            lines = yolo_label_lines(dets, *img.shape[:2], args.save_conf)
            with open(os.path.join(args.save_txt, os.path.splitext(name)[0] + ".txt"),
                      "w") as f:
                f.write("\n".join(lines) + ("\n" if lines else ""))
        print(json.dumps({"image": name, "detections": dets}))
    return 0


def cmd_depth(args) -> int:
    params, mano, cfg, device = load_runtime(args)
    program = FrameProgram(params, mano, cfg, device)
    K = load_intrinsics(args.intrinsics) if args.intrinsics else None
    for name, img in read_images(args.input):
        if img is None:
            continue
        out = program(img.astype(np.float32), K if K is not None else default_intrinsics(img.shape))
        depths = [float(out["root_depth"][i]) for i in range(len(out["valid"]))
                  if out["valid"][i]]
        print(json.dumps({"image": name, "root_depths": depths}))
    return 0


def cmd_reconstruct(args) -> int:
    mano = load_mano(args.mano_dir, torch.device(args.device))
    os.makedirs(args.output, exist_ok=True)
    count = 0
    for f in sorted(os.listdir(args.input)):
        if not f.endswith(".npy"):
            continue
        results = load_hand_npy(os.path.join(args.input, f))
        obj_path = os.path.join(args.output, f.replace(".npy", ".obj"))
        if reconstruct_and_save_obj(mano, results, obj_path) is not None:
            count += 1
    print(f"wrote {count} OBJ files to {args.output}")
    return 0


def cmd_rgbd(args) -> int:
    """RGB-D KeypointFusion inference (Model_RGBD.estimate_pose_RGBD): the
    final joints in the original image's uvd and in metric xyz, and the
    hand's center, as one JSON line."""
    from hamer_yolo_tpu_torch.models.kpfusion_rgbd.runtime import RGBDRuntime

    if not args.bbox and not args.bbox_file:
        print("error: rgbd needs --bbox x,y,w,h or --bbox-file", file=sys.stderr)
        return 2
    device = torch.device(args.device)
    cfg = KPFusionConfig()
    if args.kpf_checkpoint:
        from hamer_yolo_tpu_torch.core.convert import convert_kpfusion_checkpoint

        params = from_jax_params(convert_kpfusion_checkpoint(args.kpf_checkpoint), device)
    else:
        print("warning: no --kpf-checkpoint; random weights", file=sys.stderr)
        gen = torch.Generator(device=device)
        gen.manual_seed(0)
        params = init_kpfusion(gen, cfg)

    import cv2

    rgb = cv2.imread(args.rgb)
    if rgb is None:
        print(f"error: cannot read RGB image {args.rgb}", file=sys.stderr)
        return 2
    if args.depth.endswith(".npy"):
        depth = np.load(args.depth)
    else:
        depth = cv2.imread(args.depth, cv2.IMREAD_ANYDEPTH)
        if depth is None:
            print(f"error: cannot read depth image {args.depth}", file=sys.stderr)
            return 2
    depth = depth.astype(np.float32)
    if args.bbox_file:
        # the reference's wild-test fixtures hold normalized CENTER boxes:
        # cx, cy, w, h in fractions of the image
        v = np.loadtxt(args.bbox_file).reshape(-1)[:4]
        H, W = depth.shape[:2]
        bw, bh = v[2] * W, v[3] * H
        bbox = [v[0] * W - bw / 2, v[1] * H - bh / 2, bw, bh]
    else:
        bbox = [float(x) for x in args.bbox.split(",")]

    rt = RGBDRuntime(params, cfg, device)
    out = rt.estimate_pose_rgbd(rgb.astype(np.float32), depth, bbox,
                                np.random.RandomState(args.seed))
    print(json.dumps({"joint_uvd_full": out["joint_uvd_full"].tolist(),
                      "joint_xyz_world": out["joint_xyz_world"].tolist(),
                      "center": np.asarray(out["center"]).tolist()}))
    return 0


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(prog="hamer_yolo_tpu_torch", description=__doc__,
                                     formatter_class=argparse.RawDescriptionHelpFormatter)
    sub = parser.add_subparsers(dest="cmd", required=True)

    def common(p):
        p.add_argument("--mano-dir", default=None, help="dir with MANO_*.pkl")
        p.add_argument("--max-hands", type=int, default=4)
        p.add_argument("--conf-thres", type=float, default=0.25)
        p.add_argument("--iou-thres", type=float, default=0.35)
        p.add_argument("--tiny", action="store_true", help="scaled-down models (CPU smoke)")
        p.add_argument("--device", default="cuda",
                       help="torch device (default: the card; cpu for a machine without one)")
        p.add_argument("--checkpoint", default=None, metavar="NPZ",
                       help="port checkpoint (core/checkpoint.save_checkpoint's .npz)")
        p.add_argument("--fast-path", default="none", choices=FAST_PATHS,
                       help="int8: W8A8 int8 ViT blocks (K3/K4 with --calib-scales, else "
                            "K5/K7); tome: --tome-r tokens merged per ViT block; int8-tome: both")
        p.add_argument("--tome-r", type=int, default=4,
                       help="tokens merged per ViT block for --fast-path tome / int8-tome")
        p.add_argument("--calib-scales", default=None, metavar="NPZ",
                       help="static activation scales (calibrate_int8 stats) for --fast-path "
                            "int8 / int8-tome")

    p = sub.add_parser("infer", help="full pipeline over an image dir")
    common(p)
    p.add_argument("--input", required=True)
    p.add_argument("--output", required=True)
    p.add_argument("--intrinsics", default=None, help="cam_K.txt path")
    p.add_argument("--depth-refine", action="store_true",
                   help="force tz to RootNet's depth (the reference's d_infer.py)")
    p.add_argument("--no-obj", action="store_true")
    p.add_argument("--batch", type=int, default=1,
                   help="frames per device call (> 1: serving.BatchedPipeline; same per-image "
                        "outputs)")
    p.add_argument("--mask-dir", default=None,
                   help="dir of per-image .npy masks (bypasses the detector)")
    p.add_argument("--mask-value", type=int, default=3)
    p.add_argument("--mask-hand", default="right", choices=["left", "right"])
    p.add_argument("--profile", default=None, metavar="DIR",
                   help="write a torch.profiler trace of the run to DIR/trace.json")
    p.set_defaults(fn=cmd_infer)

    p = sub.add_parser("serve", help="batched video / stream processing")
    common(p)
    p.add_argument("--input", required=True, help="video file / image dir / glob")
    p.add_argument("--intrinsics", default=None, help="cam_K.txt path")
    p.add_argument("--batch", type=int, default=16)
    p.add_argument("--max-frames", type=int, default=None)
    p.add_argument("--multi", action="store_true",
                   help="treat --input as a comma list of N live sources (capture index / "
                        "file / URL); one batch a tick across all sources")
    p.add_argument("--detect-every", type=int, default=1,
                   help="with --multi: run the detector every K-th tick per source, tracking "
                        "boxes from the previous tick's keypoints in between")
    p.add_argument("--upload-dtype", default=None, choices=["uint8", "float32"],
                   help="pin the frame upload dtype (default: uint8 when every frame of a "
                        "batch is uint8); a pinned dtype keeps a stray float frame from "
                        "capturing a second program")
    p.set_defaults(fn=cmd_serve)

    p = sub.add_parser("serve-http", help="HTTP endpoint: POST /infer an image, get hands "
                                          "JSON (dynamic micro-batching)")
    common(p)
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--port", type=int, default=8100)
    p.add_argument("--batch", type=int, default=8, help="most frames in one micro-batch")
    p.add_argument("--max-wait-ms", type=float, default=15.0,
                   help="micro-batch collection window")
    p.add_argument("--intrinsics", default=None, help="cam_K.txt path")
    p.set_defaults(fn=cmd_serve_http)

    p = sub.add_parser("detect", help="hand detection only")
    common(p)
    p.add_argument("--input", required=True)
    p.add_argument("--save-txt", default=None, metavar="DIR",
                   help="write per-image YOLO label txt (detect.py --save-txt format: "
                        "cls x_c y_c w h, normalized)")
    p.add_argument("--save-conf", action="store_true",
                   help="append confidence to --save-txt rows")
    p.add_argument("--augment", action="store_true",
                   help="3-scale + flip detector TTA (detect.py --augment)")
    p.set_defaults(fn=cmd_detect)

    p = sub.add_parser("depth", help="RootNet absolute depth only")
    common(p)
    p.add_argument("--input", required=True)
    p.add_argument("--intrinsics", default=None)
    p.set_defaults(fn=cmd_depth)

    p = sub.add_parser("reconstruct", help=".npy dir -> .obj meshes")
    common(p)
    p.add_argument("--input", required=True)
    p.add_argument("--output", required=True)
    p.set_defaults(fn=cmd_reconstruct)

    p = sub.add_parser("rgbd", help="RGB-D KeypointFusion inference (Model_RGBD equivalent)")
    p.add_argument("--rgb", required=True, help="RGB image path")
    p.add_argument("--depth", required=True, help="depth image (.npy / 16-bit png, mm)")
    p.add_argument("--bbox", default=None, help="x,y,w,h")
    p.add_argument("--bbox-file", default=None,
                   help="txt with a normalized center box cx cy w h (the reference's "
                        "test/20_bbox.txt fixtures)")
    p.add_argument("--kpf-checkpoint", default=None, help="KPFusion .pth (Model_RGBD format)")
    p.add_argument("--seed", type=int, default=0,
                   help="point-cloud sampling seed (deterministic output)")
    p.add_argument("--device", default="cuda",
                   help="torch device (default: the card; cpu for a machine without one)")
    p.set_defaults(fn=cmd_rgbd)
    return parser


def main(argv: Optional[list] = None) -> int:
    args = build_parser().parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    raise SystemExit(main())
