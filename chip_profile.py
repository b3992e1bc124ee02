#!/usr/bin/env python3
"""Where the time goes in the port's ``infer`` paths on one GPU.

    python3 chip_profile.py [--batches 1 4 16]
                            [--paths bf16 int8-static int8-dynamic path-a path-b]
                            [--out chiprun_out] [--root DIR]

Run from the root of a checkout on a machine with an NVIDIA card. For each
batch size B it builds the full-width path of ``chip_smoke.py`` (YOLOv7 at
640, ViT-H with 32 blocks, the MANO head, 4 hand slots; seeded random
weights, synthetic MANO) on B numpy-made 720p frames and prints one JSON line:

- ``e2e_ms``: median of ``infer_frames`` over the batch, CUDA events around
  each call (2 warm-up, 5 timed), and ``frames_per_s`` from it;
- ``stage_ms``: the same median for each stage called alone on the batch's
  own inputs: letterbox, yolo, nms, depth (the RootNet stage:
  ``estimate_depths``, SAR patches and the ResNet-34 over all B*S slots),
  crops, the ViT on its kernel path and on its plain path (bf16: K2 against
  nn's attention; int8: K3 + K4, or K5 + K7, against the unfused
  composition), and the whole HaMeR forward;
- from ``torch.profiler`` over 3 calls of ``infer_frames``:
  ``device_ms_per_batch`` (device time of every kernel and copy per call),
  ``launches_per_batch`` (device events per call) and the device ms per call
  of each kernel that took 1% or more; the full table goes to
  ``<out>/profile_<path>_b<B>.txt``. ``busy`` is device_ms_per_batch over e2e_ms:
  the profiler slows the host loop, so the profiled calls' own wall time
  (``profiled_wall_ms_per_batch``) would understate it.

Paths: ``bf16`` (the exact path), ``int8-static`` (the int8 ViT with the
static scales calibrated on the batch's own crops), ``int8-dynamic`` (the
int8 ViT without scales), and the opt-in kernel paths of ``chip_smoke.py``:
``path-a`` (int8-static under HYT_ATTN=megakernel, HYT_INT8_MLP=megakernel1
and ``fused_mano``: K6, K10, K9) and ``path-b`` (int8-dynamic under
HYT_ATTN=pallas_fusedqkv: K5, K8). The first line is the card's name and power limit
as nvidia-smi gives them. ``--root DIR`` imports hamer_yolo_tpu_torch from DIR
(default: this script's checkout), so two commits compare in one chip call,
in turns on one card (parent, new, new, parent):

    for r in OLD . . OLD; do python3 chip_profile.py --paths path-a --root $r; done

with OLD a directory that .gitignore lists, holding the other commit
(``git archive <commit> | tar -x -C OLD``). Each JSON line names its root.
"""
import argparse
import dataclasses
import json
import os
import subprocess
import sys

import numpy as np

from chip_smoke import PATH_A_ENV, PATH_B_ENV, SEED, cuda_time_ms, frames_720p, switches

PROFILED_CALLS = 3


def profile_batch(B, params, mano, cfg, dev, out_dir, path="bf16"):
    import torch
    from torch.profiler import ProfilerActivity, profile

    from hamer_yolo_tpu_torch.cli.main import apply_fast_path
    from hamer_yolo_tpu_torch.core.quant import attach_static_act_scales, vit_forward_int8
    from hamer_yolo_tpu_torch.geometry.boxes import hamer_box_params
    from hamer_yolo_tpu_torch.models.hamer import hamer_forward
    from hamer_yolo_tpu_torch.models.vit import vit_forward
    from hamer_yolo_tpu_torch.models.yolov7.model import yolov7_forward
    from hamer_yolo_tpu_torch.ops.nms import non_max_suppression
    from hamer_yolo_tpu_torch.pipeline import frame
    from hamer_yolo_tpu_torch.pipeline.frame import detect_hands_batched, infer_frames
    from hamer_yolo_tpu_torch.pipeline.preprocess import device_letterbox, hamer_crop
    from hamer_yolo_tpu_torch.pipeline.runner import default_intrinsics
    from hamer_yolo_tpu_torch.tools.calibrate_int8 import calibrate_frames

    frames = frames_720p(B, SEED)
    if path != "bf16":
        qparams, cfg = apply_fast_path(params, cfg, "int8")
        if path == "path-a":
            cfg = dataclasses.replace(cfg, hamer=dataclasses.replace(cfg.hamer, fused_mano=True))
        if path in ("int8-static", "path-a"):
            stats, _ = calibrate_frames(params, frames, cfg, dev, batch=4 * B)
            qparams["hamer"]["backbone"] = attach_static_act_scales(
                qparams["hamer"]["backbone"], stats)
        params = qparams
    imgs = torch.from_numpy(np.stack(frames)).to(dev).to(torch.float32)
    hws = torch.tensor([[720.0, 1280.0]] * B, device=dev)
    Ks = torch.from_numpy(np.stack([default_intrinsics(frames[0].shape)] * B)).to(dev)
    hp, vcfg, m = params["hamer"], cfg.hamer.vit, cfg.hamer.crop_margin
    with torch.inference_mode():
        lb, _, _ = device_letterbox(imgs, hws, cfg.det_size)
        rgb = lb.flip(-1) / 255.0
        pred = yolov7_forward(params["yolo"], rgb, cfg.yolo)
        dets = detect_hands_batched(params["yolo"], imgs, hws, cfg)
        center, size = hamer_box_params(dets["boxes"])
        flip = 1.0 - dets["is_right"]
        crops = hamer_crop(imgs, center, size, flip, cfg.crop_size)
        crops = crops.reshape(-1, *crops.shape[2:])
        body = crops[:, :, m:-m, :]
        plain = dataclasses.replace(vcfg, fused_attn=False)
        vit = vit_forward_int8 if path != "bf16" else vit_forward
        stages = {
            "letterbox": lambda: device_letterbox(imgs, hws, cfg.det_size),
            "yolo": lambda: yolov7_forward(params["yolo"], rgb, cfg.yolo),
            "nms": lambda: non_max_suppression(
                pred, conf_thres=cfg.conf_thres, iou_thres=cfg.iou_thres, classes=cfg.classes,
                agnostic=cfg.agnostic_nms, max_det=cfg.max_hands,
                max_nms_static=cfg.max_nms_static),
            "depth": lambda: frame.estimate_depths(params["sar"], imgs, dets, hws, Ks, cfg),
            "crops": lambda: hamer_crop(imgs, center, size, flip, cfg.crop_size),
            "vit_kernels": lambda: vit(hp["backbone"], body, vcfg),
            "vit_plain": lambda: vit(hp["backbone"], body, plain),
            "hamer_fwd": lambda: hamer_forward(hp, mano, crops, cfg.hamer),
        }
        stage_ms = {k: cuda_time_ms(fn, iters=5) for k, fn in stages.items()}
        run = lambda: infer_frames(params, mano, imgs, hws, Ks, cfg)  # noqa: E731
        e2e_ms = cuda_time_ms(run, iters=5)

        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(PROFILED_CALLS):
                run()
            end.record()
            torch.cuda.synchronize()
    wall_ms = start.elapsed_time(end)
    dev_events = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    device_ms = sum(e.time_range.elapsed_us() for e in dev_events) / 1e3
    per_kernel = {}
    for e in dev_events:
        per_kernel[e.name] = per_kernel.get(e.name, 0.0) + e.time_range.elapsed_us() / 1e3
    top = {k[:80]: v / PROFILED_CALLS for k, v in sorted(per_kernel.items(), key=lambda kv: -kv[1])
           if v >= 0.01 * device_ms}
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, f"profile_{path}_b{B}.txt"), "w") as f:
        f.write(prof.key_averages().table(sort_by="self_device_time_total", row_limit=60))
    return {"path": path, "B": B, "e2e_ms": e2e_ms, "frames_per_s": B / e2e_ms * 1e3,
            "stage_ms": stage_ms, "busy": device_ms / PROFILED_CALLS / e2e_ms,
            "launches_per_batch": len(dev_events) / PROFILED_CALLS,
            "device_ms_per_batch": device_ms / PROFILED_CALLS,
            "profiled_wall_ms_per_batch": wall_ms / PROFILED_CALLS, "kernel_ms_per_batch": top}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--batches", type=int, nargs="+", default=[1, 4, 16])
    ap.add_argument("--paths", nargs="+", default=["bf16"],
                    choices=["bf16", "int8-static", "int8-dynamic", "path-a", "path-b"])
    ap.add_argument("--out", default="chiprun_out")
    ap.add_argument("--root", default=os.path.dirname(os.path.abspath(__file__)))
    args = ap.parse_args()
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)
    import hamer_yolo_tpu_torch

    if os.path.dirname(os.path.dirname(os.path.abspath(hamer_yolo_tpu_torch.__file__))) != root:
        raise RuntimeError(f"imported {hamer_yolo_tpu_torch.__file__}, not the package in {root}")

    import torch

    if not torch.cuda.is_available():
        print("chip_profile: no CUDA device", file=sys.stderr)
        return 1
    from hamer_yolo_tpu_torch.cli.main import pipeline_config
    from hamer_yolo_tpu_torch.core.checkpoint import init_pipeline_params
    from hamer_yolo_tpu_torch.core.mano_assets import synthetic_mano_model
    from hamer_yolo_tpu_torch.models.mano import ManoModel

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader",
                          "--id=0"], capture_output=True, text=True, check=True).stdout.strip())
    dev = torch.device("cuda:0")
    cfg = pipeline_config(tiny=False)
    mano = ManoModel.from_arrays(synthetic_mano_model(SEED), dev)
    params = init_pipeline_params(SEED, mano, cfg.yolo, cfg.hamer, cfg.sar, device=dev)
    for path in args.paths:
        for B in args.batches:
            env = {"path-a": PATH_A_ENV, "path-b": PATH_B_ENV}.get(path, {})
            with switches(env):
                print(json.dumps({"root": root, **profile_batch(B, params, mano, cfg, dev,
                                                                 args.out, path)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
