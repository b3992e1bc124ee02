#!/usr/bin/env python3
"""GPU smoke run of the PyTorch port (hamer_yolo_tpu_torch) on one NVIDIA card.

    python3 chip_smoke.py

Run from the root of a checkout. It builds the port's CUDA kernels from
csrc/, checks each against its plain PyTorch twin on the card, drives the
exact-bf16 ``infer`` path at full width (YOLOv7 at 640, ViT-H with 32
blocks, the MANO head, 4 hand slots; seeded random weights, synthetic MANO)
through the runner and through one ``infer_frames`` batch, checks that the
path launched the kernels and that its outputs agree with the port's CPU
path on a small input, and times the path and each kernel beside its twin.

The last line of stdout is {"ok": true, "device": {...}}; the line before it
is the kernels' JSON record. Any failed phase raises and the script exits
non-zero. Without a CUDA device, or without the package beside it, it exits
non-zero before printing anything.
"""
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np

KERNELS = {
    "K1": {"name": "greedy_nms_keep", "route": "cuda",
           "source": "hamer_yolo_tpu_torch/csrc/nms.cu",
           "replaces": "hamer_yolo_tpu/ops/nms_pallas.py:62"},
    "K2": {"name": "fused_bf16_attn_block", "route": "cuda",
           "source": "hamer_yolo_tpu_torch/csrc/attn_block.cu",
           "replaces": "hamer_yolo_tpu/ops/attention_pallas.py:255"},
}
SEED = 0
N_FRAMES = 3          # frames through the runner (FrameProgram)
BATCH = 4             # frames in the infer_frames batch
TIMED_ITERS = 10
AXIS_ANGLE_KEYS = ("theta", "pose_hand", "pose_global")


def cuda_time_ms(fn, iters=TIMED_ITERS, warmup=2):
    """Median device time of fn() in ms, CUDA events around each call."""
    import torch

    for _ in range(warmup):
        fn()
    times = []
    for _ in range(iters):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


def frames_720p(n, seed):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 256, (720, 1280, 3), dtype=np.uint8) for _ in range(n)]


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    from hamer_yolo_tpu_torch.cli.main import pipeline_config
    from hamer_yolo_tpu_torch.core.checkpoint import init_pipeline_params
    from hamer_yolo_tpu_torch.core.mano_assets import synthetic_mano_model
    from hamer_yolo_tpu_torch.models.mano import ManoModel
    from hamer_yolo_tpu_torch.models.vit import embed_tokens
    from hamer_yolo_tpu_torch.ops import cuda_build
    from hamer_yolo_tpu_torch.ops import attn_block
    from hamer_yolo_tpu_torch.ops.attn_block import (check_against_twin, fused_bf16_attn_block,
                                                      fused_bf16_attn_block_ref)
    from hamer_yolo_tpu_torch.ops.nms import greedy_nms_keep, greedy_nms_keep_ref, nms_candidates
    from hamer_yolo_tpu_torch.pipeline.frame import detect_hands_batched, infer_frames
    from hamer_yolo_tpu_torch.pipeline.preprocess import device_letterbox, hamer_crop
    from hamer_yolo_tpu_torch.geometry.boxes import box_iou, hamer_box_params
    from hamer_yolo_tpu_torch.models.yolov7.model import yolov7_forward
    from hamer_yolo_tpu_torch.pipeline.runner import FrameProgram, default_intrinsics, process_frames

    dev = torch.device("cuda:0")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader",
                          "--id=0"], capture_output=True, text=True, check=True).stdout.strip()
    print(smi)  # the card's name and power limit, as nvidia-smi gives them
    print(f"torch {torch.__version__} cuda {torch.version.cuda} device "
          f"{torch.cuda.get_device_name(0)}", flush=True)

    # -- build ---------------------------------------------------------------
    t0 = time.perf_counter()
    libs = cuda_build.build_all()
    print(f"build: {time.perf_counter() - t0:.1f} s -> {', '.join(p.name for p in libs)}",
          flush=True)

    # -- full-width setup ----------------------------------------------------
    cfg = pipeline_config(tiny=False)
    t0 = time.perf_counter()
    params = init_pipeline_params(SEED, cfg.yolo, cfg.hamer, dev)
    mano = ManoModel.from_arrays(synthetic_mano_model(SEED), dev)
    torch.cuda.synchronize()
    print(f"init: full-width params in {time.perf_counter() - t0:.1f} s "
          f"(vit depth {len(params['hamer']['backbone']['blocks'])}, "
          f"embed {cfg.hamer.vit.embed_dim}, det {cfg.det_size}, slots {cfg.max_hands})")
    frames = frames_720p(max(N_FRAMES, BATCH), SEED)
    K = default_intrinsics(frames[0].shape)
    imgs = torch.from_numpy(np.stack(frames[:BATCH])).to(dev).to(torch.float32)
    hws = torch.tensor([[720.0, 1280.0]] * BATCH, device=dev)
    Ks = torch.from_numpy(np.stack([K] * BATCH)).to(dev)

    # -- main path: runner (npy + OBJ) and one infer_frames batch ------------
    greedy_nms_keep.launches = 0
    fused_bf16_attn_block.launches = 0
    with tempfile.TemporaryDirectory() as out_dir, torch.inference_mode():
        program = FrameProgram(params, mano, cfg, dev)
        stats = process_frames(((f"frame{i}", f) for i, f in enumerate(frames[:N_FRAMES])),
                               out_dir, program, K=K, progress=False)
        batch_out = infer_frames(params, mano, imgs, hws, Ks, cfg)
        torch.cuda.synchronize()
        launches = {"K1": greedy_nms_keep.launches, "K2": fused_bf16_attn_block.launches}
        npys = sorted(f for f in os.listdir(out_dir) if f.endswith(".npy"))
        objs = sorted(os.listdir(os.path.join(out_dir, "obj")))
    detector_calls = N_FRAMES + 1
    vit_forwards = N_FRAMES + 1
    depth = cfg.hamer.vit.depth
    print(f"main path: {stats.frames} frames, {stats.hands} hands via the runner -> "
          f"{len(npys)} npy, {len(objs)} obj; infer_frames batch {BATCH} -> "
          f"{int(batch_out['valid'].sum())} valid slots")
    print(f"launches: K1 {launches['K1']} (detector calls {detector_calls}), "
          f"K2 {launches['K2']} (ViT forwards {vit_forwards} x depth {depth})")
    if len(npys) != N_FRAMES or not objs:
        raise RuntimeError(f"runner wrote {len(npys)} npy and {len(objs)} obj files")
    if launches["K1"] < detector_calls:
        raise RuntimeError(f"K1 launched {launches['K1']} times for {detector_calls} detector calls")
    if launches["K2"] != depth * vit_forwards:
        raise RuntimeError(f"K2 launched {launches['K2']} times, expected {depth * vit_forwards}")
    for k, v in batch_out.items():
        if v.is_floating_point() and not torch.isfinite(v).all():
            raise RuntimeError(f"infer_frames output {k} is not finite")
    if batch_out["vertices"].shape != (BATCH, cfg.max_hands, 778, 3):
        raise RuntimeError(f"vertices shape {tuple(batch_out['vertices'].shape)}")
    if not batch_out["valid"].any():
        raise RuntimeError("no valid hand slot in the infer_frames batch")

    # -- the main path's own kernel inputs -----------------------------------
    with torch.inference_mode():
        lb, _, _ = device_letterbox(imgs, hws, cfg.det_size)
        pred = yolov7_forward(params["yolo"], lb.flip(-1) / 255.0, cfg.yolo)
        cand = nms_candidates(pred, cfg.conf_thres, cfg.classes, cfg.agnostic_nms,
                              cfg.max_nms_static)
        dets = detect_hands_batched(params["yolo"], imgs, hws, cfg)
        center, size = hamer_box_params(dets["boxes"])
        crops = hamer_crop(imgs, center, size, 1.0 - dets["is_right"], cfg.crop_size)
        crops = crops.reshape(-1, *crops.shape[2:])
        m = cfg.hamer.crop_margin
        tok0 = embed_tokens(params["hamer"]["backbone"], crops[:, :, m:-m, :], cfg.hamer.vit)
    blk0 = params["hamer"]["backbone"]["blocks"][0]
    k2_args = (blk0["attn"]["qkv"]["w"], blk0["attn"]["qkv"]["b"], blk0["norm1"]["scale"],
               blk0["norm1"]["bias"], cfg.hamer.vit.num_heads)

    # -- K1 against its twin -------------------------------------------------
    rng = np.random.default_rng(SEED)
    B1, K1n = 4, 512
    boxes = np.zeros((B1, K1n, 4), np.float32)
    boxes[..., :2] = rng.uniform(0, 600, (B1, K1n, 2))
    boxes[..., 2:] = boxes[..., :2] + rng.uniform(10, 120, (B1, K1n, 2))
    base = rng.uniform(0, 500, (B1, K1n // 4, 1, 2)).astype(np.float32)
    shift = rng.choice(np.float32([0.0, 0.25, 0.5, 0.75]), (B1, K1n // 4, 4, 2))
    xy1 = (base + shift).reshape(B1, K1n, 2)
    near = np.concatenate([xy1, xy1 + np.float32(40.0)], axis=-1).astype(np.float32)
    near_t = torch.from_numpy(near).to(dev)
    thr_near = float(box_iou(near_t[0, :1], near_t[0, 1:2])[0, 0])  # pairs sit on the threshold
    cases = {
        "random": (torch.from_numpy(boxes).to(dev),
                   torch.from_numpy((rng.uniform(0, 1, (B1, K1n)) > 0.2).astype(np.float32)).to(dev),
                   0.45),
        "at_threshold": (near_t, torch.ones((B1, K1n), device=dev), thr_near),
        "ragged_252": (torch.from_numpy(boxes[:, :252].copy()).to(dev),
                       torch.ones((B1, 252), device=dev), 0.45),
        "detector": (cand.shifted.contiguous(), cand.active.to(torch.float32), cfg.iou_thres),
    }
    k1_err = 0.0
    for name, (bx, act, thr) in cases.items():
        got = greedy_nms_keep(bx, act, thr)
        torch.cuda.synchronize()
        ref = greedy_nms_keep_ref(bx, act, thr)
        k1_err = max(k1_err, float((got - ref).abs().max()))
        if not torch.equal(got, ref):
            raise RuntimeError(f"K1 keep set differs from its twin on {name}: "
                               f"{int((got != ref).sum())} candidates")
        print(f"K1 {name}: B {bx.shape[0]} K {bx.shape[1]} keep sets identical "
              f"({int(got.sum())} kept of {int(act.sum())} active)")
    k1_bx, k1_act, k1_thr = cases["detector"]
    k1_ms = cuda_time_ms(lambda: greedy_nms_keep(k1_bx, k1_act, k1_thr))
    k1_plain_ms = cuda_time_ms(lambda: greedy_nms_keep_ref(k1_bx, k1_act, k1_thr), iters=3)

    # -- K2 against its twin -------------------------------------------------
    tok_rand = torch.from_numpy(rng.normal(size=(8, 192, 1280)).astype(np.float32)).to(dev)
    k2_cases = {"random_b8_bf16": tok_rand.to(torch.bfloat16), "random_b8_f32": tok_rand,
                "block0_tokens": tok0}
    print(f"K2 limits against its twin (ops/attn_block.py): every element within "
          f"{attn_block.MAX_ULPS} bf16 ulps of max(|twin|, mean |twin|); at most "
          f"{attn_block.MAX_FRAC_OVER_1ULP} of elements beyond 1 ulp of their own |twin|; "
          f"bf16 outputs: at most {attn_block.MAX_FRAC_DIFFERING} of elements differing")
    k2_err = 0.0
    for name, tok in k2_cases.items():
        got = fused_bf16_attn_block(tok, *k2_args)
        torch.cuda.synchronize()
        ref = fused_bf16_attn_block_ref(tok, *k2_args)
        r = check_against_twin(got, ref)
        k2_err = max(k2_err, r["max_abs_err"])
        print(f"K2 {name}: tokens {tuple(tok.shape)} {tok.dtype}, max |twin| "
              f"{float(ref.abs().max()):.4g}: " + ", ".join(f"{k} {v:.6g}" for k, v in r.items()))
    k2_ms = cuda_time_ms(lambda: fused_bf16_attn_block(tok0, *k2_args))
    k2_plain_ms = cuda_time_ms(lambda: fused_bf16_attn_block_ref(tok0, *k2_args))
    print(f"K2 timing at the main path's shape {tuple(tok0.shape)}: kernel {k2_ms:.4f} ms, "
          f"twin {k2_plain_ms:.4f} ms")
    print(f"K1 timing at the main path's shape {tuple(k1_bx.shape)}: kernel {k1_ms:.4f} ms, "
          f"twin {k1_plain_ms:.4f} ms")

    # -- end to end timing ---------------------------------------------------
    with torch.inference_mode():
        batch_ms = cuda_time_ms(lambda: infer_frames(params, mano, imgs, hws, Ks, cfg), iters=5)
        single = []
        for _ in range(2):
            program(frames[0], K)
        for _ in range(5):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            program(frames[0], K)  # ends in a device-to-host copy
            single.append((time.perf_counter() - t0) * 1e3)
    print(f"e2e infer_frames b{BATCH} 720p: p50 {batch_ms:.2f} ms = "
          f"{BATCH / batch_ms * 1e3:.2f} frames/s (CUDA events, 2 warm-up, 5 timed)")
    print(f"e2e FrameProgram single 720p frame incl. upload and copy back: p50 "
          f"{float(np.median(single)):.2f} ms (host clock, 2 warm-up, 5 timed)")

    # -- reference check on a small input: the card against the CPU path -----
    check_reference(dev)

    record = {"kernels": [
        dict(KERNELS["K1"], launches=launches["K1"], max_abs_err=k1_err, ms=k1_ms,
             plain_ms=k1_plain_ms),
        dict(KERNELS["K2"], launches=launches["K2"], max_abs_err=k2_err, ms=k2_ms,
             plain_ms=k2_plain_ms),
    ]}
    print(json.dumps(record))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


def check_reference(dev) -> None:
    """The port on the card against the port on the CPU on a small input.

    (1) The whole path at f32 (the tiny detector, a 2-block ViT at 192
    tokens with 4 heads of 16, the tiny MANO head) with the plain attention
    on both devices: K1 runs on the card, all else is the same torch code on
    two devices, so outputs agree to f32 sum order, at the JAX package's
    composed-oracle tolerances. (2) That ViT, in f32 and in bf16, with K2 on
    the card against K2's twin on the CPU, at the JAX package's bf16
    tolerance (K2 rounds to bf16 inside at either dtype). (K2 end to end is
    not compared: the MANO head's 6d -> Gram-Schmidt step divides by
    |a2 - (b1.a2) b1|, which random weights can make small, so one bf16 ulp
    of the head output moves a rotation element by ~0.06.)
    """
    import dataclasses

    import torch

    from hamer_yolo_tpu_torch.cli.main import pipeline_config
    from hamer_yolo_tpu_torch.core.checkpoint import init_pipeline_params
    from hamer_yolo_tpu_torch.core.mano_assets import synthetic_mano_model
    from hamer_yolo_tpu_torch.geometry.rotations import aa_to_rotmat
    from hamer_yolo_tpu_torch.models.mano import ManoModel
    from hamer_yolo_tpu_torch.models.vit import ViTConfig, vit_forward
    from hamer_yolo_tpu_torch.ops.attn_block import fused_bf16_attn_block
    from hamer_yolo_tpu_torch.ops.nms import greedy_nms_keep
    from hamer_yolo_tpu_torch.pipeline.frame import infer_frames

    tiny = pipeline_config(tiny=True, max_hands=2)
    vit32 = ViTConfig(embed_dim=64, depth=2, num_heads=4, compute_dtype="float32",
                      fused_attn=False)
    cfg = dataclasses.replace(
        tiny, crop_size=256,
        yolo=dataclasses.replace(tiny.yolo, compute_dtype="float32"),
        hamer=dataclasses.replace(tiny.hamer, image_size=256, crop_margin=32, vit=vit32))
    cpu = torch.device("cpu")
    params = init_pipeline_params(SEED, cfg.yolo, cfg.hamer, cpu)
    params_gpu = _to(params, dev)
    mano_np = synthetic_mano_model(SEED)
    rng = np.random.default_rng(SEED + 1)
    imgs = torch.from_numpy(rng.integers(0, 256, (2, 120, 160, 3)).astype(np.float32))
    hws = torch.tensor([[120.0, 160.0]] * 2)
    Ks = torch.from_numpy(np.stack([np.float32([[200, 0, 80], [0, 200, 60], [0, 0, 1]])] * 2))
    with torch.inference_mode():
        ref = infer_frames(params, ManoModel.from_arrays(mano_np, cpu), imgs, hws, Ks, cfg)
        before = greedy_nms_keep.launches
        got = infer_frames(params_gpu, ManoModel.from_arrays(mano_np, dev), imgs.to(dev),
                           hws.to(dev), Ks.to(dev), cfg)
        got = {k: v.cpu() for k, v in got.items()}
    if greedy_nms_keep.launches - before != 1:
        raise RuntimeError("the reference check did not run K1")
    n_valid = int(ref["valid"].sum())
    if n_valid == 0 or int(got["valid"].sum()) != n_valid:
        raise RuntimeError(f"valid slots: card {int(got['valid'].sum())}, cpu {n_valid}")
    worst = {}
    for b, s in zip(*np.nonzero(ref["valid"].numpy())):
        hit = np.nonzero((got["valid"][b] & (got["boxes"][b] == ref["boxes"][b, s]).all(-1))
                         .numpy())[0]
        if hit.size == 0:
            raise RuntimeError(f"reference box {ref['boxes'][b, s].tolist()} not found on the card")
        j = int(hit[0])
        for k, v in ref.items():
            if not v.is_floating_point():
                continue
            r, g = v[b, s].double(), got[k][b, j].double()
            # the JAX package's composed-oracle tolerances
            # (tests/test_composed_entrypoints.py:215-236)
            tol = 2e-3
            if k in AXIS_ANGLE_KEYS:
                # its aa tolerance, compared as rotations: axis-angle is
                # ill-conditioned near pi (axis sign, 2 pi wrap)
                r, g = (aa_to_rotmat(t.reshape(-1, 3)) for t in (r, g))
                tol = 5e-3
            torch.testing.assert_close(g, r, rtol=tol, atol=tol, msg=lambda m: f"{k}: {m}")
            worst[k] = max(worst.get(k, 0.0), float((g - r).abs().max()))
    print(f"reference check f32 (card vs CPU, small config, {n_valid} valid slots), max abs "
          "diff: " + ", ".join(f"{k} {v:.3g}" for k, v in sorted(worst.items())))

    x = torch.from_numpy(rng.normal(size=(4, 256, 192, 3)).astype(np.float32))
    for dtype in ("float32", "bfloat16"):
        vit = dataclasses.replace(vit32, compute_dtype=dtype, fused_attn=None)
        with torch.inference_mode():
            # K2's twin on the CPU
            ref = vit_forward(params["hamer"]["backbone"], x,
                              dataclasses.replace(vit, fused_attn=True)).float()
            before = fused_bf16_attn_block.launches
            got = vit_forward(params_gpu["hamer"]["backbone"], x.to(dev), vit)  # K2 by default
            got = got.float().cpu()
        if fused_bf16_attn_block.launches - before != vit.depth:
            raise RuntimeError(f"the {dtype} ViT on the card did not run K2 in every block")
        # bf16 roundings inside K2 on two devices, sums in other orders: the
        # JAX package's bf16 tolerance (tests/test_pallas_kernels.py:164-167)
        torch.testing.assert_close(got, ref, rtol=0.05, atol=0.05)
        print(f"reference check {dtype} ViT (K2 on the card vs its twin on the CPU, tokens "
              f"{tuple(got.shape)}): max abs diff {float((got - ref).abs().max()):.4g}, "
              f"max |ref| {float(ref.abs().max()):.4g}")


def _to(tree, dev):
    if isinstance(tree, dict):
        return {k: _to(v, dev) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_to(v, dev) for v in tree]
    return None if tree is None else tree.to(dev)


if __name__ == "__main__":
    sys.exit(main())
