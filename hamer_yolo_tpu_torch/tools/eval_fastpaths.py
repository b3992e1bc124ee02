"""Accuracy of the fast ViT paths (port of tools/eval_fastpaths.py).

  python -m hamer_yolo_tpu_torch.tools.eval_fastpaths [--device cuda]

The end-to-end HaMeR output deltas (MPVPE and 3D keypoint error in mm, the
largest camera difference) of each accelerated backbone against the exact
bf16 ViT (the plain layers, ``ViTConfig.fused_attn=False``) on the same
seeded full-size weights (ViT-H, 32 blocks; seed 0) and the same 8 crops of
256x256 (ImageNet-normalised noise), on the card unless ``--device`` names
another. The arms, JAX's tool's, each on the port's route:

- ``f32_vs_bf16``: the f32 ViT (the noise floor quantization must beat);
- ``tome_r2`` / ``tome_r4`` / ``tome_r8``: ToMe merging r tokens a block;
- ``int8``: W8A8 with dynamic scales (K5, K7 on the card);
- ``int8_tome_r4``: the same with ToMe r 4;
- ``int8_static``: W8A8 with static per-tensor scales calibrated on a
  held-out batch of 8 crops of 256x192 (K3, K4 on the card);
- ``int8_static_tome_r4``: the same with ToMe r 4;
- ``int8_static_mega`` / ``int8_static_mega_tome_r4``: JAX's "megakernel"
  arms, the port's path A (HYT_ATTN=megakernel, HYT_INT8_MLP=megakernel1:
  K6, K10 on the card);
- ``int8_static_megaproj``: JAX's "megaproj" arm, the port's static fused
  path under HYT_ATTN=megaproj (K3, K4);
- ``bf16_mega``: the bf16 ViT on its kernel (K2 on the card).

The int8 MLP's GELU is the one the port picks by device
(ops/int8_matmul.gelu_prologue: the polynomial on the card, the exact erf
elsewhere); the tool prints which, so JAX's separate
``int8_static_mega_gelu_poly`` arm is the ``int8_static_mega`` arm on the
card. Off the card the int8 arms run the unfused composition, as JAX's static
arm does. Not run, because their switches were left unported on purpose: the
``exp2`` softmaxes (HYT_SOFTMAX), the int8 attention products
(HYT_ATTN_MATH=int8), HYT_INT8_EP=bf16 and HYT_ATTN=pallas|auto.

Random weights: real-checkpoint deltas may differ; these pin each path's
numeric distortion at production shapes. Each arm's line also gives its
utils/profiling.benchmark p50 (``TIME_ITERS`` calls); the line before the
last is the JSON of the p50s, the last the JSON of the deltas.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import os
from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch

from hamer_yolo_tpu_torch.models.hamer import HamerConfig

PATH_A_ENV = {"HYT_ATTN": "megakernel", "HYT_INT8_MLP": "megakernel1"}
# arm: (printed label, weights, config changes, switches, the kernels it runs on the card)
ARMS: Dict[str, tuple] = {
    "f32_vs_bf16": ("f32(ctx)", "plain", {"dtype": "float32"}, {}, ()),
    "tome_r2": ("tome_r2", "plain", {"tome_r": 2}, {}, ()),
    "tome_r4": ("tome_r4", "plain", {"tome_r": 4}, {}, ()),
    "tome_r8": ("tome_r8", "plain", {"tome_r": 8}, {}, ()),
    "int8": ("w8a8_int8", "dynamic", {"int8": True}, {}, ("K5", "K7")),
    "int8_tome_r4": ("int8+tome_r4", "dynamic", {"int8": True, "tome_r": 4}, {}, ("K5", "K7")),
    "int8_static": ("int8_static", "static", {"int8": True}, {}, ("K3", "K4")),
    "int8_static_tome_r4": ("int8_sta+tome4", "static", {"int8": True, "tome_r": 4}, {},
                            ("K3", "K4")),
    "int8_static_mega": ("int8_sta_mega", "static", {"int8": True}, PATH_A_ENV, ("K6", "K10")),
    "int8_static_mega_tome_r4": ("int8_mega+tom4", "static", {"int8": True, "tome_r": 4},
                                 PATH_A_ENV, ("K6", "K10")),
    "int8_static_megaproj": ("int8_megaproj", "static", {"int8": True},
                             {"HYT_ATTN": "megaproj"}, ("K3", "K4")),
    "bf16_mega": ("bf16_mega", "plain", {"kernels": True}, {}, ("K2",)),
}
OUTPUTS = ("pred_vertices", "pred_keypoints_3d", "pred_cam")
TIME_ITERS = 10


@contextlib.contextmanager
def switches(env: Dict[str, str]):
    """The environment switches ``env`` set for the block, then restored."""
    old = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    try:
        yield
    finally:
        for k, v in old.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def base_config(cfg: HamerConfig) -> HamerConfig:
    """``cfg`` with the ViT on its plain layers: the exact baseline."""
    return dataclasses.replace(cfg, vit=dataclasses.replace(cfg.vit, fused_attn=False))


def arm_config(cfg: HamerConfig, arm: str) -> HamerConfig:
    """The HaMeR config an arm runs: int8 arms and ``bf16_mega`` pick the
    kernels by device (fused_attn None), the others keep the plain layers."""
    ch = ARMS[arm][2]
    vit = dataclasses.replace(cfg.vit, fused_attn=None if ch.get("int8") or ch.get("kernels")
                              else False, compute_dtype=ch.get("dtype", cfg.vit.compute_dtype))
    return dataclasses.replace(cfg, vit=vit, int8_backbone=bool(ch.get("int8")),
                               tome_r=ch.get("tome_r", 0))


def arm_weights(params, cfg: HamerConfig, calib: torch.Tensor) -> Dict[str, dict]:
    """{"plain", "dynamic", "static"} trees: the ViT quantized, and with
    static scales calibrated on ``calib`` (held-out crops, (B, 256, 192, 3))."""
    from hamer_yolo_tpu_torch.core.quant import (attach_static_act_scales,
                                                 collect_vit_act_stats, quantize_vit_params)

    with torch.inference_mode():
        q = quantize_vit_params(params["backbone"])
        stats = collect_vit_act_stats(q, calib, cfg.vit)
    return {"plain": params, "dynamic": {**params, "backbone": q},
            "static": {**params, "backbone": attach_static_act_scales(q, stats)}}


def arm_forward(arm: Optional[str], trees: Dict[str, dict], mano, cfg: HamerConfig
                ) -> Tuple[Callable, Dict[str, str]]:
    """(crops -> the HaMeR outputs, the switches to hold while it runs) of an
    arm; ``arm`` None is the exact bf16 baseline."""
    from hamer_yolo_tpu_torch.models.hamer import hamer_forward

    if arm is None:
        c, tree, env = base_config(cfg), trees["plain"], {}
    else:
        c, tree, env = arm_config(cfg, arm), trees[ARMS[arm][1]], ARMS[arm][3]

    def fn(crops):
        with torch.inference_mode():
            return hamer_forward(tree, mano, crops, c)

    return fn, env


def run_arm(arm: Optional[str], trees, mano, cfg: HamerConfig, crops: torch.Tensor
            ) -> Dict[str, np.ndarray]:
    """An arm's outputs (f64 numpy) on ``crops``."""
    fn, env = arm_forward(arm, trees, mano, cfg)
    with switches(env):
        out = fn(crops)
    return {k: out[k].double().cpu().numpy() for k in OUTPUTS}


def delta(base: Dict[str, np.ndarray], other: Dict[str, np.ndarray]) -> Dict[str, float]:
    """JAX's readings of an arm against the baseline: mean vertex and joint
    distances in mm, the largest |d cam|."""
    mpvpe = np.linalg.norm(other["pred_vertices"] - base["pred_vertices"], axis=-1).mean() * 1e3
    kp3d = np.linalg.norm(other["pred_keypoints_3d"] - base["pred_keypoints_3d"],
                          axis=-1).mean() * 1e3
    cam = np.abs(other["pred_cam"] - base["pred_cam"]).max()
    return {"mpvpe_mm": round(float(mpvpe), 4), "kp3d_mm": round(float(kp3d), 4),
            "cam_maxd": round(float(cam), 5)}


def inputs(device, crops_n: int = 8, size: int = 256, calib_hw=(256, 192)):
    """The evaluation crops (seed 0) and the held-out calibration crops (seed 1)."""
    crops = np.random.default_rng(0).standard_normal((crops_n, size, size, 3)).astype(np.float32)
    calib = np.random.default_rng(1).standard_normal((crops_n, *calib_hw, 3)).astype(np.float32)
    return torch.from_numpy(crops).to(device), torch.from_numpy(calib).to(device)


def evaluate(params, mano, cfg: HamerConfig, crops, calib
             ) -> Tuple[Dict[str, dict], Dict[str, float]]:
    """({arm: its deltas}, {arm: its benchmark p50 ms}), a line printed an arm."""
    from hamer_yolo_tpu_torch.utils.profiling import benchmark

    trees = arm_weights(params, cfg, calib)
    base = run_arm(None, trees, mano, cfg, crops)
    results, p50 = {}, {}
    for arm in ARMS:
        d = results[arm] = delta(base, run_arm(arm, trees, mano, cfg, crops))
        fn, env = arm_forward(arm, trees, mano, cfg)
        with switches(env):
            p50[arm] = benchmark(fn, crops, iters=TIME_ITERS)["p50_ms"]
        print(f"{ARMS[arm][0]:<14s} MPVPE {d['mpvpe_mm']:8.4f} mm   kp3d {d['kp3d_mm']:8.4f} mm   "
              f"cam max|d| {d['cam_maxd']:.5f}   p50 {p50[arm]:.3f} ms")
    return results, p50


def main(argv: Optional[list] = None) -> int:
    from hamer_yolo_tpu_torch.cli.main import load_mano
    from hamer_yolo_tpu_torch.models.hamer import init_hamer
    from hamer_yolo_tpu_torch.ops.int8_matmul import gelu_prologue

    p = argparse.ArgumentParser(prog="eval_fastpaths", description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--device", default="cuda",
                   help="torch device (default: the card; cpu for a machine without one)")
    args = p.parse_args(argv)
    device = torch.device(args.device)
    cfg = HamerConfig()
    mano = load_mano(None, device)
    gen = torch.Generator(device=device)
    gen.manual_seed(0)
    params = init_hamer(gen, cfg)
    crops, calib = inputs(device)
    print(f"int8 MLP GELU: {gelu_prologue(device)} ({device.type})")
    results, p50 = evaluate(params, mano, cfg, crops, calib)
    print(json.dumps({"p50_ms": p50}))
    print(json.dumps(results))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
