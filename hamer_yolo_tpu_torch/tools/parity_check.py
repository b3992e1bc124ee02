"""Numerical parity checker (port of tools/parity_check.py; the reference's
compare_pytorch_onnx: np.allclose at atol / rtol 1e-3 over named outputs,
hamer/infer.py:674-736).

  capture  run HaMeR (seeded weights) on seeded crops, save the named
           outputs and the input to an .npz
  compare  run it again on the captured input and compare every output
           (allclose, atol / rtol 1e-3 by default; per-output max abs / rel)

  python -m hamer_yolo_tpu_torch.tools.parity_check capture out.npz --tiny --device cpu
  python -m hamer_yolo_tpu_torch.tools.parity_check compare out.npz --tiny --device cuda

For CPU-against-card parity and regression pinning: the seeded weights are
drawn on the CPU and then moved, so that every device runs the same ones (a
torch generator on the card draws other numbers), and the ViT runs its plain
layers on every device (``fused_attn=False``, the JAX tool's path on the
CPU), so that every device computes the same math: K2 computes in bf16, and
its outputs would part from the CPU's by bf16 roundings (about 1e-2 at
``--tiny``), beyond the default 1e-3. The npz layout and the output names are the
JAX tool's (``__input__`` and HAMER_OUTPUT_NAMES); the port's seeded
weights are its own, so a capture of the JAX tool compares with weights
bridged from JAX's (``build_hamer(params=)``).
"""
from __future__ import annotations

import argparse
from typing import Optional

import numpy as np

HAMER_OUTPUT_NAMES = (
    "pred_cam", "pred_cam_t", "focal_length", "pred_keypoints_3d",
    "pred_vertices", "pred_keypoints_2d", "betas",
)


def build_hamer(seed: int = 0, tiny: bool = False, device="cuda", params=None):
    """(fn: (B, S, S, 3) float32 numpy crops -> {name: numpy output}, cfg):
    HaMeR on ``device`` with the seeded weights (``params``: given ones), the
    ViT on its plain layers."""
    import dataclasses

    import torch

    from hamer_yolo_tpu_torch.cli.main import load_mano
    from hamer_yolo_tpu_torch.models.hamer import HamerConfig, hamer_forward, init_hamer
    from hamer_yolo_tpu_torch.tools.train_hamer import tiny_config
    from hamer_yolo_tpu_torch.training.optim import map_tree

    device = torch.device(device)
    cfg = tiny_config() if tiny else HamerConfig()
    cfg = dataclasses.replace(cfg, vit=dataclasses.replace(cfg.vit, fused_attn=False))
    mano = load_mano(None, device)
    if params is None:
        gen = torch.Generator()
        gen.manual_seed(seed)
        params = map_tree(lambda t: t.to(device), init_hamer(gen, cfg))

    def fn(img: np.ndarray):
        with torch.inference_mode():
            out = hamer_forward(params, mano, torch.from_numpy(img).to(device), cfg)
        return {k: out[k].float().cpu().numpy() for k in HAMER_OUTPUT_NAMES}

    return fn, cfg


def capture(path: str, fn, cfg, seed: int = 0, batch: int = 1) -> int:
    rng = np.random.default_rng(seed)
    img = rng.normal(size=(batch, cfg.image_size, cfg.image_size, 3)).astype(np.float32)
    out = fn(img)
    np.savez(path, __input__=img, **out)
    print(f"captured {len(out)} outputs -> {path}")
    return 0


def compare(path: str, fn, atol: float = 1e-3, rtol: float = 1e-3) -> int:
    """0 where every output of the capture is within the tolerance, else 1."""
    data = np.load(path)
    out = fn(data["__input__"])
    failures = 0
    for k in data.files:
        if k == "__input__":
            continue
        got, ref = out[k], data[k]
        max_abs = float(np.abs(got - ref).max())
        max_rel = float((np.abs(got - ref) / np.maximum(np.abs(ref), 1e-6)).max())
        ok = np.allclose(got, ref, atol=atol, rtol=rtol)
        print(f"{k:<22s} max_abs={max_abs:.2e} max_rel={max_rel:.2e} {'OK' if ok else 'FAIL'}")
        failures += 0 if ok else 1
    if failures:
        print(f"{failures} output(s) out of tolerance")
        return 1
    print("all outputs within tolerance")
    return 0


def main(argv: Optional[list] = None) -> int:
    p = argparse.ArgumentParser(prog="parity_check")
    sub = p.add_subparsers(dest="cmd", required=True)
    for name in ("capture", "compare"):
        sp = sub.add_parser(name)
        sp.add_argument("path")
        sp.add_argument("--seed", type=int, default=0)
        sp.add_argument("--batch", type=int, default=1)
        sp.add_argument("--tiny", action="store_true")
        sp.add_argument("--atol", type=float, default=1e-3)
        sp.add_argument("--rtol", type=float, default=1e-3)
        sp.add_argument("--device", default="cuda",
                        help="torch device (default: the card; cpu for a machine without one)")
    args = p.parse_args(argv)
    fn, cfg = build_hamer(args.seed, args.tiny, args.device)
    if args.cmd == "capture":
        return capture(args.path, fn, cfg, args.seed, args.batch)
    return compare(args.path, fn, args.atol, args.rtol)


if __name__ == "__main__":
    raise SystemExit(main())
