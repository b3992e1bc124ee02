"""HaMeR training (port of tools/train_hamer.py).

  python -m hamer_yolo_tpu_torch.tools.train_hamer --steps 100 [--batch 8] [--lr 1e-5]
      [--synthetic] [--tiny] [--out runs/hamer] [--resume PATH|auto]
      [--viz-every 100] [--ckpt-every 50] [--device cuda]
  torchrun --nproc-per-node N -m hamer_yolo_tpu_torch.tools.train_hamer --devices N [--tp T] ...

The adversarial two-optimizer step of training/train_hamer.py on seeded
random weights (the default HamerConfig, ViT-H; ``--tiny`` the JAX tool's
small config), on the card unless ``--device`` names another. Training
uses synthetic batches, and does so even where ``--tars`` is given, as the
JAX tool does (ROADMAP.md, F23): the tar reader comes with the data
pipeline. Every 10th step appends the losses to ``<out>/metrics.jsonl``;
every ``--viz-every`` steps a forward without gradient (the ViT's kernel on
the card) draws the predicted 2D keypoints on the batch's crops into
``<out>/images/pred_grid_<step>.png`` (cv2; skipped without it); every
``--ckpt-every`` steps and at the end the train state goes to
``<out>/ckpt_<step>.npz`` / ``ckpt_final.npz``, from which ``--resume auto``
goes on. ``--devices N`` (0: every process torchrun started, one a device)
with ``--tp T`` trains data parallel over N / T ranks and tensor parallel
over T (parallel/mesh.py; the JAX tool's mesh): the batch must split over
the data axis, or the run falls back to one device, as JAX's does. Only
rank 0 logs, draws and saves.
"""
from __future__ import annotations

import argparse
import contextlib
import os
import time
from typing import Optional

import numpy as np
import torch

from hamer_yolo_tpu_torch.models.hamer import HamerConfig
from hamer_yolo_tpu_torch.models.mano_head import ManoHeadConfig
from hamer_yolo_tpu_torch.models.vit import ViTConfig


def tiny_config() -> HamerConfig:
    """The JAX tool's --tiny HaMeR (f32)."""
    return HamerConfig(
        image_size=64, crop_margin=8,
        vit=ViTConfig(img_size=(64, 48), embed_dim=64, depth=2, num_heads=4,
                      compute_dtype="float32"),
        head=ManoHeadConfig(dim=32, context_dim=64, depth=2, heads=2, dim_head=8, mlp_dim=32))


def main(argv: Optional[list] = None) -> int:
    from hamer_yolo_tpu_torch.parallel.mesh import leave_distributed, tool_mesh

    p = argparse.ArgumentParser(prog="train_hamer")
    p.add_argument("--steps", type=int, default=100)
    p.add_argument("--batch", type=int, default=8)
    p.add_argument("--lr", type=float, default=1e-5)
    p.add_argument("--synthetic", action="store_true", help="random batches (the default)")
    p.add_argument("--tars", default=None,
                   help="glob of webdataset-style tars (read by nothing yet: synthetic batches)")
    p.add_argument("--devices", type=int, default=0,
                   help="devices, one process each under torchrun; 0: all of them")
    p.add_argument("--tp", type=int, default=1, help="model-axis size")
    p.add_argument("--tiny", action="store_true", help="tiny ViT (smoke)")
    p.add_argument("--out", default="runs/hamer")
    p.add_argument("--resume", default=None, help="a checkpoint, or auto: the run's latest")
    p.add_argument("--viz-every", type=int, default=100,
                   help="log a keypoint grid of the predictions every N steps; 0 disables")
    p.add_argument("--ckpt-every", type=int, default=50)
    p.add_argument("--device", default="cuda",
                   help="torch device (default: the card; cpu for a machine without one)")
    args = p.parse_args(argv)
    try:
        mesh, device, rank = tool_mesh(
            args.devices, args.batch, args.device, args.tp,
            "batch {batch} not divisible by the data axis ({n}); running single-device")
    except ValueError as e:
        p.error(str(e))
    try:
        return 0 if mesh is None and rank else train(args, mesh, device, rank == 0)
    finally:
        leave_distributed()


def train(args, mesh, device: torch.device, lead: bool) -> int:
    from hamer_yolo_tpu_torch.cli.main import load_mano
    from hamer_yolo_tpu_torch.core.checkpoint import latest_checkpoint
    from hamer_yolo_tpu_torch.models.hamer import hamer_forward
    from hamer_yolo_tpu_torch.training.train_hamer import (init_train_state, load_train_state,
                                                           save_train_state, synthetic_batch,
                                                           train_step)
    from hamer_yolo_tpu_torch.utils.logging import MetricLogger
    from hamer_yolo_tpu_torch.utils.viz import render_eval_grid

    cfg = tiny_config() if args.tiny else HamerConfig()
    say = print if lead else (lambda *a, **k: None)
    mano = load_mano(None, device)
    gen = torch.Generator(device=device)
    gen.manual_seed(0)
    state = init_train_state(gen, cfg, args.lr)
    resume = latest_checkpoint(args.out) if args.resume == "auto" else args.resume
    if resume and os.path.exists(resume):
        load_train_state(resume, state)
        say(f"resumed at step {state.step}")
    if not args.synthetic and not args.tars:
        say("no --tars given; defaulting to --synthetic batches")
    elif args.tars:
        say("--tars: the tar reader is not ported; training on --synthetic batches")

    os.makedirs(args.out, exist_ok=True)
    batch_gen = torch.Generator(device=device)
    batch_gen.manual_seed(1)
    t0 = time.time()
    with MetricLogger(args.out) if lead else contextlib.nullcontext() as logger:
        for step in range(state.step, args.steps):
            batch = synthetic_batch(batch_gen, args.batch, cfg)
            metrics = train_step(state, batch, mano, cfg, mesh=mesh)
            if step % 10 == 0 and lead:
                logger.log(step, {k: float(v) for k, v in metrics.items()})
                print(f"step {step}: total={float(metrics['total']):.4f} "
                      f"kp2d={float(metrics['keypoints_2d']):.4f} "
                      f"disc={float(metrics['disc_loss']):.4f}")
            if args.viz_every and step % args.viz_every == 0 and lead:
                n = min(8, args.batch)
                with torch.no_grad():
                    kp2d = hamer_forward(state.params, mano, batch["img"][:n],
                                         cfg)["pred_keypoints_2d"].float().cpu().numpy()
                crops = batch["img"][:n].cpu().numpy()
                S = crops.shape[1]
                # pred_keypoints_2d is crop-normalised, in [-0.5, 0.5]
                grid = render_eval_grid(np.clip(crops * 0.25 + 0.5, 0, 1),
                                        (kp2d[:, :, :2] + 0.5) * S)
                logger.log_image(step, "pred_grid", grid)
            if step and step % args.ckpt_every == 0 and lead:
                save_train_state(os.path.join(args.out, f"ckpt_{step}.npz"), state)
        if lead:
            save_train_state(os.path.join(args.out, "ckpt_final.npz"), state)
    say(f"done in {time.time() - t0:.0f}s -> {args.out}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
