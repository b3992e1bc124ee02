"""KPFusion RGB-D training (port of tools/train_kpfusion_rgbd.py).

  python -m hamer_yolo_tpu_torch.tools.train_kpfusion_rgbd --steps 200 [--batch 4]
      [--lr 8e-4] [--tiny] [--out runs/kpfusion_rgbd] [--resume PATH|auto]
      [--ckpt-every 100] [--log-every 10] [--device cuda]

The train step of training/train_kpfusion_rgbd.py on seeded random weights
(the default KPFusionConfig; ``--tiny`` the JAX tool's small one) and
synthetic batches (plausibly scaled random samples), on the card unless
``--device`` names another. The spatial-weight gate takes step * batch //
1000 as the epoch. Every ``--log-every`` steps the losses go to
``<out>/metrics.jsonl``; every ``--ckpt-every`` steps and at the end the
train state to ``<out>/ckpt_<step>.npz`` / ``ckpt_final.npz``, from which
``--resume auto`` goes on. Not ported yet: ``--data`` with ``--depth-fmt``,
``--data-format`` and ``--augment`` (the RGB-D datasets, ROADMAP.md Queue 1
item 6), and ``--devices`` above 1 (Queue 1 item 8).
"""
from __future__ import annotations

import argparse
import os
import time
from typing import Optional

import numpy as np
import torch

from hamer_yolo_tpu_torch.models.kpfusion_rgbd.model import KPFusionConfig


def tiny_config() -> KPFusionConfig:
    """The JAX tool's --tiny KPFusion."""
    return KPFusionConfig(img_size=32, feature_size=8, dim=32, sample_num=64, num_stages=1,
                          heads=2)


def main(argv: Optional[list] = None) -> int:
    from hamer_yolo_tpu_torch.core.checkpoint import latest_checkpoint
    from hamer_yolo_tpu_torch.training.train_kpfusion_rgbd import (
        init_train_state, load_train_state, save_train_state, synthetic_rgbd_batch, train_step)
    from hamer_yolo_tpu_torch.utils.logging import MetricLogger

    p = argparse.ArgumentParser(prog="train_kpfusion_rgbd")
    p.add_argument("--steps", type=int, default=200)
    p.add_argument("--batch", type=int, default=4)
    p.add_argument("--lr", type=float, default=8e-4)   # config.py:60
    p.add_argument("--tiny", action="store_true", help="scaled-down net (smoke)")
    p.add_argument("--data", default=None, help="RGB-D sample dir (not ported yet)")
    p.add_argument("--depth-fmt", default=None, help="with --data (not ported yet)")
    p.add_argument("--data-format", default=None, help="with --data (not ported yet)")
    p.add_argument("--augment", action="store_true", help="with --data (not ported yet)")
    p.add_argument("--devices", type=int, default=0)
    p.add_argument("--out", default="runs/kpfusion_rgbd")
    p.add_argument("--resume", default=None, help="a checkpoint, or auto: the run's latest")
    p.add_argument("--ckpt-every", type=int, default=100)
    p.add_argument("--log-every", type=int, default=10)
    p.add_argument("--device", default="cuda",
                   help="torch device (default: the card; cpu for a machine without one)")
    args = p.parse_args(argv)
    if args.data or args.depth_fmt or args.data_format or args.augment:
        p.error("--data, --depth-fmt, --data-format and --augment: the RGB-D datasets are not "
                "ported (ROADMAP.md, Queue 1 item 6); training runs on synthetic batches")
    if args.devices > 1:
        p.error("--devices above 1: data parallelism is not ported (ROADMAP.md, Queue 1 item 8)")

    device = torch.device(args.device)
    cfg = tiny_config() if args.tiny else KPFusionConfig()
    gen = torch.Generator(device=device)
    gen.manual_seed(0)
    state = init_train_state(gen, cfg, args.lr)
    resume = latest_checkpoint(args.out) if args.resume == "auto" else args.resume
    if resume and os.path.exists(resume):
        load_train_state(resume, state)
        print(f"resumed from {resume} at step {state.step}")

    os.makedirs(args.out, exist_ok=True)
    rng = np.random.default_rng(0)
    t0 = time.time()
    with MetricLogger(args.out) as logger:
        for step in range(state.step, args.steps):
            batch = {k: torch.from_numpy(v).to(device)
                     for k, v in synthetic_rgbd_batch(rng, args.batch, cfg).items()}
            # the epoch of the spatial-weight gate (train.py:250)
            metrics = train_step(state, batch, cfg, epoch=step * args.batch // 1000)
            if step % args.log_every == 0:
                logger.log(step, {k: float(v) for k, v in metrics.items()})
                print(f"step {step}: loss={float(metrics['loss']):.4f} "
                      f"coord_d={float(metrics['coord_d']):.4f} "
                      f"kfam0={float(metrics['coord_kfam_0']):.4f}")
            if step and step % args.ckpt_every == 0:
                save_train_state(os.path.join(args.out, f"ckpt_{step}.npz"), state)
        save_train_state(os.path.join(args.out, "ckpt_final.npz"), state)
    print(f"done: {args.steps} steps in {time.time() - t0:.0f}s -> {args.out}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
