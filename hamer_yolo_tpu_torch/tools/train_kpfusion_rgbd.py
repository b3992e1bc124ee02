"""KPFusion RGB-D training (port of tools/train_kpfusion_rgbd.py).

  python -m hamer_yolo_tpu_torch.tools.train_kpfusion_rgbd --steps 200 [--batch 4]
      [--lr 8e-4] [--tiny] [--data DIR [--depth-fmt auto|u16|nyu|ho3d|npy]
      [--data-format fixture|stb] [--augment]] [--out runs/kpfusion_rgbd]
      [--resume PATH|auto] [--ckpt-every 100] [--log-every 10] [--device cuda]

The train step of training/train_kpfusion_rgbd.py on seeded random weights
(the default KPFusionConfig; ``--tiny`` the JAX tool's small one), on the
card unless ``--device`` names another. ``--data`` reads a directory of
samples (io/rgbd_datasets.py): the fixture layout ({stem}.png,
{stem}_d.png, {stem}.txt joints in mm; ``--depth-fmt`` its depth encoding)
or, with ``--data-format stb``, STB's; batches come from an endless loop of
epochs, each shuffled with its own number as the seed, ``--augment`` one
rot / com / sc / none augmentation a sample, the points sampled from a
RandomState(0). Without ``--data`` the batches are synthetic (plausibly
scaled random samples) and the spatial-weight gate takes step * batch //
1000 as the epoch. Every ``--log-every`` steps the losses go to
``<out>/metrics.jsonl``; every ``--ckpt-every`` steps and at the end the
train state to ``<out>/ckpt_<step>.npz`` / ``ckpt_final.npz``, from which
``--resume auto`` goes on. ``--devices`` above 1 (data parallelism) is not
ported (ROADMAP.md, Queue 1 item 8).
"""
from __future__ import annotations

import argparse
import os
import time
from typing import Iterator, Optional, Tuple

import numpy as np
import torch

from hamer_yolo_tpu_torch.models.kpfusion_rgbd.model import KPFusionConfig


def tiny_config() -> KPFusionConfig:
    """The JAX tool's --tiny KPFusion."""
    return KPFusionConfig(img_size=32, feature_size=8, dim=32, sample_num=64, num_stages=1,
                          heads=2)


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="train_kpfusion_rgbd")
    p.add_argument("--steps", type=int, default=200)
    p.add_argument("--batch", type=int, default=4)
    p.add_argument("--lr", type=float, default=8e-4)   # config.py:60
    p.add_argument("--tiny", action="store_true", help="scaled-down net (smoke)")
    p.add_argument("--data", default=None, help="RGB-D sample dir; default synthetic batches")
    p.add_argument("--depth-fmt", default="auto", choices=["auto", "u16", "nyu", "ho3d", "npy"])
    p.add_argument("--data-format", default="fixture", choices=["fixture", "stb"],
                   help="fixture: {stem}.png + {stem}_d.png + {stem}.txt; stb: "
                        "{seq}/SK_color_i.png + SK_depth_i.png + labels/{seq}_SK.mat")
    p.add_argument("--augment", action="store_true",
                   help="rot / com / sc / none augmentation of --data samples "
                        "(aug_para 10 mm, 0.2, 180 degrees)")
    p.add_argument("--devices", type=int, default=0)
    p.add_argument("--out", default="runs/kpfusion_rgbd")
    p.add_argument("--resume", default=None, help="a checkpoint, or auto: the run's latest")
    p.add_argument("--ckpt-every", type=int, default=100)
    p.add_argument("--log-every", type=int, default=10)
    p.add_argument("--device", default="cuda",
                   help="torch device (default: the card; cpu for a machine without one)")
    return p


def data_batches(args, cfg: KPFusionConfig) -> Iterator[Tuple[int, dict]]:
    """(epoch, numpy batch) from --data, epoch after epoch."""
    from hamer_yolo_tpu_torch.io import rgbd_datasets as R

    pcl_rng = np.random.RandomState(0)
    if args.data_format == "stb":
        ds = R.STBDataset(args.data, img_size=cfg.img_size, sample_num=cfg.sample_num,
                          pcl_rng=pcl_rng)
    else:
        ds = R.RGBDDiskDataset(args.data, R.RGBDDatasetConfig(
            img_size=cfg.img_size, sample_num=cfg.sample_num, depth_fmt=args.depth_fmt),
            pcl_rng=pcl_rng)
    print(f"data: {len(ds)} labeled sample(s) from {args.data} ({args.data_format})")
    epoch = 0
    while True:
        for b in ds.batches(args.batch, shuffle=True, seed=epoch, augment=args.augment):
            yield epoch, b
        epoch += 1


def run(argv: Optional[list] = None) -> Tuple[int, dict]:
    """The tool on ``argv``: (exit code, {"load_ms": host ms a batch, "step_ms":
    ms a step, by CUDA events on the card})."""
    from hamer_yolo_tpu_torch.core.checkpoint import latest_checkpoint
    from hamer_yolo_tpu_torch.training.train_kpfusion_rgbd import (
        init_train_state, load_train_state, save_train_state, synthetic_rgbd_batch, train_step)
    from hamer_yolo_tpu_torch.utils.logging import MetricLogger, StepTimer, step_summary

    p = build_parser()
    args = p.parse_args(argv)
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
    batches = data_batches(args, cfg) if args.data else None
    timer = StepTimer(device)
    t0 = time.time()
    with MetricLogger(args.out) as logger:
        for step in range(state.step, args.steps):
            with timer.load():
                if batches is not None:
                    epoch, np_batch = next(batches)
                else:
                    np_batch = synthetic_rgbd_batch(rng, args.batch, cfg)
                    epoch = step * args.batch // 1000  # the spatial-weight gate's epoch (train.py:250)
                batch = {k: torch.from_numpy(v).to(device) for k, v in np_batch.items()}
            with timer.step():
                metrics = train_step(state, batch, cfg, epoch=epoch)
            if step % args.log_every == 0:
                logger.log(step, {k: float(v) for k, v in metrics.items()})
                print(f"step {step}: loss={float(metrics['loss']):.4f} "
                      f"coord_d={float(metrics['coord_d']):.4f} "
                      f"kfam0={float(metrics['coord_kfam_0']):.4f}")
            if step and step % args.ckpt_every == 0:
                save_train_state(os.path.join(args.out, f"ckpt_{step}.npz"), state)
        save_train_state(os.path.join(args.out, "ckpt_final.npz"), state)
    times = timer.times()
    if times["load_ms"]:
        print(step_summary(times))
    print(f"done: {args.steps} steps in {time.time() - t0:.0f}s -> {args.out}")
    return 0, times


def main(argv: Optional[list] = None) -> int:
    return run(argv)[0]


if __name__ == "__main__":
    raise SystemExit(main())
