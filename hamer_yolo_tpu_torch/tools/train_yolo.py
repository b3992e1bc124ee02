"""YOLOv7 training on a labelled folder (port of tools/train_yolo.py).

  python -m hamer_yolo_tpu_torch.tools.train_yolo --data <images dir> [--labels DIR]
      [--steps 1000] [--batch 16] [--img-size 640] [--nc 3] [--out runs/yolo]
      [--resume PATH|auto] [--ckpt-every 200] [--log-every 10] [--cfg YAML [--aux]]
      [--assigner neighbor|simota] [--hyp YAML] [--evolve N] [--evolve-seed 0]
      [--device cuda]
  torchrun --nproc-per-node N -m hamer_yolo_tpu_torch.tools.train_yolo --devices N ...

The train step of training/train_yolo.py over batches of io/datasets'
yolo_batch_iterator (mosaic, mixup, HSV, random perspective, flips: the
numpy loader, byte-equal to the JAX package's cv2 one), on the card unless
``--device`` names another. The labels are YOLO txt files beside the
images' folder ("images" -> "labels") or in ``--labels``. ``--cfg`` reads a
reference model yaml (PyYAML), ``--aux`` keeps its IAuxDetect heads
(a cfg/training yaml; the ComputeLossAuxOTA form, simota with top k 20);
``--hyp`` reads a reference hyp yaml (PyYAML) for the optimizer, the loss
gains, the augmentation and, through loss_ota, the assigner. Every
``--log-every`` steps the losses go to ``<out>/metrics.jsonl``; every
``--ckpt-every`` steps and at the end the train state goes to
``<out>/ckpt_<step>.npz`` / ``ckpt_final.npz``, from which ``--resume auto``
goes on.

``--evolve N`` runs N generations of the reference's hyperparameter
evolution (training/evolve.py): each trains a fresh model for ``--steps``
steps under a mutated hyp, without checkpoints, takes the EMA's mAP over
``--data`` (utils/detect_eval.detector_map, conf 0.001, iou 0.65) and
appends to ``<out>/evolve.txt``; the best hyp goes to
``<out>/hyp_evolved.yaml``. ``--plots`` (utils/plots.py, which needs cv2
and matplotlib) saves the first batch's mosaic ``train_batch0.jpg`` and
the label statistics ``labels.png`` at the start, and the curves
``results.png`` at the end. ``--devices N`` (0: every process torchrun
started, one a device) trains data parallel over N ranks (parallel/mesh.py;
the JAX tool's mesh; BN over the global batch's statistics); a batch that N
does not divide runs on one device, as JAX's does. Every rank reads the same
global batch; only rank 0 logs, plots and saves. ``--evolve`` runs on one
device.
"""
from __future__ import annotations

import argparse
import dataclasses
import os
import time
from typing import Dict, Optional, Tuple

import numpy as np
import torch


def train_loop(args, spec, cfg, opt_kwargs, loss_kwargs, data_kwargs, assigner: str,
               ota_topk: int, out: str, device: torch.device, save_ckpts: bool = True,
               resume: Optional[str] = None, quiet: bool = False, seed: int = 0,
               plots: bool = False, mesh=None):
    """One training run: (the final state, the last logged metrics,
    {"load_ms": host ms per batch, "step_ms": ms per step, by CUDA events
    on the card, "start": the step it began at})."""
    from hamer_yolo_tpu_torch.core.checkpoint import latest_checkpoint
    from hamer_yolo_tpu_torch.io.datasets import YoloDataConfig, yolo_batch_iterator
    from hamer_yolo_tpu_torch.training.train_yolo import (init_yolo_train_state,
                                                          load_train_state,
                                                          make_yolo_train_step,
                                                          save_train_state)
    from hamer_yolo_tpu_torch.utils.logging import MetricLogger, StepTimer

    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    state = init_yolo_train_state(gen, cfg, args.steps, spec=spec, opt_kwargs=opt_kwargs)
    resume = latest_checkpoint(out) if resume == "auto" else resume
    if resume and os.path.exists(resume):
        load_train_state(resume, state)
        print(f"resumed from {resume} at step {state.step}")
    step_fn = make_yolo_train_step(cfg, spec, assigner, ota_topk, loss_kwargs, mesh=mesh)
    data = yolo_batch_iterator(args.data, args.batch,
                               YoloDataConfig(img_size=args.img_size, **data_kwargs),
                               label_dir=args.labels)
    os.makedirs(out, exist_ok=True)
    logger = None if quiet else MetricLogger(out)
    timer = StepTimer(device)
    t0 = time.time()
    start = state.step
    metrics: Dict[str, float] = {}
    for step in range(start, args.steps):
        with timer.load():
            np_batch = next(data)
            batch = {k: torch.from_numpy(v).to(device) for k, v in np_batch.items()}
        if plots and step == start:
            plot_first_batch(np_batch, out)
        with timer.step():
            out_metrics = step_fn(state, batch)
        if step % args.log_every == 0 or step == args.steps - 1:
            metrics = {k: float(v) for k, v in out_metrics.items()}
            rate = (step - start + 1) * args.batch / (time.time() - t0)
            if logger is not None:
                logger.log(step, metrics)
            if not quiet:
                print(f"step {step}: loss={metrics['loss']:.4f} box={metrics['box']:.4f} "
                      f"obj={metrics['obj']:.4f} cls={metrics['cls']:.4f} ({rate:.1f} img/s)")
        if save_ckpts and step and step % args.ckpt_every == 0:
            save_train_state(os.path.join(out, f"ckpt_{step}.npz"), state)
    if save_ckpts:
        save_train_state(os.path.join(out, "ckpt_final.npz"), state)
    if logger is not None:
        logger.close()
    return state, metrics, dict(timer.times(), start=start)


def plot_first_batch(batch: Dict[str, np.ndarray], out: str) -> None:
    """train_batch0.jpg (the batch's mosaic with its label boxes) and
    labels.png (the label statistics) in ``out``."""
    from hamer_yolo_tpu_torch.utils.plots import plot_images, plot_labels

    tgt = batch["targets"]  # (B, T, 5) [cls, xywh in 0..1], padded rows with w == 0
    live = tgt[..., 3] > 0
    rows = [np.concatenate([[b], tgt[b, t]]) for b, t in zip(*np.nonzero(live))]
    plot_images(batch["img"], np.asarray(rows).reshape(-1, 6),
                fname=os.path.join(out, "train_batch0.jpg"))
    plot_labels(tgt[live], os.path.join(out, "labels.png"))


def require_plot_libraries() -> None:
    """--plots draws with cv2 and matplotlib: an ImportError that says so
    where either is missing, before any training."""
    try:
        import cv2  # noqa: F401
        import matplotlib  # noqa: F401
    except ImportError as e:
        raise ImportError(f"--plots needs cv2 and matplotlib: {e}") from e


def eval_map(args, cfg, spec, params, conf: float = 0.001, iou: float = 0.65):
    """(mP, mR, mAP@.5, mAP@.5:.95) of ``params`` over the labelled --data
    folder (test.py's settings): the fitness inputs."""
    from hamer_yolo_tpu_torch.io.datasets import image_label_pairs
    from hamer_yolo_tpu_torch.utils.detect_eval import detector_map

    return detector_map(params, cfg, image_label_pairs(args.data, args.labels), spec=spec,
                        conf=conf, iou=iou, img_size=args.img_size)


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="train_yolo")
    p.add_argument("--data", required=True, help="images dir (labels dir sibling)")
    p.add_argument("--labels", default=None)
    p.add_argument("--steps", type=int, default=1000)
    p.add_argument("--batch", type=int, default=16)
    p.add_argument("--img-size", type=int, default=640)
    p.add_argument("--nc", type=int, default=3)
    p.add_argument("--devices", type=int, default=0,
                   help="devices, one process each under torchrun; 0: all of them")
    p.add_argument("--out", default="runs/yolo")
    p.add_argument("--resume", default=None, help="a checkpoint, or auto: the run's latest")
    p.add_argument("--ckpt-every", type=int, default=200)
    p.add_argument("--log-every", type=int, default=10)
    p.add_argument("--cfg", default=None,
                   help="reference model yaml (cfg/deploy or cfg/training); default: the "
                        "built-in yolov7")
    p.add_argument("--aux", action="store_true",
                   help="keep IAuxDetect's auxiliary heads (a cfg/training yaml in --cfg) and "
                        "train with ComputeLossAuxOTA's loss (simota, top k 20)")
    p.add_argument("--assigner", default=None, choices=["neighbor", "simota"],
                   help="label assigner (default: neighbor; simota is OTA)")
    p.add_argument("--hyp", default=None, metavar="YAML",
                   help="reference hyp yaml: lr / momentum / wd, the loss gains, the "
                        "augmentation, loss_ota -> simota")
    p.add_argument("--plots", action="store_true",
                   help="train_batch0.jpg and labels.png at the start, results.png at the end "
                        "(needs cv2 and matplotlib)")
    p.add_argument("--evolve", type=int, default=0, metavar="N",
                   help="N generations of hyperparameter evolution; writes <out>/evolve.txt "
                        "and hyp_evolved.yaml")
    p.add_argument("--evolve-seed", type=int, default=0)
    p.add_argument("--device", default="cuda",
                   help="torch device (default: the card; cpu for a machine without one)")
    return p


def run(argv: Optional[list] = None) -> Tuple[int, Optional[dict]]:
    """The tool on ``argv``: (exit code, the training run's train_loop
    timings, or None under --evolve or when it stops early)."""
    from hamer_yolo_tpu_torch.parallel.mesh import leave_distributed, tool_mesh

    p = build_parser()
    args = p.parse_args(argv)
    try:
        mesh, device, rank = tool_mesh(args.devices, args.batch, args.device)
    except ValueError as e:
        p.error(str(e))
    if mesh is not None and args.evolve:
        p.error("--evolve runs on one device: drop --devices")
    try:
        return (0, None) if mesh is None and rank else train(args, mesh, device, rank == 0)
    finally:
        leave_distributed()


def train(args, mesh, device: torch.device, lead: bool) -> Tuple[int, Optional[dict]]:
    from hamer_yolo_tpu_torch.models.yolov7.model import YoloConfig
    from hamer_yolo_tpu_torch.training.hyp import map_hyp

    if args.plots and lead:
        require_plot_libraries()

    spec = None
    if args.cfg:
        from hamer_yolo_tpu_torch.models.yolov7.yaml_spec import load_yaml_model_cfg

        spec, cfg = load_yaml_model_cfg(args.cfg, nc=args.nc, training_form=args.aux)
        cfg = dataclasses.replace(cfg, img_size=args.img_size)
    else:
        if args.aux:
            print("--aux needs --cfg naming a cfg/training yaml with an IAuxDetect head")
            return 2, None
        cfg = YoloConfig(nc=args.nc, img_size=args.img_size)

    hyp0: Dict = {}
    opt_kwargs, loss_kwargs, data_kwargs, hyp_assigner = {}, {}, {}, None
    if args.hyp:
        import yaml

        with open(args.hyp) as f:
            hyp0 = yaml.safe_load(f) or {}
        opt_kwargs, loss_kwargs, data_kwargs, extras = map_hyp(hyp0)
        hyp_assigner = extras.pop("_assigner", None)
        if extras:
            print(f"hyp keys without a counterpart here (ignored): {sorted(extras)}")
    assigner = args.assigner or hyp_assigner or ("simota" if args.aux else "neighbor")
    ota_topk = 20 if args.aux else 10

    if args.evolve:
        from hamer_yolo_tpu_torch.training.evolve import evolve

        def train_and_eval(hyp, gen):
            okw, lkw, dkw, _ = map_hyp(hyp)
            state, m, _ = train_loop(args, spec, cfg, okw, lkw, dkw, assigner, ota_topk,
                                     os.path.join(args.out, f"gen_{gen}"), device,
                                     save_ckpts=False, quiet=True, seed=gen)
            mp, mr, map50, mmap = eval_map(args, cfg, spec, state.ema.params)
            return mp, mr, map50, mmap, m.get("box", 0.0), m.get("obj", 0.0), m.get("cls", 0.0)

        best = evolve(train_and_eval, args.evolve, args.out, hyp0=hyp0, seed=args.evolve_seed)
        print(f"best hyp -> {os.path.join(args.out, 'hyp_evolved.yaml')}")
        print({k: round(v, 5) for k, v in list(best.items())[:8]})
        return 0, None

    t0 = time.time()
    _, _, times = train_loop(args, spec, cfg, opt_kwargs, loss_kwargs, data_kwargs, assigner,
                             ota_topk, args.out, device, save_ckpts=lead, resume=args.resume,
                             quiet=not lead, plots=args.plots and lead, mesh=mesh)
    if not lead:
        return 0, times
    if args.plots:
        from hamer_yolo_tpu_torch.utils.plots import plot_results

        print(f"curves -> {plot_results(args.out)}")
    if times["load_ms"]:
        from hamer_yolo_tpu_torch.utils.logging import step_summary

        print(step_summary(times))
    print(f"done: {args.steps} steps in {time.time() - t0:.0f}s -> {args.out}")
    return 0, times


def main(argv: Optional[list] = None) -> int:
    return run(argv)[0]


if __name__ == "__main__":
    raise SystemExit(main())
