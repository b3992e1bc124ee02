"""KPFusion RGB-D's train step (port of
hamer_yolo_tpu/training/train_kpfusion_rgbd.py).

The reference's Trainer.train (KeypointFusion train.py:194-265) with its
config.py: stage types [1, 1, 2, 3, 2, 3], coord_weight 100, deconv_weight
1, spatial_weight 10 per KFAM stage for the first ``SPATIAL_EPOCH`` = 24
epochs, AdamW (lr 8e-4, weight decay 0.01) under StepLR (x 0.1 every 30
epochs, staircase).

Stage losses, each the reference's SmoothL1 (model/loss.py:3-26, a 0.01
knee, not torch.nn.SmoothL1Loss):
- type 1 (both UNets): the first 4J offset channels against
  joint2offset(uvd_gt) and the decoded joints against uvd_gt, both on the
  depth crop's pixels (the reference hands ``img`` to the RGB stream too);
- type 2 / 3 (each KFAM's refined_3d and refined_2d): the joints against xyz_gt;
- the spatial-weight maps against max-normalised gaussians of uvd_gt
  (sigma 3 for the first KFAM, 2 after).

The forward is the eager ``kpfusion_forward`` with BN in inference form, as
JAX's step runs it; JAX's gradient reaches every leaf, the BN running stats
included, and the optimizer steps them all, so this step does the same.

With a ``mesh`` (parallel/mesh.py) the step is data parallel: each rank runs
the forward on its rows, the loss is the global batch's (the heatmaps'
max-normalisation spans the batch) and the gradients are summed over the
data axes. BN is in inference form, so no batch statistics cross ranks.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, Tuple

import numpy as np
import torch

from hamer_yolo_tpu_torch.core.checkpoint import load_checkpoint
from hamer_yolo_tpu_torch.models.kpfusion_rgbd import geometry as G
from hamer_yolo_tpu_torch.models.kpfusion_rgbd.model import (KPFusionConfig, init_kpfusion,
                                                             kpfusion_forward)
from hamer_yolo_tpu_torch.parallel.mesh import gather_rows, local_rows, reduce_grads
from hamer_yolo_tpu_torch.training import state as S
from hamer_yolo_tpu_torch.training.losses import abs_
from hamer_yolo_tpu_torch.training.optim import (AdamW, named_leaves, scheduler_at, set_grads,
                                                 trainable)

Params = Dict[str, Any]

COORD_WEIGHT = 100.0   # config.py:68
DECONV_WEIGHT = 1.0    # config.py:69
SPATIAL_WEIGHT = 10.0  # config.py:70
SPATIAL_EPOCH = 24     # config.py:71


def smooth_l1(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """The reference's SmoothL1Loss: 0.5 z^2 inside |z| < 0.01, 0.01 (|z| -
    0.005) outside, each branch averaged over the last axis, then the mean."""
    z = x - y
    az = abs_(z)
    mse_mask = (az < 0.01).to(z.dtype)
    l1_mask = 1.0 - mse_mask
    per = torch.mean(0.5 * z * z * mse_mask, dim=-1) \
        + torch.mean(0.01 * (az - 0.005) * l1_mask, dim=-1)
    return torch.mean(per)


def kpfusion_rgbd_loss(params: Params, batch: Dict[str, torch.Tensor], cfg: KPFusionConfig,
                       epoch: int = 0, mesh=None) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """(the loss, its terms and "loss") of one batch, whose keys follow the
    reference loader's tuple: img_rgb (B, 3, S, S), img (B, 1, S, S) depth,
    pcl (B, N, 3), xyz_gt and uvd_gt (B, J, 3), center, M, cube, cam_para.
    With a ``mesh``: the forward on this rank's rows, the loss over the
    global batch."""
    mine = local_rows({k: batch[k] for k in ("img_rgb", "img", "pcl", "center", "M", "cube",
                                             "cam_para")}, mesh)
    out = kpfusion_forward(params, mine["img_rgb"], mine["img"], mine["pcl"], mine["center"],
                           mine["M"], mine["cube"], mine["cam_para"], cfg)
    return loss_terms(gather_rows(out, mesh), batch, cfg, epoch)


def loss_terms(out: Dict[str, Any], batch: Dict[str, torch.Tensor], cfg: KPFusionConfig,
               epoch: int = 0) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """``kpfusion_rgbd_loss`` of the forward's outputs ``out``."""
    results = out["results"]
    uvd_gt, xyz_gt, img = batch["uvd_gt"], batch["xyz_gt"], batch["img"]
    fs = results[0].shape[-1]
    J = cfg.joint_num

    metrics: Dict[str, torch.Tensor] = {}
    loss = img.new_zeros(())
    pixel_gt = G.joint2offset(uvd_gt, img, cfg.kernel, fs)             # (B, 4J, fs, fs)
    for idx, name in ((0, "d"), (1, "rgb")):                           # stage type 1
        pixel_pd = results[idx]                                        # (B, 5J, fs, fs)
        loss_pixel = smooth_l1(pixel_pd[:, :4 * J], pixel_gt) * DECONV_WEIGHT
        joint_uvd = G.offset2joint_weight(pixel_pd, img, cfg.kernel)
        loss_coord = smooth_l1(joint_uvd, uvd_gt) * COORD_WEIGHT
        loss = loss + loss_pixel + loss_coord
        metrics[f"pixel_{name}"] = loss_pixel
        metrics[f"coord_{name}"] = loss_coord

    for i, r in enumerate(results[2:]):                                # stage types 2 / 3
        lc = smooth_l1(r, xyz_gt) * COORD_WEIGHT
        loss = loss + lc
        metrics[f"coord_kfam_{i}"] = lc

    gate = float(epoch <= SPATIAL_EPOCH)
    for i, sw in enumerate(out["spatial_weights"]):
        hm = G.joint2heatmap(uvd_gt[:, :, :2], cfg.kernel, fs, sigma=3.0 if i == 0 else 2.0)
        hm = hm / torch.clamp(torch.amax(hm), min=1e-8)
        lsw = smooth_l1(sw, hm) * SPATIAL_WEIGHT * gate
        loss = loss + lsw
        metrics[f"spatial_{i}"] = lsw

    metrics["loss"] = loss
    return loss, metrics


def step_decay(lr: float, steps_per_epoch: int = 1000, step_size_epochs: int = 30):
    """optax.exponential_decay(lr, 30 epochs, 0.1, staircase=True), in float32."""
    f32 = np.float32
    period = step_size_epochs * steps_per_epoch

    def schedule(step: int) -> float:
        if step <= 0:
            return float(f32(lr))
        return float(f32(lr) * np.power(f32(0.1), f32(step // period)))

    return schedule


@dataclass
class KPFusionTrainState:
    params: Params
    opt: AdamW
    sched: torch.optim.lr_scheduler.LambdaLR
    step: int = 0


def make_optimizer(params: Params, lr: float = 8e-4, steps_per_epoch: int = 1000,
                   step_size_epochs: int = 30, step: int = 0):
    """AdamW (weight decay 0.01) under StepLR(gamma 0.1) - train.py:91,120 -
    over every leaf; (optimizer, its LambdaLR at ``step`` updates made).
    optim.AdamW is optax.adamw's update: its decay takes the scheduled rate too."""
    opt = AdamW([t for _, t in named_leaves(params)], lr=1.0, betas=(0.9, 0.999), eps=1e-8,
                weight_decay=0.01)
    return opt, scheduler_at(opt, step_decay(lr, steps_per_epoch, step_size_epochs), step)


def make_train_state(params: Params, lr: float = 8e-4) -> KPFusionTrainState:
    params = trainable(params)
    opt, sched = make_optimizer(params, lr)
    return KPFusionTrainState(params, opt, sched)


def init_train_state(gen: torch.Generator, cfg: KPFusionConfig, lr: float = 8e-4
                     ) -> KPFusionTrainState:
    """Seeded parameters on ``gen``'s device."""
    return make_train_state(init_kpfusion(gen, cfg), lr)


def train_step(state: KPFusionTrainState, batch: Dict[str, torch.Tensor], cfg: KPFusionConfig,
               epoch: int = 0, mesh=None) -> Dict[str, torch.Tensor]:
    """One AdamW step in place; returns the metrics (detached). ``mesh``:
    data parallel over its data axes; every rank passes the same global batch."""
    loss, metrics = kpfusion_rgbd_loss(state.params, batch, cfg, epoch, mesh)
    leaves = [t for _, t in named_leaves(state.params)]
    set_grads(loss, leaves)
    reduce_grads(leaves, mesh)
    state.opt.step()
    state.sched.step()
    state.step += 1
    return {k: v.detach() for k, v in metrics.items()}


def synthetic_rgbd_batch(rng: np.random.Generator, batch_size: int, cfg: KPFusionConfig
                         ) -> Dict[str, np.ndarray]:
    """A plausibly scaled random batch in the reference's normalised spaces,
    numpy, drawn from ``rng`` as JAX's synthetic_rgbd_batch draws it."""
    B, N, J, S_ = batch_size, cfg.sample_num, cfg.joint_num, cfg.img_size
    center = rng.uniform(200, 800, (B, 3)).astype(np.float32)
    center[:, 2] = rng.uniform(300, 700, B)
    M = np.tile(np.eye(3, dtype=np.float32), (B, 1, 1))
    cube = np.tile(np.array([250.0, 250.0, 250.0], np.float32), (B, 1))
    cam = np.tile(np.array([475.06, 475.06, 315.94, 245.29], np.float32), (B, 1))
    return {
        "img_rgb": rng.uniform(0, 1, (B, 3, S_, S_)).astype(np.float32),
        "img": rng.uniform(-1, 1, (B, 1, S_, S_)).astype(np.float32),
        "pcl": rng.uniform(-1, 1, (B, N, 3)).astype(np.float32),
        "uvd_gt": rng.uniform(-0.8, 0.8, (B, J, 3)).astype(np.float32),
        "xyz_gt": rng.uniform(-0.8, 0.8, (B, J, 3)).astype(np.float32),
        "center": center, "M": M, "cube": cube, "cam_para": cam,
    }


def state_tree(state: KPFusionTrainState) -> Dict[str, Any]:
    """What a checkpoint holds (training/state.py)."""
    return {"params": state.params,
            "opt_state": S.optimizer_tree(state.opt, state.params, S.ADAM_KEYS),
            "step": np.int32(state.step)}


def save_train_state(path: str, state: KPFusionTrainState) -> None:
    S.save_state(path, state_tree(state))


def load_train_state(path: str, state: KPFusionTrainState) -> KPFusionTrainState:
    """``state`` (built for the same config) with the values of the
    checkpoint at ``path``, its schedule moved on to the saved step."""
    dev = named_leaves(state.params)[0][1].device
    tree = load_checkpoint(path, dev)
    step = int(tree["step"])
    S.copy_into(state.params, tree["params"])
    S.load_optimizer_tree(state.opt, state.params, tree["opt_state"], S.ADAM_KEYS, step)
    state.sched = scheduler_at(state.opt, state.sched.lr_lambdas[0], step)
    state.step = step
    return state
