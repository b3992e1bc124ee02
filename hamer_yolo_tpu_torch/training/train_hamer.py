"""HaMeR's adversarial train step (port of hamer_yolo_tpu/training/train_hamer.py).

The reference's LightningModule setup (hamer.py:269-448): two AdamW
optimizers (lr 1e-5, weight decay 1e-4 on every parameter), one for the
generator (ViT backbone + MANO head) and one for the MANO discriminator.
A step takes the generator's loss (2D and 3D keypoint L1, the MANO
parameters' MSE and the LSGAN term under the yaml's weights) and updates the
generator, then the discriminator's on the mocap batch and the generator's
predictions, detached.

The optimizers are training/optim.AdamW, optax.adamw's update op for op
(p <- p - lr (adam + wd p), the bias corrections in float32), not
torch.optim.AdamW, whose decay factor 1 - lr wd rounds to 1 in float32 at
these rates. Adam's first step is about lr sign(g), so where a gradient is
near 0 the two packages can step a parameter in opposite directions.

Parameters stay float32; the ViT computes in its compute dtype (bf16 by
default). The step runs the plain layers, never a kernel: ``train_config``
turns off the ViT's fused attention (K2) and the fused MANO (K9), whose
kernels have no backward (every wrapper refuses an input that requires
grad). A forward under torch.no_grad(), such as the tools' viz, may use them.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Any, Dict, Tuple

import numpy as np
import torch

from hamer_yolo_tpu_torch.core.checkpoint import load_checkpoint
from hamer_yolo_tpu_torch.models.discriminator import (discriminator_forward,
                                                       init_discriminator)
from hamer_yolo_tpu_torch.models.hamer import HamerConfig, hamer_forward, init_hamer
from hamer_yolo_tpu_torch.models.mano import ManoModel
from hamer_yolo_tpu_torch.training import state as S
from hamer_yolo_tpu_torch.training.losses import (HAMER_LOSS_WEIGHTS, adversarial_disc_loss,
                                                  adversarial_gen_loss, keypoint_2d_loss,
                                                  keypoint_3d_loss, parameter_loss)
from hamer_yolo_tpu_torch.training.optim import AdamW, named_leaves, set_grads, trainable

Params = Dict[str, Any]


@dataclass
class HamerTrainState:
    params: Params
    disc_params: Params
    opt: AdamW
    disc_opt: AdamW
    step: int = 0


def adamw(params: Params, lr: float, weight_decay: float) -> AdamW:
    return AdamW([t for _, t in named_leaves(params)], lr=lr, betas=(0.9, 0.999), eps=1e-8,
                 weight_decay=weight_decay)


def make_train_state(params: Params, disc_params: Params, lr: float = 1e-5,
                     weight_decay: float = 1e-4) -> HamerTrainState:
    """A train state over copies of the given trees, every leaf trained."""
    params, disc_params = trainable(params), trainable(disc_params)
    return HamerTrainState(params, disc_params, adamw(params, lr, weight_decay),
                           adamw(disc_params, lr, weight_decay))


def init_train_state(gen: torch.Generator, cfg: HamerConfig, lr: float = 1e-5,
                     weight_decay: float = 1e-4) -> HamerTrainState:
    """Seeded HaMeR and discriminator parameters on ``gen``'s device."""
    return make_train_state(init_hamer(gen, cfg), init_discriminator(gen), lr, weight_decay)


def train_config(cfg: HamerConfig) -> HamerConfig:
    """``cfg`` with the plain attention and the plain MANO: what a step runs."""
    return dataclasses.replace(cfg, vit=dataclasses.replace(cfg.vit, fused_attn=False),
                               fused_mano=False)


def hamer_loss_fn(params: Params, disc_params: Params, mano_model: ManoModel,
                  batch: Dict[str, torch.Tensor], cfg: HamerConfig,
                  weights: Dict[str, float] = HAMER_LOSS_WEIGHTS
                  ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """(the weighted total, {each term, "total", the predicted hand pose and
    betas}) of the generator."""
    out = hamer_forward(params, mano_model, batch["img"], cfg)
    mano = out["pred_mano_params"]
    has = batch["has_mano_params"]
    losses = {
        "keypoints_2d": keypoint_2d_loss(out["pred_keypoints_2d"], batch["keypoints_2d"]),
        "keypoints_3d": keypoint_3d_loss(out["pred_keypoints_3d"], batch["keypoints_3d"]),
        "global_orient": parameter_loss(mano["global_orient"], batch["mano_global_orient"], has),
        "hand_pose": parameter_loss(mano["hand_pose"], batch["mano_hand_pose"], has),
        "betas": parameter_loss(mano["betas"], batch["mano_betas"], has),
    }
    losses["adversarial"] = adversarial_gen_loss(
        discriminator_forward(disc_params, mano["hand_pose"], mano["betas"]))
    total = sum(weights[k] * v for k, v in losses.items())
    return total, dict(losses, total=total, pred_hand_pose=mano["hand_pose"],
                       pred_betas=mano["betas"])


def train_step(state: HamerTrainState, batch: Dict[str, torch.Tensor], mano_model: ManoModel,
               cfg: HamerConfig) -> Dict[str, torch.Tensor]:
    """One generator step, then one discriminator step, in place; returns
    the metrics (detached 0-d tensors: the loss terms, "total", "disc_loss")."""
    cfg = train_config(cfg)
    gen_leaves = [t for _, t in named_leaves(state.params)]
    disc_leaves = [t for _, t in named_leaves(state.disc_params)]

    total, aux = hamer_loss_fn(state.params, state.disc_params, mano_model, batch, cfg)
    set_grads(total, gen_leaves)
    state.opt.step()

    real = discriminator_forward(state.disc_params, batch["mocap_hand_pose"],
                                 batch["mocap_betas"])
    fake = discriminator_forward(state.disc_params, aux["pred_hand_pose"].detach(),
                                 aux["pred_betas"].detach())
    d_loss = adversarial_disc_loss(real, fake)
    set_grads(d_loss, disc_leaves)
    state.disc_opt.step()
    state.step += 1

    metrics = {k: v.detach() for k, v in aux.items() if not k.startswith("pred_")}
    metrics["disc_loss"] = d_loss.detach()
    return metrics


def synthetic_batch(gen: torch.Generator, batch_size: int, cfg: HamerConfig
                    ) -> Dict[str, torch.Tensor]:
    """A random training batch with the full annotation schema, drawn on
    ``gen``'s device (JAX's synthetic_batch's distributions)."""
    dev, B = gen.device, batch_size

    def normal(*shape):
        return torch.randn(shape, generator=gen, device=dev)

    def uniform(*shape):
        return torch.rand(shape, generator=gen, device=dev)

    eye = torch.eye(3, device=dev).expand(B, 15, 3, 3).contiguous()
    kp2d = normal(B, 21, 3)
    kp2d[..., 2] = uniform(B, 21)
    kp3d = normal(B, 21, 4)
    kp3d[..., 3] = uniform(B, 21)
    return {
        "img": normal(B, cfg.image_size, cfg.image_size, 3),
        "keypoints_2d": kp2d,
        "keypoints_3d": kp3d,
        "mano_global_orient": torch.eye(3, device=dev).expand(B, 1, 3, 3).contiguous(),
        "mano_hand_pose": eye,
        "mano_betas": normal(B, 10) * 0.1,
        "has_mano_params": torch.ones(B, device=dev),
        "mocap_hand_pose": eye.clone(),
        "mocap_betas": normal(B, 10) * 0.1,
    }


def state_tree(state: HamerTrainState) -> Dict[str, Any]:
    """What a checkpoint holds (training/state.py)."""
    return {"params": state.params,
            "opt_state": S.optimizer_tree(state.opt, state.params, S.ADAM_KEYS),
            "disc_params": state.disc_params,
            "disc_opt_state": S.optimizer_tree(state.disc_opt, state.disc_params, S.ADAM_KEYS),
            "step": np.int32(state.step)}


def save_train_state(path: str, state: HamerTrainState) -> None:
    S.save_state(path, state_tree(state))


def load_train_state(path: str, state: HamerTrainState) -> HamerTrainState:
    """``state`` (built for the same config) with the values of the
    checkpoint at ``path``."""
    dev = named_leaves(state.params)[0][1].device
    tree = load_checkpoint(path, dev)
    step = int(tree["step"])
    S.copy_into(state.params, tree["params"])
    S.copy_into(state.disc_params, tree["disc_params"])
    S.load_optimizer_tree(state.opt, state.params, tree["opt_state"], S.ADAM_KEYS, step)
    S.load_optimizer_tree(state.disc_opt, state.disc_params, tree["disc_opt_state"],
                          S.ADAM_KEYS, step)
    state.step = step
    return state
