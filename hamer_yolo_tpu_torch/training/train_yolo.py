"""YOLOv7's train step (port of hamer_yolo_tpu/training/train_yolo.py): the
training-form detector (BN unfused, RepConv's branches;
``init_yolov7(deploy=False)``), SGD with Nesterov momentum under the
one-cycle schedule, and the EMA, as the reference's train.py runs them;
bf16 activations where the config says so, as JAX's step.

The BN running stats are not the optimizer's: the training forward returns
them updated from the batch statistics, and the step sets them into the
parameters after the optimizer's update, as JAX's ``merge`` does. The EMA is
updated after that, over every leaf. The loss is training/losses.yolo_loss
with the "neighbor" or the "simota" assigner; over a spec that ends in
AUXDET (IAuxDetect's training form, the reference's train_aux.py) the lead
and auxiliary maps go to it apart, ComputeLossAuxOTA's form (simota, top k
20 for the reference's parity). Spec entries without a training form raise
(models/yolov7/model.TRAIN_OPS).

With a ``mesh`` (parallel/mesh.py) the step is data parallel: each rank runs
the forward on its rows, BN normalises by the global batch's statistics
(parallel/mesh.DataMean: the same running stats on every rank, as the
sharded JAX step), the loss is the global batch's, and the gradients are
summed over the data axes.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, Optional

import numpy as np
import torch

from hamer_yolo_tpu_torch.core import nn
from hamer_yolo_tpu_torch.core.checkpoint import load_checkpoint
from hamer_yolo_tpu_torch.models.yolov7.model import (YoloConfig, init_yolov7, split_aux_maps,
                                                      yolov7_spec, yolov7_train_forward)
from hamer_yolo_tpu_torch.parallel.mesh import DataMean, gather_rows, local_rows, reduce_grads
from hamer_yolo_tpu_torch.training import state as S
from hamer_yolo_tpu_torch.training.losses import yolo_loss
from hamer_yolo_tpu_torch.training.optim import (EmaState, ema_init, ema_update, is_bn_stat,
                                                 named_leaves, scheduler_at, set_grads,
                                                 trainable, yolo_optimizer)

Params = Dict[str, Any]


@dataclass
class YoloTrainState:
    params: Params
    opt: torch.optim.SGD
    sched: torch.optim.lr_scheduler.LambdaLR
    ema: EmaState
    step: int = 0


def make_yolo_train_state(params: Params, total_steps: int = 10000,
                          opt_kwargs: Optional[Dict[str, float]] = None) -> YoloTrainState:
    """A train state over a copy of the training-form ``params``: every leaf
    but the BN running stats trained. ``opt_kwargs``: lr0 / lrf / momentum /
    weight_decay overrides, e.g. from training/hyp.map_hyp."""
    params = trainable(params, skip=is_bn_stat)
    opt, sched = yolo_optimizer(params, total_steps=total_steps, **(opt_kwargs or {}))
    return YoloTrainState(params, opt, sched, ema_init(params))


def init_yolo_train_state(gen: torch.Generator, cfg: YoloConfig, total_steps: int = 10000,
                          spec=None, opt_kwargs: Optional[Dict[str, float]] = None
                          ) -> YoloTrainState:
    """Seeded training-form parameters on ``gen``'s device."""
    return make_yolo_train_state(init_yolov7(gen, cfg, spec, deploy=False), total_steps,
                                 opt_kwargs)


def yolo_loss_fn(params: Params, batch: Dict[str, torch.Tensor], cfg: YoloConfig, spec=None,
                 loss_kwargs: Optional[Dict[str, float]] = None, assigner: str = "neighbor",
                 ota_topk: int = 10, mesh=None):
    """(yolo_loss's {"loss", "box", "obj", "cls"} of the training forward's
    maps, taken in f32, an AUXDET spec's auxiliary maps as ``aux_maps``;
    the params with the forward's new BN stats). With a ``mesh``: the
    forward on this rank's rows, BN and the loss over the global batch."""
    maps, with_stats = yolov7_train_forward(params, local_rows(batch["img"], mesh), cfg, spec,
                                            bn_sync=DataMean(mesh) if mesh is not None else None)
    maps = gather_rows(maps, mesh)
    lead, aux = split_aux_maps(maps, spec if spec is not None else yolov7_spec())
    anchors = nn.constant(cfg.anchors, torch.float32, maps[0].device).reshape(cfg.nl, cfg.na, 2)
    out = yolo_loss([m.float() for m in lead], batch["targets"], anchors, cfg.strides, cfg.nc,
                    assigner=assigner, ota_topk=ota_topk,
                    aux_maps=[m.float() for m in aux] if aux else None, **(loss_kwargs or {}))
    return out, with_stats


def make_yolo_train_step(cfg: YoloConfig, spec=None, assigner: str = "neighbor",
                         ota_topk: int = 10, loss_kwargs: Optional[Dict[str, float]] = None,
                         mesh=None):
    """(state, batch) -> metrics {"loss", "box", "obj", "cls"} (detached),
    one step in place. ``assigner`` "neighbor" or "simota" (``ota_topk``
    IoUs to dynamic k); ``loss_kwargs``: box_w / obj_w / cls_w / anchor_t.
    ``mesh``: data parallel over its data axes; every rank passes the same
    global batch."""

    def train_step(state: YoloTrainState, batch: Dict[str, torch.Tensor]):
        out, with_stats = yolo_loss_fn(state.params, batch, cfg, spec, loss_kwargs, assigner,
                                       ota_topk, mesh)
        leaves = [t for _, t in named_leaves(state.params) if t.requires_grad]
        set_grads(out["loss"], leaves)
        reduce_grads(leaves, mesh)
        state.opt.step()
        state.sched.step()
        with torch.no_grad():
            for (path, p), (_, new) in zip(named_leaves(state.params),
                                           named_leaves(with_stats), strict=True):
                if is_bn_stat(path):
                    p.copy_(new)
        state.ema = ema_update(state.ema, state.params)
        state.step += 1
        return {k: v.detach() for k, v in out.items()}

    return train_step


def synthetic_yolo_batch(gen: torch.Generator, batch_size: int, img_size: int = 320,
                         max_targets: int = 8, nc: int = 3) -> Dict[str, torch.Tensor]:
    """A random batch on ``gen``'s device (JAX's synthetic_yolo_batch's
    distributions): images in [0, 1] and ``max_targets`` label rows
    [cls, cx, cy, w, h] a frame, the first 4 valid, the rest padding (w = h = 0)."""
    dev, B, T = gen.device, batch_size, max_targets
    n_valid = 4
    cls = torch.randint(0, nc, (B, T, 1), generator=gen, device=dev).float()
    cxy = 0.2 + 0.6 * torch.rand((B, T, 2), generator=gen, device=dev)
    wh = 0.05 + 0.25 * torch.rand((B, T, 2), generator=gen, device=dev)
    valid = (torch.arange(T, device=dev) < n_valid)[None, :, None]
    return {"img": torch.rand((B, img_size, img_size, 3), generator=gen, device=dev),
            "targets": torch.cat([cls, cxy, wh * valid], dim=-1)}


def state_tree(state: YoloTrainState) -> Dict[str, Any]:
    """What a checkpoint holds (training/state.py)."""
    return {"params": state.params,
            "opt_state": S.optimizer_tree(state.opt, state.params, S.SGD_KEYS),
            "ema": {"params": state.ema.params, "updates": np.int32(state.ema.updates)},
            "step": np.int32(state.step)}


def save_train_state(path: str, state: YoloTrainState) -> None:
    S.save_state(path, state_tree(state))


def load_train_state(path: str, state: YoloTrainState) -> YoloTrainState:
    """``state`` (built for the same config) with the values of the
    checkpoint at ``path``, its schedule moved on to the saved step."""
    dev = named_leaves(state.params)[0][1].device
    tree = load_checkpoint(path, dev)
    step = int(tree["step"])
    S.copy_into(state.params, tree["params"])
    S.load_optimizer_tree(state.opt, state.params, tree["opt_state"], S.SGD_KEYS, step)
    S.copy_into(state.ema.params, tree["ema"]["params"])
    state.ema = EmaState(state.ema.params, int(tree["ema"]["updates"]))
    state.sched = scheduler_at(state.opt, state.sched.lr_lambdas[0], step)
    state.step = step
    return state
