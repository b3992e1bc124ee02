"""Optimizers, schedules and the EMA of the train steps (port of
hamer_yolo_tpu/training/optim.py), in PyTorch's idiom: torch.optim
optimizers over parameter groups, a LambdaLR for the schedule.

The reference's YOLOv7 recipe (yolo/yolov7/train.py): SGD with Nesterov
momentum 0.937, lr0 0.01, weight decay 5e-4 on conv and linear weights only
(biases and norm scales exempt), the one-cycle cosine rate
lr0 (lrf + (1 - lrf) (1 + cos(pi t / T)) / 2) after a linear warmup, and
ModelEMA with the decay 0.9999 (1 - exp(-updates / 2000)).

The schedules compute in float32 as the JAX package's do. The step counter
starts at 0, so under warmup the first update has the rate 0. Each group's
base rate is 1.0, so that LambdaLR's rate is the schedule's value itself.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Tuple

import numpy as np
import torch

Params = Dict[str, Any]


def named_leaves(tree: Any, path: Tuple[str, ...] = ()) -> List[Tuple[str, torch.Tensor]]:
    """(path "a/0/w", tensor) of every tensor of a parameter tree, in its
    order; None layers are skipped."""
    if tree is None:
        return []
    if isinstance(tree, dict):
        return [kv for k, v in tree.items() for kv in named_leaves(v, path + (str(k),))]
    if isinstance(tree, (list, tuple)):
        return [kv for i, v in enumerate(tree) for kv in named_leaves(v, path + (str(i),))]
    return [("/".join(path), tree)]


def map_tree(fn: Callable[[torch.Tensor], Any], tree: Any) -> Any:
    """The tree with ``fn`` applied to every tensor."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: map_tree(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [map_tree(fn, v) for v in tree]
    return fn(tree)


def trainable(tree: Any, skip: Callable[[str], bool] = lambda path: False) -> Any:
    """A copy of a parameter tree whose leaves are leaf tensors that require
    grad, except those whose path ``skip`` names (they are detached)."""
    def leaf(path, t):
        return t.detach().clone().requires_grad_(not skip(path))

    names = iter(p for p, _ in named_leaves(tree))
    return map_tree(lambda t: leaf(next(names), t), tree)


def set_grads(loss: torch.Tensor, leaves: List[torch.Tensor]) -> None:
    """Each leaf's .grad <- d loss / d leaf, zeros for a leaf the loss does
    not reach: jax.grad gives those zeros, and optax still decays and steps
    them."""
    grads = torch.autograd.grad(loss, leaves, allow_unused=True, materialize_grads=True)
    for p, g in zip(leaves, grads):
        p.grad = g


def scheduler_at(opt: torch.optim.Optimizer, schedule: Callable[[int], float],
                 step: int = 0) -> torch.optim.lr_scheduler.LambdaLR:
    """A LambdaLR whose rate is ``schedule`` itself (base rate 1.0), as after
    ``step`` updates: the next update takes schedule(step)."""
    for group in opt.param_groups:
        group["initial_lr"] = 1.0
    return torch.optim.lr_scheduler.LambdaLR(opt, schedule, last_epoch=step - 1)


def one_cycle_cosine(lr0: float, lrf: float, total_steps: int) -> Callable[[int], float]:
    """y(t) = lr0 (lrf + (1 - lrf) (1 + cos(pi t / T)) / 2), in float32."""
    f32 = np.float32

    def schedule(step: int) -> float:
        x = np.clip(f32(step) / f32(max(total_steps, 1)), f32(0), f32(1))
        # a Python float beside a float32 array is rounded to float32 first
        return float(f32(lr0) * (f32(lrf) + f32(1.0 - lrf)
                                 * (f32(1) + np.cos(f32(math.pi) * x)) / f32(2)))

    return schedule


def warmup_wrap(schedule: Callable[[int], float], warmup_steps: int) -> Callable[[int], float]:
    """A linear ramp from 0 over the first ``warmup_steps`` steps."""
    f32 = np.float32

    def wrapped(step: int) -> float:
        if step >= warmup_steps:
            return schedule(step)
        warm = np.clip(f32(step) / f32(max(warmup_steps, 1)), f32(0), f32(1))
        return float(warm * f32(schedule(step)))

    return wrapped


def _is_decay_param(path: str, leaf: torch.Tensor) -> bool:
    """Weight decay goes on matrices and conv kernels, not on biases or norms."""
    if leaf.dim() < 2:
        return False
    return not any(k in path for k in ("bn", "norm", "scale", "bias", "pos_embed", "implicit"))


def decay_mask(params: Params) -> Any:
    """The tree of params with True where weight decay applies (JAX's rule)."""
    names = iter(p for p, _ in named_leaves(params))
    return map_tree(lambda t: _is_decay_param(next(names), t), params)


def is_bn_stat(path: str) -> bool:
    """A BN running mean or variance: set by the forward, not the optimizer."""
    return path.rsplit("/", 1)[-1] in ("mean", "var")


def yolo_optimizer(params: Params, lr0: float = 0.01, lrf: float = 0.1,
                   momentum: float = 0.937, weight_decay: float = 5e-4,
                   total_steps: int = 10000, warmup_steps: int = 300, step: int = 0
                   ) -> Tuple[torch.optim.SGD, torch.optim.lr_scheduler.LambdaLR]:
    """SGD with Nesterov momentum over two groups of the params that require
    grad: the decayed ones (``decay_mask``) and the rest. torch's SGD adds
    weight_decay * p to the gradient before the momentum, as JAX's
    optax.chain(add_decayed_weights, sgd(nesterov=True)) does. Returns the
    optimizer and its LambdaLR (step it after each optimizer step), at
    ``step`` updates made."""
    leaves = [(path, t) for path, t in named_leaves(params) if t.requires_grad]
    decay = [t for path, t in leaves if _is_decay_param(path, t)]
    rest = [t for path, t in leaves if not _is_decay_param(path, t)]
    opt = torch.optim.SGD([{"params": decay, "weight_decay": weight_decay},
                           {"params": rest, "weight_decay": 0.0}],
                          lr=1.0, momentum=momentum, nesterov=True)
    schedule = warmup_wrap(one_cycle_cosine(lr0, lrf, total_steps), warmup_steps)
    return opt, scheduler_at(opt, schedule, step)


@dataclass
class EmaState:
    params: Params   # the averaged tree (detached copies)
    updates: int = 0


def ema_init(params: Params) -> EmaState:
    return EmaState(map_tree(lambda t: t.detach().clone(), params), 0)


def ema_update(state: EmaState, new_params: Params, decay: float = 0.9999,
               tau: float = 2000.0) -> EmaState:
    """ModelEMA's ramped decay d = decay (1 - exp(-updates / tau)) in
    float32, e <- e d + p (1 - d) on every leaf (the BN stats included), in
    place."""
    f32 = np.float32
    updates = state.updates + 1
    d = f32(decay) * (f32(1) - np.exp(-f32(updates) / f32(tau)))
    keep, take = float(d), float(f32(1) - d)
    with torch.no_grad():
        for (_, e), (_, p) in zip(named_leaves(state.params), named_leaves(new_params)):
            e.mul_(keep).add_(p.to(e.dtype) * take)
    return EmaState(state.params, updates)
