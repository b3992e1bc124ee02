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

``AdamW`` is optax.adamw's update, not torch.optim.AdamW's: torch decays a
weight as p (1 - lr wd), a factor that rounds to 1 in float32 at HaMeR's lr
1e-5 and wd 1e-4, so the decay never moves a parameter, and it takes Adam's
bias corrections in float64; optax adds wd p into the update and takes the
corrections in float32.
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


def _f32_bias_correction(decay: float, count: int) -> float:
    """1 - decay^count as optax computes it: float32 decay raised in float64
    (XLA's float32 pow, correctly rounded), the power rounded to float32,
    then subtracted from 1 in float32."""
    f32 = np.float32
    return float(f32(1) - f32(np.float64(f32(decay)) ** count))


class AdamW(torch.optim.Optimizer):
    """optax.adamw over float32 leaves, op for op:
    mu <- (1 - b1) g + b1 mu, nu <- (1 - b2) g^2 + b2 nu,
    u <- (mu / c1) / (sqrt(nu / c2) + eps) + wd p, p <- p + (-lr) u,
    with c = 1 - b^t in float32 (``_f32_bias_correction``), computed once a
    step for the leaves of a group that share a step, device and dtype. Each
    op is one ``torch._foreach_*`` call over those leaves, so each product
    and sum is rounded on its own (no fused multiply-add), the divisions
    are true divisions by tensors on the leaves' device (a division by a
    Python number on CUDA multiplies by its reciprocal), and the square
    root is taken in float64 and rounded back, so that the card's update
    is bit-equal to the CPU's. The leaves go in runs of ADAMW_RUN elements,
    so the temporaries stay within a few of those. The state holds
    torch's names, "exp_avg", "exp_avg_sq" and "step" (training/state.py maps
    them to optax's "mu" and "nu"); ``lr`` is a group's rate, so a LambdaLR
    schedules it as optax.adamw's schedule does."""

    def __init__(self, params, lr: float, betas: Tuple[float, float] = (0.9, 0.999),
                 eps: float = 1e-8, weight_decay: float = 1e-4):
        super().__init__(params, dict(lr=lr, betas=betas, eps=eps, weight_decay=weight_decay))

    @torch.no_grad()
    def step(self, closure=None):
        f32 = np.float32
        for group in self.param_groups:
            b1, b2 = group["betas"]
            lr, eps, wd = (float(f32(group[k])) for k in ("lr", "eps", "weight_decay"))
            live = [p for p in group["params"] if p.grad is not None]
            for p in live:
                if not self.state[p]:
                    self.state[p].update(exp_avg=torch.zeros_like(p),
                                         exp_avg_sq=torch.zeros_like(p), step=torch.tensor(0.0))
            steps = [self.state[p]["step"] for p in live]
            torch._foreach_add_(steps, 1.0)
            buckets: Dict[tuple, List[torch.Tensor]] = {}
            for p, t in zip(live, torch.stack(steps).tolist() if steps else []):
                buckets.setdefault((int(t), p.device, p.dtype), []).append(p)
            for (t, device, dtype), bucket in buckets.items():
                c1 = torch.full((), _f32_bias_correction(b1, t), dtype=dtype, device=device)
                c2 = torch.full((), _f32_bias_correction(b2, t), dtype=dtype, device=device)
                for ps in _runs(bucket, ADAMW_RUN):
                    self._update(ps, c1, c2, b1, b2, lr, eps, wd)

    def _update(self, ps, c1, c2, b1, b2, lr, eps, wd):
        f32 = np.float32
        grads = [p.grad for p in ps]
        mus = [self.state[p]["exp_avg"] for p in ps]
        nus = [self.state[p]["exp_avg_sq"] for p in ps]
        tmp = torch._foreach_mul(grads, float(f32(1 - b1)))
        torch._foreach_mul_(mus, float(f32(b1)))
        torch._foreach_add_(mus, tmp)
        tmp = torch._foreach_mul(grads, grads)
        torch._foreach_mul_(tmp, float(f32(1 - b2)))
        torch._foreach_mul_(nus, float(f32(b2)))
        torch._foreach_add_(nus, tmp)
        del tmp
        den = torch._foreach_div(nus, c2)
        # torch's float32 sqrt on CUDA is not correctly rounded; float64's is,
        # and rounded to float32 it is float32's correctly rounded one (the
        # run's leaves in one buffer: a few launches, not one a leaf)
        flat = torch.cat([d.reshape(-1) for d in den]).double().sqrt_().to(den[0].dtype)
        torch._foreach_copy_(den, [v.view_as(d) for v, d in
                                   zip(flat.split([d.numel() for d in den]), den)])
        del flat
        torch._foreach_add_(den, eps)
        u = torch._foreach_div(mus, c1)
        torch._foreach_div_(u, den)
        del den
        tmp = torch._foreach_mul(ps, wd)
        torch._foreach_add_(u, tmp)
        del tmp
        torch._foreach_mul_(u, -lr)
        torch._foreach_add_(ps, u)


ADAMW_RUN = 1 << 25   # elements a run of leaves that AdamW updates together


def _runs(leaves: List[torch.Tensor], limit: int):
    """``leaves`` in order, in runs of at most ``limit`` elements (a larger
    leaf alone), which bound the update's temporaries."""
    run, n = [], 0
    for p in leaves:
        if run and n + p.numel() > limit:
            yield run
            run, n = [], 0
        run.append(p)
        n += p.numel()
    if run:
        yield run


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
