"""Train states in the port's checkpoint file (core/checkpoint.py).

A train state is written as one tree: the parameters, each optimizer's
state as trees shaped like the parameters under optax's names (Adam's "mu"
and "nu", SGD's "trace"), the step count and, for YOLO, the EMA. Every
tree goes through ``bridge.to_jax_layout`` (JAX layout, numpy) into
``save_checkpoint`` and comes back through ``load_checkpoint``; restoring
copies the values into the live tensors of a freshly built state, so its
optimizers keep their parameter groups. A reload is bit-equal.
"""
from __future__ import annotations

from typing import Any, Dict

import torch

from hamer_yolo_tpu_torch.core.bridge import to_jax_layout
from hamer_yolo_tpu_torch.core.checkpoint import save_checkpoint
from hamer_yolo_tpu_torch.training.optim import map_tree, named_leaves

ADAM_KEYS = {"mu": "exp_avg", "nu": "exp_avg_sq"}
SGD_KEYS = {"trace": "momentum_buffer"}


def optimizer_tree(opt: torch.optim.Optimizer, params: Any, keys: Dict[str, str]) -> Dict:
    """{optax name: a tree like params holding that state of each parameter
    that requires grad (zeros before the first step), None elsewhere}."""
    def leaf(name):
        def get(t):
            if not t.requires_grad:
                return None
            st = opt.state.get(t, {})
            return st[name] if name in st else torch.zeros_like(t)
        return get

    return {ours: map_tree(leaf(theirs), params) for ours, theirs in keys.items()}


def load_optimizer_tree(opt: torch.optim.Optimizer, params: Any, tree: Dict,
                        keys: Dict[str, str], step: int) -> None:
    """Set the state of ``opt`` over ``params`` from ``optimizer_tree``'s
    form, as after ``step`` updates."""
    trainable = [t for _, t in named_leaves(params) if t.requires_grad]
    columns = {theirs: [v for _, v in named_leaves(tree[ours])] for ours, theirs in keys.items()}
    for i, p in enumerate(trainable):
        state = {theirs: vals[i].to(p.device, p.dtype).clone() for theirs, vals in columns.items()}
        if "exp_avg" in state:
            state["step"] = torch.tensor(float(step))
        opt.state[p] = state


def copy_into(dst: Any, src: Any) -> None:
    """dst's tensors <- src's values, in place, leaf by leaf."""
    with torch.no_grad():
        for (_, d), (_, s) in zip(named_leaves(dst), named_leaves(src), strict=True):
            d.copy_(s)


def save_state(path: str, tree: Any) -> None:
    """``tree`` (tensors on any device) in JAX layout through ``save_checkpoint``."""
    save_checkpoint(path, to_jax_layout(tree))
