"""The activation zoo (port of hamer_yolo_tpu/core/activations.py; the
reference's yolo/yolov7/utils/activations.py): SiLU, Hardswish in its
hardtanh form, Mish and FReLU, each a function on NHWC tensors in their
dtype. ``models/yolov7/blocks.conv_block(act=)`` takes any of them in place
of its SiLU; FReLU has parameters (a depthwise k x k conv and a BN), so it
goes through ``frelu_init`` and ``functools.partial(frelu, params)``. The
reference's MemoryEfficient variants only save activation memory in torch's
backward: they are the same functions.
"""
from __future__ import annotations

import torch

from hamer_yolo_tpu_torch.core import nn


def silu(x: torch.Tensor) -> torch.Tensor:
    """x sigmoid(x) (activations.py:10-12)."""
    return x * torch.sigmoid(x)


def hardswish(x: torch.Tensor) -> torch.Tensor:
    """x hardtanh(x + 3, 0, 6) / 6 (activations.py:15-19); the clip shares a
    tie's gradient as jnp.clip does."""
    y = torch.minimum(torch.maximum(x + 3.0, x.new_zeros(())), x.new_full((), 6.0))
    return x * y / 6.0


def mish(x: torch.Tensor) -> torch.Tensor:
    """x tanh(softplus(x)) (activations.py:40-43), softplus as
    jax.nn.softplus: logaddexp(x, 0)."""
    return x * torch.tanh(torch.logaddexp(x, x.new_zeros(())))


def frelu_init(gen: torch.Generator, c: int, k: int = 3) -> nn.Params:
    """FReLU's funnel: a depthwise k x k conv without bias and a BN
    (activations.py:65-72)."""
    return {"conv": nn.conv_init(gen, k, c, c, bias=False, groups=c),
            "bn": nn.batch_norm_init(c, gen.device)}


def frelu(p: nn.Params, x: torch.Tensor) -> torch.Tensor:
    """max(x, BN(dwconv(x))) (activations.py:71-72), BN at torch's default
    eps 1e-5, not YOLO's 1e-3."""
    y = nn.conv2d(p["conv"], x, stride=1, padding=1, groups=x.shape[-1])
    return torch.maximum(x, nn.batch_norm(p["bn"], y, eps=1e-5))


ACTIVATIONS = {"silu": silu, "hardswish": hardswish, "mish": mish}
