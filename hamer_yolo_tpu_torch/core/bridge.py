"""JAX parameter pytree (as numpy arrays) -> the port's parameters.

The structure (nested dicts and lists, None for parameter-free layers) is
kept; every leaf is mapped by its key and rank, and a leaf that no rule
covers raises, so an unported parameter form (a new head) can never be
loaded silently wrong. The int8 trees of
core/quant (``quantize_vit_params``, ``attach_static_act_scales``,
``quantize_yolo_params``, ``calibrate_yolo_act_scales``) load as they are:
"q" int8 weights (an int8 conv's HWIO -> OIHW as a float conv's), "scale"
f32 vectors, "sx" f32 scalars.

Layouts (the JAX conventions are NHWC, HWIO convs, (in, out) linears):
conv weights HWIO -> OIHW, transposed once here (a grouped conv's HWIO
weight has I = C / groups and gets the same transpose); linear weights stay
(in, out), the layout core/nn.linear and kernel K2 take; vectors and
embeddings are copied as they are. Values stay float32, int8 weights int8
in the same (in, out) layout. A train state's step counts ("step",
"updates") load as int32 scalars; ``to_jax_layout`` goes the other way.
"""
from __future__ import annotations

from typing import Any, Tuple

import numpy as np
import torch

def _same(a: np.ndarray) -> np.ndarray:
    return a


# (key, rank) -> transform of the numpy leaf; a 4-D leaf whose rule is
# _same keeps its layout in both directions, every other one is a conv weight
_RULES = {
    ("w", 4): lambda a: a.transpose(3, 2, 0, 1),  # HWIO -> OIHW
    ("w", 2): _same,                              # (in, out) linear
    ("b", 1): _same,
    ("scale", 1): _same,
    ("bias", 1): _same,
    ("pos_embed", 3): _same,
    ("init_hand_pose", 2): _same,
    ("init_betas", 2): _same,
    ("init_cam", 2): _same,
    ("sx", 0): _same,                             # static activation scale
    ("mean", 1): _same,                           # batch-norm running stats
    ("var", 1): _same,
    ("adj", 2): _same,                            # SAR graph conv's (V, V) adjacency
    ("template", 2): _same,                       # SAR's MANO template (V, 3)
    ("beta", 1): _same,                           # SAR soft-heatmap weights
    ("rpb", 2): _same,                            # Swin's relative position bias table
    # KPFusion (models/kpfusion_rgbd): the decoders' fused in_proj (in, 3 out)
    # and learned per-joint embeddings, BERT's position table, the GAM gate
    ("in_proj_w", 2): _same,
    ("in_proj_b", 1): _same,
    ("self_posembed", 2): _same,
    ("cross_posembed", 2): _same,
    ("pos_embed", 2): _same,
    ("weight_dis", 1): _same,
    ("gamma", 1): _same,                          # ConvNeXt's layer scale
    # pointMLP's geometric affine: (C,) in the classifier, (1, 1, 1, C) in the
    # zoo's LocalGrouper (its torch parameter's shape)
    ("alpha", 1): _same,
    ("alpha", 4): _same,
    ("beta", 4): _same,
}
# int8 leaves: (parent key, key, rank) -> the rule: the int8 linears of
# quantize_vit_params ({"wq": {"q", "scale"}}) and the int8 convs of
# quantize_yolo_params ({"w": {"q", "scale"}, "sx"?}).
_INT8_RULES = {("wq", "q", 2): lambda a: a,       # (in, out) int8 linear
               ("w", "q", 4): _RULES[("w", 4)]}   # int8 conv, HWIO -> OIHW


# integer scalars of a train state (core/checkpoint): its step count and the
# EMA's update count, kept as int32, JAX's dtype
_INT_RULES = {("step", 0), ("updates", 0)}


def _convert(node: Any, path: Tuple[str, ...], device) -> Any:
    if node is None:
        return None
    if isinstance(node, dict):
        return {k: _convert(v, path + (str(k),), device) for k, v in node.items()}
    if isinstance(node, (list, tuple)):
        return [_convert(v, path + (str(i),), device) for i, v in enumerate(node)]
    arr = np.asarray(node)
    key = path[-1] if path else ""
    if arr.dtype.kind in "iu" and (key, arr.ndim) in _INT_RULES:
        return torch.from_numpy(arr.astype(np.int32)).to(device)
    if arr.dtype == np.int8:
        parent = path[-2] if len(path) > 1 else ""
        rule, dtype = _INT8_RULES.get((parent, key, arr.ndim)), np.int8
    else:
        rule, dtype = _RULES.get((key, arr.ndim)), np.float32
    if rule is None or (dtype == np.float32 and arr.dtype.kind != "f"):
        raise KeyError(f"bridge: no mapping for leaf {'/'.join(path)} "
                       f"(shape {arr.shape}, dtype {arr.dtype})")
    return torch.from_numpy(np.array(rule(arr), dtype=dtype, order="C")).to(device)


def from_jax_params(tree: Any, device="cpu") -> Any:
    """Convert a JAX parameter pytree whose leaves are numpy arrays (or
    anything ``np.asarray`` takes) into the port's tensors on ``device``."""
    return _convert(tree, (), device)


def to_jax_layout(tree: Any, key: str = "") -> Any:
    """The inverse of ``from_jax_params``: the port's tensors (any device) ->
    numpy leaves in JAX layout, 4-D conv weights (OIHW) back to HWIO and the
    4-D leaves that _RULES keeps as they are (pointMLP's "alpha", "beta")
    unchanged; numpy and Python leaves are taken as they are."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: to_jax_layout(v, str(k)) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [to_jax_layout(v) for v in tree]
    if not isinstance(tree, torch.Tensor):
        return np.asarray(tree)
    a = tree.detach().cpu().numpy()
    conv = a.ndim == 4 and _RULES.get((key, 4)) is not _same
    return np.ascontiguousarray(a.transpose(2, 3, 1, 0)) if conv else a
