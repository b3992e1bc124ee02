"""JAX parameter pytree (as numpy arrays) -> the port's parameters.

The structure (nested dicts and lists, None for parameter-free layers) is
kept; every leaf is mapped by its key and rank, and a leaf that no rule
covers raises, so an unported parameter form (int8 conv weights, a new
head) can never be loaded silently wrong. The int8 trees of
core/quant (``quantize_vit_params``, ``attach_static_act_scales``) load as
they are: "q" int8 weights, "scale" f32 vectors, "sx" f32 scalars.

Layouts (the JAX conventions are NHWC, HWIO convs, (in, out) linears):
conv weights HWIO -> OIHW, transposed once here (a grouped conv's HWIO
weight has I = C / groups and gets the same transpose); linear weights stay
(in, out), the layout core/nn.linear and kernel K2 take; vectors and
embeddings are copied as they are. Values stay float32, int8 weights int8
in the same (in, out) layout.
"""
from __future__ import annotations

from typing import Any, Tuple

import numpy as np
import torch

# (key, rank) -> transform of the numpy leaf
_RULES = {
    ("w", 4): lambda a: a.transpose(3, 2, 0, 1),  # HWIO -> OIHW
    ("w", 2): lambda a: a,                        # (in, out) linear
    ("b", 1): lambda a: a,
    ("scale", 1): lambda a: a,
    ("bias", 1): lambda a: a,
    ("pos_embed", 3): lambda a: a,
    ("init_hand_pose", 2): lambda a: a,
    ("init_betas", 2): lambda a: a,
    ("init_cam", 2): lambda a: a,
    ("sx", 0): lambda a: a,                       # static activation scale
    ("mean", 1): lambda a: a,                     # batch-norm running stats
    ("var", 1): lambda a: a,
    ("adj", 2): lambda a: a,                      # SAR graph conv's (V, V) adjacency
    ("template", 2): lambda a: a,                 # SAR's MANO template (V, 3)
    ("beta", 1): lambda a: a,                     # SAR soft-heatmap weights
    ("rpb", 2): lambda a: a,                      # Swin's relative position bias table
    # KPFusion (models/kpfusion_rgbd): the decoders' fused in_proj (in, 3 out)
    # and learned per-joint embeddings, BERT's position table, the GAM gate
    ("in_proj_w", 2): lambda a: a,
    ("in_proj_b", 1): lambda a: a,
    ("self_posembed", 2): lambda a: a,
    ("cross_posembed", 2): lambda a: a,
    ("pos_embed", 2): lambda a: a,
    ("weight_dis", 1): lambda a: a,
}
# int8 leaves: (parent key, key, rank) -> the rule. Only the int8 linears of
# quantize_vit_params ({"wq": {"q", "scale"}}) are ported; the int8 convs of
# JAX's quantize_yolo_params ({"w": {"q", "scale"}}) still raise.
_INT8_RULES = {("wq", "q", 2): lambda a: a}       # (in, out) int8 linear


def _convert(node: Any, path: Tuple[str, ...], device) -> Any:
    if node is None:
        return None
    if isinstance(node, dict):
        return {k: _convert(v, path + (str(k),), device) for k, v in node.items()}
    if isinstance(node, (list, tuple)):
        return [_convert(v, path + (str(i),), device) for i, v in enumerate(node)]
    arr = np.asarray(node)
    key = path[-1] if path else ""
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
