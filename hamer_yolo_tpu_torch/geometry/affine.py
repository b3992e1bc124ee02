"""Letterbox geometry on tensors (port of
hamer_yolo_tpu/geometry/affine.py:letterbox_geometry_traced)."""
from __future__ import annotations

import torch


def letterbox_geometry_traced(h: torch.Tensor, w: torch.Tensor, out_size: int,
                              stride: float = 32.0):
    """cv2-letterbox-exact geometry for frame sizes held in tensors.

    The reference's rect letterbox (int(round(w r)) resize target, mod-stride
    pad, the round(d - 0.1) quirk) embedded top-left in a static
    out_size x out_size canvas. Returns (r, new_w, new_h, left, top, gain,
    pad) with pad (..., 2) = (dw, dh) unrounded, as the reference's
    scale_coords derives them. ``torch.round`` rounds half to even, like
    Python's round and jnp.round.
    """
    r = torch.minimum(out_size / h, out_size / w)
    new_w = torch.round(w * r)
    new_h = torch.round(h * r)
    dw_total = torch.remainder(out_size - new_w, stride)
    dh_total = torch.remainder(out_size - new_h, stride)
    left = torch.round(dw_total / 2.0 - 0.1)
    top = torch.round(dh_total / 2.0 - 0.1)
    rect_w = new_w + dw_total
    rect_h = new_h + dh_total
    gain = torch.minimum(rect_h / h, rect_w / w)
    pad = torch.stack([(rect_w - w * gain) / 2.0, (rect_h - h * gain) / 2.0], dim=-1)
    return r, new_w, new_h, left, top, gain, pad
