"""Training losses (port of hamer_yolo_tpu/training/losses.py), in the JAX
package's order of operations.

HaMeR: confidence-weighted L1 on the 2D keypoints and on the root-relative
3D keypoints (root 0), the masked MSE of the MANO parameters, and the LSGAN
adversarial terms; the weights of the reference's hamer_vit_transformer.yaml.

YOLOv7 (the reference's non-OTA ComputeLoss): CIoU box loss on the matched
anchors, BCE objectness against the clamped IoU of the last candidate
written to a cell, BCE classes; anchors matched by wh ratio (< anchor_t)
in the centre cell and its two nearest neighbours, over a fixed capacity of
targets (padded rows have w == 0). The SimOTA assigner, the auxiliary heads
and the IBin head's loss are not ported yet: they raise.

jnp.maximum, jnp.minimum and jnp.clip share a gradient between tied
operands, half each; torch.maximum and torch.minimum do the same, while
torch.clamp does not, so the losses clip with the former. jnp.abs has the
gradient 1 at 0, torch.abs 0: the losses take ``abs_`` (at logits of 0,
bce_logits' gradient is so -t in both packages, not sigmoid(0) - t).
"""
from __future__ import annotations

import math
from typing import Dict, List, Sequence, Tuple

import torch

HAMER_LOSS_WEIGHTS = {
    "keypoints_3d": 0.05,
    "keypoints_2d": 0.01,
    "global_orient": 0.001,
    "hand_pose": 0.001,
    "betas": 0.0005,
    "adversarial": 0.0005,
}

NOT_PORTED = "the next slice of the training port (SimOTA, the aux heads, IBin's loss)"


def abs_(x: torch.Tensor) -> torch.Tensor:
    """|x| with jnp.abs's gradient: 1 at 0."""
    return torch.where(x >= 0, x, -x)


# --------------------------------------------------------------------------
# HaMeR
# --------------------------------------------------------------------------

def keypoint_2d_loss(pred: torch.Tensor, gt: torch.Tensor) -> torch.Tensor:
    """pred (B, N, 2); gt (B, N, 3) with the confidence in [..., 2]."""
    conf = gt[..., 2:3]
    return torch.sum(conf * abs_(pred - gt[..., :2])) / pred.shape[0]


def keypoint_3d_loss(pred: torch.Tensor, gt: torch.Tensor, root_idx: int = 0) -> torch.Tensor:
    """pred (B, N, 3); gt (B, N, 4) with the confidence; both root-centred."""
    conf = gt[..., 3:4]
    pred_c = pred - pred[:, root_idx:root_idx + 1]
    gt_c = gt[..., :3] - gt[:, root_idx:root_idx + 1, :3]
    return torch.sum(conf * abs_(pred_c - gt_c)) / pred.shape[0]


def parameter_loss(pred: torch.Tensor, gt: torch.Tensor, has: torch.Tensor) -> torch.Tensor:
    """MSE masked per sample by has (B,), the annotation's validity."""
    B = pred.shape[0]
    mask = has.reshape((B,) + (1,) * (pred.dim() - 1))
    return torch.sum(mask * (pred - gt) ** 2) / B


def adversarial_gen_loss(fake_logits: torch.Tensor) -> torch.Tensor:
    """LSGAN generator loss: (D(fake) - 1)^2."""
    return torch.mean((fake_logits - 1.0) ** 2, dim=-1).sum() / fake_logits.shape[0]


def adversarial_disc_loss(real_logits: torch.Tensor, fake_logits: torch.Tensor) -> torch.Tensor:
    real = torch.mean((real_logits - 1.0) ** 2, dim=-1).sum() / real_logits.shape[0]
    fake = torch.mean(fake_logits ** 2, dim=-1).sum() / fake_logits.shape[0]
    return real + fake


# --------------------------------------------------------------------------
# YOLO
# --------------------------------------------------------------------------

def _clip_min0(x: torch.Tensor) -> torch.Tensor:
    """jnp.clip(x, 0): a tie's gradient halved, as jnp.maximum's."""
    return torch.maximum(x, x.new_zeros(()))


def bbox_ciou(box1: torch.Tensor, box2: torch.Tensor, eps: float = 1e-7) -> torch.Tensor:
    """CIoU between (..., 4) xywh boxes (the reference's bbox_iou(CIoU=True));
    alpha carries no gradient."""
    b1x1, b1y1 = box1[..., 0] - box1[..., 2] / 2, box1[..., 1] - box1[..., 3] / 2
    b1x2, b1y2 = box1[..., 0] + box1[..., 2] / 2, box1[..., 1] + box1[..., 3] / 2
    b2x1, b2y1 = box2[..., 0] - box2[..., 2] / 2, box2[..., 1] - box2[..., 3] / 2
    b2x2, b2y2 = box2[..., 0] + box2[..., 2] / 2, box2[..., 1] + box2[..., 3] / 2

    inter = _clip_min0(torch.minimum(b1x2, b2x2) - torch.maximum(b1x1, b2x1)) * \
        _clip_min0(torch.minimum(b1y2, b2y2) - torch.maximum(b1y1, b2y1))
    w1, h1 = box1[..., 2], box1[..., 3]
    w2, h2 = box2[..., 2], box2[..., 3]
    union = w1 * h1 + w2 * h2 - inter + eps
    iou = inter / union

    cw = torch.maximum(b1x2, b2x2) - torch.minimum(b1x1, b2x1)
    ch = torch.maximum(b1y2, b2y2) - torch.minimum(b1y1, b2y1)
    c2 = cw ** 2 + ch ** 2 + eps
    rho2 = (box2[..., 0] - box1[..., 0]) ** 2 + (box2[..., 1] - box1[..., 1]) ** 2
    v = (4 / math.pi ** 2) * (torch.atan(w2 / (h2 + eps)) - torch.atan(w1 / (h1 + eps))) ** 2
    alpha = (v / (v - iou + (1 + eps))).detach()
    return iou - rho2 / c2 - alpha * v


def bce_logits(logits: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    return _clip_min0(logits) - logits * targets + torch.log1p(torch.exp(-abs_(logits)))


def _level_candidates(raw: torch.Tensor, targets: torch.Tensor, anc_px: torch.Tensor,
                      stride: int, anchor_t: float, g: float, na: int) -> Dict:
    """One level's candidates (build_targets' core): for every (target,
    centre or neighbour cell within g, anchor), the prediction there, whether
    it matches, and its CIoU with the target."""
    B, H, W, _ = raw.shape
    no = raw.shape[-1] // na
    m = raw.reshape(B, H, W, na, no).permute(0, 3, 1, 2, 4)      # (B, na, H, W, no)
    dev, dt = raw.device, raw.dtype
    hw = torch.tensor([W, H], dtype=dt, device=dev)

    t_xy = targets[..., 1:3] * hw                                  # grid units
    t_wh = targets[..., 3:5] * hw
    valid = targets[..., 3] > 0                                    # (B, T)

    anc = anc_px / stride                                          # (na, 2) grid units
    r = t_wh[:, :, None, :] / anc[None, None]                      # (B, T, na, 2)
    ratio_ok = torch.amax(torch.maximum(r, 1.0 / r), dim=-1) < anchor_t

    # the centre cell and the neighbours within g: the reference's offsets
    # [[0, 0], [1, 0], [0, 1], [-1, 0], [0, -1]] * g, its far-side masks
    # taken as (grid - xy) % 1 < g, which also holds at fx == 0 exactly
    cx, cy = t_xy[..., 0], t_xy[..., 1]
    fx, fy = cx - torch.floor(cx), cy - torch.floor(cy)
    offs = torch.tensor([[0.0, 0.0], [g, 0.0], [0.0, g], [-g, 0.0], [0.0, -g]], dtype=dt,
                        device=dev)
    inv_x, inv_y = W - cx, H - cy
    active = torch.stack([torch.ones_like(valid), (fx < g) & (cx > 1.0), (fy < g) & (cy > 1.0),
                          (torch.remainder(inv_x, 1.0) < g) & (inv_x > 1.0),
                          (torch.remainder(inv_y, 1.0) < g) & (inv_y > 1.0)], dim=2)  # (B, T, 5)

    cells = torch.floor(t_xy[:, :, None, :] - offs).to(torch.int64)       # (B, T, 5, 2)
    cells_x = torch.clamp(cells[..., 0], 0, W - 1)
    cells_y = torch.clamp(cells[..., 1], 0, H - 1)

    bidx = torch.arange(B, device=dev)[:, None, None, None]
    aidx = torch.arange(na, device=dev)[None, None, None, :]
    psel = m[bidx, aidx, cells_y[..., None], cells_x[..., None], :]        # (B, T, 5, na, no)

    match = valid[:, :, None, None] & active[..., None] & ratio_ok[:, :, None, :]
    match_f = match.to(dt)

    ps_xy = torch.sigmoid(psel[..., 0:2]) * 2.0 - 0.5
    rel_xy = (t_xy[:, :, None, None, :] - cells[:, :, :, None, :].to(dt)).expand(ps_xy.shape)
    ps_wh = (torch.sigmoid(psel[..., 2:4]) * 2.0) ** 2 * anc[None, None, None]
    pbox = torch.cat([ps_xy, ps_wh], dim=-1)
    tbox = torch.cat([rel_xy, t_wh[:, :, None, None, :].expand(ps_wh.shape)], dim=-1)
    return {"m": m, "psel": psel, "match_f": match_f, "ciou": bbox_ciou(pbox, tbox),
            "t_cls": targets[..., 0].to(torch.int64), "cells_x": cells_x, "cells_y": cells_y,
            "bidx": bidx, "aidx": aidx, "H": H, "W": W}


def _last_write_obj_target(iou_clamped: torch.Tensor, match: torch.Tensor, pri: torch.Tensor,
                           flat_idx: torch.Tensor, num_segments: int) -> torch.Tensor:
    """The objectness targets with the reference's duplicate writes: its
    ``tobj[b, a, gj, gi] = iou`` keeps the last write, in the order
    build_targets emits the candidates (offset group, then anchor, then
    target), which ``pri`` encodes (+1; 0 = unmatched)."""
    pri_m = torch.where(match, pri, torch.zeros_like(pri)).reshape(-1)
    idx = flat_idx.reshape(-1)
    seg_pri = torch.zeros(num_segments, dtype=pri.dtype, device=pri.device)
    seg_pri = seg_pri.scatter_reduce(0, idx, pri_m, reduce="amax")
    win = match & (pri == seg_pri[flat_idx])
    vals = torch.where(win, iou_clamped, torch.zeros_like(iou_clamped)).reshape(-1)
    return torch.zeros(num_segments, dtype=vals.dtype, device=vals.device).index_add(0, idx, vals)


def _candidate_priority(T: int, na: int, shape, device) -> torch.Tensor:
    """Write-order priority over a (B, T, 5, na) candidate grid."""
    t_idx = torch.arange(T, device=device)[None, :, None, None]
    off_idx = torch.arange(5, device=device)[None, None, :, None]
    a_idx = torch.arange(na, device=device)[None, None, None, :]
    return (off_idx * (na * T) + a_idx * T + t_idx + 1).expand(shape)


def _accumulate_losses(per_level: List[Dict], nc: int, balance: Sequence[float], B: int,
                       na: int) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    total_box = total_obj = total_cls = 0.0
    for lvl, d in enumerate(per_level):
        m, match_f, ciou = d["m"], d["match_f"], d["ciou"]
        H, W = d["H"], d["W"]
        n_match = torch.clamp(match_f.sum(), min=1.0)
        total_box = total_box + ((1.0 - ciou) * match_f).sum() / n_match

        flat = (d["bidx"] * (na * H * W) + d["aidx"] * (H * W)
                + d["cells_y"][..., None] * W + d["cells_x"][..., None])
        pri = _candidate_priority(match_f.shape[1], na, match_f.shape, m.device)
        obj_target = _last_write_obj_target(_clip_min0(ciou.detach()), match_f > 0, pri, flat,
                                            B * na * H * W).reshape(B, na, H, W)
        total_obj = total_obj + bce_logits(m[..., 4], obj_target).mean() * balance[lvl]

        if nc > 1:
            cls_t = torch.nn.functional.one_hot(d["t_cls"], nc).to(ciou.dtype)
            cls_logits = d["psel"][..., 5:]
            cls_tgt = cls_t[:, :, None, None, :].expand(cls_logits.shape)
            total_cls = total_cls + (bce_logits(cls_logits, cls_tgt) * match_f[..., None]).sum() \
                / (n_match * nc)
    return total_box, total_obj, total_cls


def yolo_loss(raw_maps: Sequence[torch.Tensor], targets: torch.Tensor, anchors: torch.Tensor,
              strides: Tuple[int, ...], nc: int, box_w: float = 0.05, obj_w: float = 0.7,
              cls_w: float = 0.3, anchor_t: float = 4.0, assigner: str = "neighbor",
              aux_maps=None, head: str = "detect") -> Dict[str, torch.Tensor]:
    """The fixed-capacity YOLO loss: raw_maps, the nl raw head maps
    (B, H, W, na (nc + 5)) before the sigmoid; targets (B, T, 5) padded
    labels [cls, cx, cy, w, h] in 0..1, w == 0 on padding; anchors
    (nl, na, 2) in pixels. Returns {"loss": the weighted sum times B, as the
    reference scales it, "box", "obj", "cls"}. Only the "neighbor" assigner
    (the reference's non-OTA ComputeLoss) is ported: "simota", ``aux_maps``
    and the "bin" head raise."""
    if assigner != "neighbor" or aux_maps is not None or head != "detect":
        raise NotImplementedError(
            f"yolo_loss(assigner={assigner!r}, aux_maps={'set' if aux_maps is not None else None},"
            f" head={head!r}) is not ported: it comes with {NOT_PORTED}")
    B = raw_maps[0].shape[0]
    na = anchors.shape[1]
    L = len(raw_maps)
    # the reference's per-level objectness balance (loss.py:1200)
    balance = (4.0, 1.0, 0.4) if L == 3 else (4.0, 1.0, 0.25, 0.06, 0.02)[:L]
    per_level = [_level_candidates(raw, targets, anchors[lvl], strides[lvl], anchor_t, 0.5, na)
                 for lvl, raw in enumerate(raw_maps)]
    total_box, total_obj, total_cls = _accumulate_losses(per_level, nc, balance, B, na)
    loss = box_w * total_box + obj_w * total_obj + cls_w * total_cls
    zero = raw_maps[0].new_zeros(())
    return {"loss": loss * B, "box": zero + total_box, "obj": zero + total_obj,
            "cls": zero + total_cls}
