"""Training losses (port of hamer_yolo_tpu/training/losses.py), in the JAX
package's order of operations.

HaMeR: confidence-weighted L1 on the 2D keypoints and on the root-relative
3D keypoints (root 0), the masked MSE of the MANO parameters, and the LSGAN
adversarial terms; the weights of the reference's hamer_vit_transformer.yaml.

YOLOv7: CIoU box loss on the assigned anchors, BCE objectness against the
clamped IoU of the last candidate written to a cell, BCE classes, over a
fixed capacity of targets (padded rows have w == 0). The candidates are
the anchors matched by wh ratio (< anchor_t) in the centre cell and its two
nearest neighbours; the "neighbor" assigner (the reference's ComputeLoss)
takes them all, "simota" (ComputeLossOTA) picks among them per image by
cost with fixed shapes (T targets x candidates), IBin's loss on it
(ComputeLossBinOTA), and an IAuxDetect head's auxiliary maps add
ComputeLossAuxOTA's quarter.

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

from hamer_yolo_tpu_torch.models.yolov7 import heads as H

HAMER_LOSS_WEIGHTS = {
    "keypoints_3d": 0.05,
    "keypoints_2d": 0.01,
    "global_orient": 0.001,
    "hand_pose": 0.001,
    "betas": 0.0005,
    "adversarial": 0.0005,
}

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


def _clip(x: torch.Tensor, lo: float, hi: float) -> torch.Tensor:
    """jnp.clip(x, lo, hi): a tie's gradient halved."""
    return torch.minimum(torch.maximum(x, x.new_full((), lo)), x.new_full((), hi))


def _level_layout(nc: int, head: str, bin_count: int) -> Tuple[int, int]:
    """(outputs per anchor, objectness channel) of a head's raw map: IBin's
    anchor holds [x, y, w bins (bin_count + 1), h bins, obj, classes]."""
    if head == "bin":
        return nc + 3 + 2 * (bin_count + 1), 2 + 2 * (bin_count + 1)
    return nc + 5, 4


def _level_candidates(raw: torch.Tensor, targets: torch.Tensor, anc_px: torch.Tensor,
                      stride: int, anchor_t: float, g: float, na: int, nc: int, lvl: int,
                      head: str = "detect", bin_count: int = 21) -> Dict:
    """One level's candidates (build_targets' core): for every (target,
    centre or neighbour cell within g, anchor), the prediction there, whether
    it matches, and its CIoU with the target. ``head`` "bin" only changes the
    channel layout here: SimOTA's pooled losses decode IBin's bins."""
    B, H, W, _ = raw.shape
    no, obj_idx = _level_layout(nc, head, bin_count)
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
            "bidx": bidx, "aidx": aidx, "H": H, "W": W, "anc": anc, "obj_idx": obj_idx,
            "lvl": lvl}


def _plain_iou_xywh(box1: torch.Tensor, box2: torch.Tensor, eps: float = 1e-7) -> torch.Tensor:
    """IoU of xywh boxes (the reference's box_iou on xyxy): SimOTA's cost."""
    b1x1, b1y1 = box1[..., 0] - box1[..., 2] / 2, box1[..., 1] - box1[..., 3] / 2
    b1x2, b1y2 = box1[..., 0] + box1[..., 2] / 2, box1[..., 1] + box1[..., 3] / 2
    b2x1, b2y1 = box2[..., 0] - box2[..., 2] / 2, box2[..., 1] - box2[..., 3] / 2
    b2x2, b2y2 = box2[..., 0] + box2[..., 2] / 2, box2[..., 1] + box2[..., 3] / 2
    inter = _clip_min0(torch.minimum(b1x2, b2x2) - torch.maximum(b1x1, b2x1)) * \
        _clip_min0(torch.minimum(b1y2, b2y2) - torch.maximum(b1y1, b2y1))
    union = box1[..., 2] * box1[..., 3] + box2[..., 2] * box2[..., 3] - inter + eps
    return inter / union


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
        total_obj = total_obj + bce_logits(m[..., d["obj_idx"]], obj_target).mean() * balance[lvl]

        if nc > 1:
            cls_t = torch.nn.functional.one_hot(d["t_cls"], nc).to(ciou.dtype)
            cls_logits = d["psel"][..., d["obj_idx"] + 1:]
            cls_tgt = cls_t[:, :, None, None, :].expand(cls_logits.shape)
            total_cls = total_cls + (bce_logits(cls_logits, cls_tgt) * match_f[..., None]).sum() \
                / (n_match * nc)
    return total_box, total_obj, total_cls


def yolo_loss(raw_maps: Sequence[torch.Tensor], targets: torch.Tensor, anchors: torch.Tensor,
              strides: Tuple[int, ...], nc: int, box_w: float = 0.05, obj_w: float = 0.7,
              cls_w: float = 0.3, anchor_t: float = 4.0, assigner: str = "neighbor",
              ota_topk: int = 10, aux_maps=None, head: str = "detect", bin_count: int = 21
              ) -> Dict[str, torch.Tensor]:
    """The fixed-capacity YOLO loss: raw_maps, the nl raw head maps
    (B, H, W, na no) before the sigmoid; targets (B, T, 5) padded labels
    [cls, cx, cy, w, h] in 0..1, w == 0 on padding; anchors (nl, na, 2) in
    pixels. Returns {"loss": the weighted sum times B, as the reference
    scales it, "box", "obj", "cls"}.

    ``assigner`` "neighbor" is the reference's ComputeLoss (loss.py:425-558);
    "simota" its ComputeLossOTA (loss.py:559-851; ComputeLossBinOTA for
    ``head`` "bin", the only loss IBin has): the neighbour candidates of
    every target and level pooled per image, each target taking its
    dynamic k = max(1, int(sum of its top ``ota_topk`` IoUs)) cheapest
    candidates (cost: the class BCE + 3 (-log IoU)), a candidate that two
    targets take going to its cheapest target. ``aux_maps``, the nl
    auxiliary maps of an IAuxDetect head, add ComputeLossAuxOTA's 0.25 of
    their losses: their candidates within g = 1 of a target, selected on
    the lead maps' costs."""
    B, T = targets.shape[:2]
    na = anchors.shape[1]
    L = len(raw_maps)
    # the reference's per-level objectness balance (loss.py:1200)
    balance = (4.0, 1.0, 0.4) if L == 3 else (4.0, 1.0, 0.25, 0.06, 0.02)[:L]
    if head == "bin" and assigner != "simota":
        raise ValueError("the IBin head only has an OTA loss (ComputeLossBinOTA, loss.py:852)")
    if assigner not in ("neighbor", "simota"):
        raise ValueError(f"yolo_loss: unknown assigner {assigner!r}")

    def levels(maps, g, lhead="detect"):
        return [_level_candidates(raw, targets, anchors[lvl], strides[lvl], anchor_t, g, na, nc,
                                  lvl, lhead, bin_count) for lvl, raw in enumerate(maps)]

    if assigner == "simota":
        total_box, total_obj, total_cls = _simota_pooled_losses(
            levels(raw_maps, 0.5, head), targets, strides, nc, head, bin_count, balance,
            ota_topk, B, T, na)
        if aux_maps is not None:
            a_box, a_obj, a_cls = _simota_pooled_losses(
                levels(raw_maps, 1.0), targets, strides, nc, head, bin_count, balance, ota_topk,
                B, T, na, loss_level=levels(aux_maps, 1.0))
    else:
        total_box, total_obj, total_cls = _accumulate_losses(levels(raw_maps, 0.5), nc, balance,
                                                             B, na)
        if aux_maps is not None:
            a_box, a_obj, a_cls = _accumulate_losses(levels(aux_maps, 1.0), nc, balance, B, na)
    if aux_maps is not None:
        total_box = total_box + 0.25 * a_box
        total_obj = total_obj + 0.25 * a_obj
        total_cls = total_cls + 0.25 * a_cls
    loss = box_w * total_box + obj_w * total_obj + cls_w * total_cls
    zero = raw_maps[0].new_zeros(())
    return {"loss": loss * B, "box": zero + total_box, "obj": zero + total_obj,
            "cls": zero + total_cls}


def _flatten_level(d: Dict, B: int, stride: int, head: str, bin_count: int) -> Dict:
    """A level's (B, T, 5, na) candidates as C = T 5 na columns: the
    predictions, whether each exists, its cell and anchor, and its box in
    input pixels (IBin: the bins decoded)."""
    obj_idx, psel, match_f = d["obj_idx"], d["psel"], d["match_f"]
    C = psel.shape[1] * psel.shape[2] * psel.shape[3]
    ps = psel.reshape(B, C, psel.shape[-1])
    cellx = d["cells_x"][..., None].expand(match_f.shape).reshape(B, C)
    celly = d["cells_y"][..., None].expand(match_f.shape).reshape(B, C)
    anc = d["anc"][None, None, None].expand(match_f.shape + (2,)).reshape(B, C, 2)
    cell = torch.stack([cellx, celly], dim=-1).to(ps.dtype)
    xy_grid = torch.sigmoid(ps[..., 0:2]) * 2.0 - 0.5 + cell
    Lb = bin_count + 1
    if head == "bin":
        w_logits, h_logits = ps[..., 2:2 + Lb], ps[..., 2 + Lb:obj_idx]
        wh = torch.stack([H.sigmoid_bin_decode(torch.sigmoid(w_logits), bin_count),
                          H.sigmoid_bin_decode(torch.sigmoid(h_logits), bin_count)], dim=-1) * anc
    else:
        w_logits = h_logits = None
        wh = (torch.sigmoid(ps[..., 2:4]) * 2.0) ** 2 * anc
    return {"ps": ps, "exist": match_f.reshape(B, C) > 0, "cell": cell, "anc": anc,
            "obj_idx": obj_idx, "box_px": torch.cat([xy_grid * stride, wh * stride], dim=-1),
            "stride": stride, "C": C, "w_logits": w_logits, "h_logits": h_logits,
            "obj_logit": ps[..., obj_idx], "cls_logits": ps[..., obj_idx + 1:], "d": d}


def _simota_pooled_losses(per_level: List[Dict], targets: torch.Tensor, strides, nc: int,
                          head: str, bin_count: int, balance, ota_topk: int, B: int, T: int,
                          na: int, loss_level: List[Dict] = None):
    """ComputeLoss(Bin)OTA's build_targets and losses with fixed shapes
    (JAX's exact pooled form, loss.py:559-851 / :852-1178).

    The reference pools all neighbour candidates of an image, over targets
    and levels, into one cost matrix: a cell that target A brought can go
    to target B, and the same (cell, anchor) from two source targets is two
    columns. Here the pool is each level's padded (T 5 na) candidate grid,
    masked by existence. Ties: the cost order is a stable sort, a column's
    cheapest target the first of equal costs, as jnp.argsort and
    jnp.argmin; only the sum of the top IoUs enters dynamic k, so
    torch.topk's order of equal IoUs is free.

    ``loss_level``: the assignment from ``per_level``'s predictions, the
    losses from ``loss_level``'s at the same cells (ComputeLossAuxOTA's
    auxiliary branch, loss.py:1209-1211; its 0.25 applied by the caller).
    """
    BIG = 1e9
    dev, dt = targets.device, targets.dtype
    img_wh = torch.tensor([per_level[0]["W"] * strides[0], per_level[0]["H"] * strides[0]],
                          dtype=dt, device=dev)
    gt_cls = targets[..., 0].to(torch.int64)                        # (B, T)
    gt_valid = targets[..., 3] > 0
    gt_box_px = torch.cat([targets[..., 1:3] * img_wh, targets[..., 3:5] * img_wh], dim=-1)

    lvl_data = [_flatten_level(d, B, strides[d["lvl"]], head, bin_count) for d in per_level]
    lvl_loss = lvl_data if loss_level is None else [
        _flatten_level(d, B, strides[d["lvl"]], head, bin_count) for d in loss_level]

    cand_box = torch.cat([v["box_px"] for v in lvl_data], dim=1).detach()
    cand_exist = torch.cat([v["exist"] for v in lvl_data], dim=1)
    cand_obj = torch.cat([v["obj_logit"] for v in lvl_data], dim=1).detach()
    cand_cls = torch.cat([v["cls_logits"] for v in lvl_data], dim=1).detach()

    # the pairwise cost (B, T, Ctot), assignment only (no gradient)
    iou = _plain_iou_xywh(cand_box[:, None, :, :], gt_box_px[:, :, None, :])
    mask = cand_exist[:, None, :] & gt_valid[:, :, None]
    iou_m = _clip(iou, 0.0, 1.0) * mask
    onehot = torch.nn.functional.one_hot(gt_cls, nc).to(dt)        # (B, T, nc)
    y = torch.sqrt(torch.sigmoid(cand_cls) * torch.sigmoid(cand_obj)[..., None])
    bce_cost = -(onehot[:, :, None, :] * torch.log(y[:, None] + 1e-8)
                 + (1 - onehot[:, :, None, :]) * torch.log(1 - y[:, None] + 1e-8))
    cost = bce_cost.sum(-1) + 3.0 * (-torch.log(iou_m + 1e-8))
    cost = torch.where(mask, cost, cost.new_full((), BIG))

    topk_iou = torch.topk(iou_m, min(ota_topk, iou_m.shape[-1]), dim=-1).values
    dyn_k = torch.clamp(topk_iou.sum(-1).to(torch.int32), min=1)
    order = torch.argsort(cost, dim=-1, stable=True)
    ranks = torch.argsort(order, dim=-1, stable=True)
    select = (ranks < dyn_k[..., None]) & mask
    # a column that two or more targets select goes to its cheapest target
    # over all rows, selectors or not (loss.py:755-758); single selections stay
    conflict = select.sum(dim=1, keepdim=True) > 1                   # (B, 1, C)
    winner = torch.nn.functional.one_hot(torch.argmin(cost, dim=1), T).to(torch.bool)
    select = torch.where(conflict, winner.transpose(1, 2), select)
    sel_f = select.to(dt)

    total_box = total_obj = total_cls = 0.0
    centers = H.sigmoid_bin_centers(bin_count, dev)
    off = 0
    for v in lvl_loss:
        C, d = v["C"], v["d"]
        sl = sel_f[:, :, off:off + C]                                # (B, T, C)
        n_den = torch.clamp(sl.sum(), min=1.0)
        Hl, Wl = d["H"], d["W"]
        lvl_wh = torch.tensor([Wl, Hl], dtype=dt, device=dev)
        t_xy, t_wh = targets[..., 1:3] * lvl_wh, targets[..., 3:5] * lvl_wh
        xy_grid = (torch.sigmoid(v["ps"][..., 0:2]) * 2.0 - 0.5) + v["cell"]
        if head == "bin":
            vmin, vmax, reg_scale = H.BIN_MIN, H.BIN_MAX, H.BIN_REG_SCALE
            step = (vmax - vmin) / bin_count
            tw = t_wh[..., 0][:, :, None] / v["anc"][..., 0][:, None, :]
            th = t_wh[..., 1][:, :, None] / v["anc"][..., 1][:, None, :]
            idx_w = torch.argmin(torch.abs(tw[..., None] - centers), dim=-1)
            idx_h = torch.argmin(torch.abs(th[..., None] - centers), dim=-1)
            reg_w = (torch.sigmoid(v["w_logits"][..., 0]) * reg_scale - reg_scale / 2.0) * step
            reg_h = (torch.sigmoid(v["h_logits"][..., 0]) * reg_scale - reg_scale / 2.0) * step
            pw = _clip(reg_w[:, None, :] + centers[idx_w], vmin, vmax) * v["anc"][..., 0][:, None, :]
            ph = _clip(reg_h[:, None, :] + centers[idx_h], vmin, vmax) * v["anc"][..., 1][:, None, :]
            # SigmoidBin's BCE over the selected pairs, w and h each a mean over
            # (selected, bin_count) elements
            for logits, tgt_idx in ((v["w_logits"], idx_w), (v["h_logits"], idx_h)):
                tgt_bins = torch.nn.functional.one_hot(tgt_idx, bin_count).to(dt)
                bce = bce_logits(logits[:, None, :, 1:].expand(tgt_bins.shape), tgt_bins)
                total_box = total_box + (bce * sl[..., None]).sum() / (n_den * bin_count)
            pbox = torch.cat([xy_grid[:, None].expand(sl.shape + (2,)),
                              torch.stack([pw, ph], dim=-1)], dim=-1)
        else:
            wh = (torch.sigmoid(v["ps"][..., 2:4]) * 2.0) ** 2 * v["anc"]
            pbox = torch.cat([xy_grid, wh], dim=-1)[:, None].expand(sl.shape + (4,))
        tbox = torch.cat([t_xy, t_wh], dim=-1)[:, :, None].expand(sl.shape + (4,))
        ciou = bbox_ciou(pbox, tbox)                                # (B, T, C)
        total_box = total_box + ((1.0 - ciou) * sl).sum() / n_den

        # objectness: a cell's target the clamped CIoU of its pair, two
        # selected columns on one cell resolved by the reference's last write
        # (its emit order: offset group, anchor, source target)
        c_idx = torch.arange(C, device=dev)
        t_src, off_i, a_i = c_idx // (5 * na), (c_idx % (5 * na)) // na, c_idx % na
        pri = (off_i * (na * T) + a_i * T + t_src + 1)[None, None, :].expand(sl.shape)
        cell_i = v["cell"].to(torch.int64)
        cid = (torch.arange(B, device=dev)[:, None, None] * (na * Hl * Wl)
               + a_i[None, None, :] * (Hl * Wl)
               + cell_i[..., 1][:, None, :] * Wl + cell_i[..., 0][:, None, :]).expand(sl.shape)
        obj_target = _last_write_obj_target(_clip_min0(ciou.detach()), sl > 0, pri, cid,
                                            B * na * Hl * Wl).reshape(B, na, Hl, Wl)
        total_obj = total_obj + bce_logits(d["m"][..., v["obj_idx"]], obj_target).mean() \
            * balance[d["lvl"]]

        if nc > 1:
            tgt = onehot[:, :, None, :].expand(sl.shape + (nc,))
            lg = v["cls_logits"][:, None].expand(tgt.shape)
            total_cls = total_cls + (bce_logits(lg, tgt) * sl[..., None]).sum() / (n_den * nc)
        off += C
    return total_box, total_obj, total_cls
