"""Batched class-aware NMS with fixed-capacity outputs, and kernel K1.

Port of hamer_yolo_tpu/ops/nms.py (``non_max_suppression`` with its
Merge-NMS option, and ``non_max_suppression_kpt``) and of the TPU kernel
hamer_yolo_tpu/ops/nms_pallas.py:greedy_nms_keep, whose CUDA counterpart is
``csrc/nms.cu``. Steps: score = obj * cls, best class, class whitelist and
conf threshold as masks, static top-K (K = min(max_nms_static, N)) by a
stable descending sort (lower index first on ties, as ``jax.lax.top_k``),
class-offset boxes, greedy keep mask, then the kept boxes compacted to the
front and capped at ``max_det``. Merge-NMS and the keypoint NMS run the same
keep mask, K1 on the card.
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple, Optional, Tuple

import torch

from hamer_yolo_tpu_torch.geometry.boxes import box_iou, xywh2xyxy
from hamer_yolo_tpu_torch.ops import cuda_build, torch_ops

MAX_WH = 4096.0  # class-offset multiplier
MAX_K = 2048     # csrc/nms.cu: at most 16 CTAs of an image's cluster, 2 mask words a lane


class NmsOutput(NamedTuple):
    boxes: torch.Tensor    # (B, max_det, 4) xyxy in input-pixel space
    scores: torch.Tensor   # (B, max_det)
    classes: torch.Tensor  # (B, max_det) int32
    valid: torch.Tensor    # (B, max_det) bool


def greedy_nms_keep_ref(boxes: torch.Tensor, active: torch.Tensor,
                        iou_thres: float) -> torch.Tensor:
    """Plain version of K1: the f32 greedy scan of the JAX ``_greedy_suppress``.

    boxes (B, K, 4) score-sorted xyxy; active (B, K) {0, 1}. Returns the
    keep mask (B, K) f32. Candidate i, if still alive and active, kills every
    j with iou(i, j) > thres (diagonal excluded).
    """
    B, K, _ = boxes.shape
    sup = box_iou(boxes, boxes) > iou_thres
    sup &= ~torch.eye(K, dtype=torch.bool, device=boxes.device)
    act = active > 0.5
    alive = torch.ones((B, K), dtype=torch.bool, device=boxes.device)
    for i in range(K):
        keep_i = alive[:, i] & act[:, i]
        alive &= ~(keep_i[:, None] & sup[:, i])
    return (alive & act).to(torch.float32)


def greedy_nms_keep(boxes: torch.Tensor, active: torch.Tensor,
                    iou_thres: float) -> torch.Tensor:
    """K1: keep mask (B, K) f32 of score-sorted candidates, active (B, K) f32.

    CPU tensors take the plain version; CUDA tensors make one launch of
    ``csrc/nms.cu`` (a cluster of CTAs per image), f32 active, K up to
    ``MAX_K``, and raise on anything the kernel does not take.
    """
    cuda_build.refuse_grad("greedy_nms_keep", boxes, active)
    if boxes.device.type == "cpu":
        return greedy_nms_keep_ref(boxes, active, iou_thres)
    return _launch_keep(boxes, active, iou_thres, torch.float32)


def greedy_nms_keep_mask(boxes: torch.Tensor, active: torch.Tensor,
                         iou_thres: float) -> torch.Tensor:
    """K1 on bool masks, non_max_suppression's entry: active (B, K) bool ->
    keep (B, K) bool, with no cast around the launch. Counted in
    ``greedy_nms_keep.launches``. Traced (torch.export), it is the operator
    ``hyt_port::greedy_nms_keep_mask`` (ops/torch_ops.py), on any device."""
    cuda_build.refuse_grad("greedy_nms_keep", boxes, active)
    if torch.compiler.is_compiling():
        return torch_ops.greedy_nms_keep_mask(boxes, active, iou_thres)
    if boxes.device.type == "cpu":
        return greedy_nms_keep_ref(boxes, active, iou_thres) > 0.5
    return _launch_keep(boxes, active, iou_thres, torch.bool)


def _launch_keep(boxes: torch.Tensor, active: torch.Tensor, iou_thres: float,
                 dtype: torch.dtype) -> torch.Tensor:
    what = "greedy_nms_keep"
    dev = boxes.device
    if dev.type != "cuda":
        raise ValueError(f"{what}: unsupported device {dev}")
    if active.device != dev:
        raise ValueError(f"{what}: active on {active.device}, boxes on {dev}")
    if (boxes.dim() != 3 or boxes.shape[-1] != 4 or boxes.dtype != torch.float32
            or active.shape != boxes.shape[:2] or active.dtype != dtype):
        raise ValueError(f"{what}: boxes {tuple(boxes.shape)} {boxes.dtype}, active "
                         f"{tuple(active.shape)} {active.dtype}; the kernel takes f32 boxes "
                         f"(B, K, 4) and {dtype} active (B, K)")
    B, K, _ = boxes.shape
    if not 0 < K <= MAX_K:
        raise ValueError(f"{what}: K={K} outside 1..{MAX_K}, the kernel's limit")
    boxes, active = boxes.contiguous(), active.contiguous()
    keep = torch.empty((B, K), dtype=dtype, device=dev)
    lib = cuda_build.load("nms.cu")
    idx = boxes.get_device()
    with torch.cuda.device(idx):  # an index: less host work than a device
        stream = torch.cuda.current_stream(idx).cuda_stream
        rc = lib.hyt_nms_keep(boxes.data_ptr(), active.data_ptr(), ctypes.c_float(iou_thres),
                              keep.data_ptr(), B, K, dtype == torch.bool, stream)
    cuda_build.check(rc, "nms_keep_kernel")
    greedy_nms_keep.launches += 1
    return keep


greedy_nms_keep.launches = 0


def _topk_stable(x: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Top-k along the last dim, lower index first on ties (jax.lax.top_k)."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


class NmsCandidates(NamedTuple):
    scores: torch.Tensor   # (B, K) score-sorted, 0 where filtered out
    boxes: torch.Tensor    # (B, K, 4) xyxy
    classes: torch.Tensor  # (B, K) int32
    active: torch.Tensor   # (B, K) bool
    shifted: torch.Tensor  # (B, K, 4) class-offset boxes, the input of K1
    index: torch.Tensor    # (B, K) each candidate's row in the prediction


def nms_candidates(prediction: torch.Tensor, conf_thres: float = 0.25,
                   classes: Optional[Tuple[int, ...]] = None, agnostic: bool = False,
                   max_nms_static: int = 512) -> NmsCandidates:
    """The static top-K candidate set of ``non_max_suppression``."""
    B, N, no = prediction.shape
    nc = no - 5
    xywh, obj, cls_scores = prediction[..., :4], prediction[..., 4], prediction[..., 5:]
    if nc == 1:
        score = obj
        cls_id = torch.zeros((B, N), dtype=torch.int32, device=prediction.device)
    else:
        conf = cls_scores * obj[..., None]
        score = torch.amax(conf, dim=-1)
        cls_id = torch.argmax(conf, dim=-1).to(torch.int32)

    keep_mask = (obj > conf_thres) & (score > conf_thres)
    if classes is not None:
        cls_ok = torch.zeros((B, N), dtype=torch.bool, device=prediction.device)
        for c in classes:
            cls_ok |= cls_id == c
        keep_mask &= cls_ok
    score = torch.where(keep_mask, score, torch.zeros_like(score))
    boxes = xywh2xyxy(xywh)

    K = min(max_nms_static, N)
    top_scores, top_idx = _topk_stable(score, K)
    top_boxes = torch.gather(boxes, 1, top_idx[..., None].expand(B, K, 4))
    top_cls = torch.gather(cls_id, 1, top_idx)
    offset = 0.0 if agnostic else MAX_WH
    shifted = top_boxes + top_cls[..., None].to(top_boxes.dtype) * offset
    return NmsCandidates(top_scores, top_boxes, top_cls, top_scores > conf_thres, shifted,
                         top_idx)


def _merge(keep: torch.Tensor, cand: NmsCandidates, iou_thres: float, redundant: bool
           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Merge-NMS: each kept box becomes the score-weighted mean of every
    active candidate whose IoU with it (class-offset boxes) is above the
    threshold, itself included; under ``redundant`` a kept box that no second
    candidate overlaps is dropped. -> (boxes (B, K, 4), keep (B, K))."""
    ov = (box_iou(cand.shifted, cand.shifted) > iou_thres) & cand.active[:, None, :]
    w = ov.to(cand.boxes.dtype) * cand.scores[:, None, :]  # (B, K, K)
    denom = torch.clamp(torch.sum(w, dim=2, keepdim=True), min=1e-12)
    merged = (w @ cand.boxes) / denom
    boxes = torch.where(keep[..., None], merged, cand.boxes)
    if redundant:
        keep = keep & (torch.sum(ov, dim=2) > 1)
    return boxes, keep


def _nms_core(prediction: torch.Tensor, conf_thres: float, iou_thres: float,
              classes: Optional[Tuple[int, ...]], agnostic: bool, max_det: int,
              max_nms_static: int, merge: bool, redundant: bool
              ) -> Tuple[NmsOutput, torch.Tensor]:
    """``non_max_suppression`` and the kept candidates' rows in the
    prediction (B, max_det), for side payloads such as keypoints."""
    cand = nms_candidates(prediction, conf_thres, classes, agnostic, max_nms_static)
    B, K = cand.scores.shape
    keep = greedy_nms_keep_mask(cand.shifted, cand.active, iou_thres)
    boxes = cand.boxes
    if merge:
        boxes, keep = _merge(keep, cand, iou_thres, redundant)

    keep_score = torch.where(keep, cand.scores, torch.full_like(cand.scores, -1.0))
    m = min(max_det, K)
    out_scores, order = _topk_stable(keep_score, m)
    out_boxes = torch.gather(boxes, 1, order[..., None].expand(B, m, 4))
    out_cls = torch.gather(cand.classes, 1, order)
    out_idx = torch.gather(cand.index, 1, order)
    if m < max_det:
        pad = max_det - m
        out_scores = torch.nn.functional.pad(out_scores, (0, pad), value=-1.0)
        out_boxes = torch.nn.functional.pad(out_boxes, (0, 0, 0, pad))
        out_cls = torch.nn.functional.pad(out_cls, (0, pad))
        out_idx = torch.nn.functional.pad(out_idx, (0, pad))
    return NmsOutput(boxes=out_boxes, scores=torch.clamp(out_scores, min=0.0),
                     classes=out_cls, valid=out_scores > 0.0), out_idx


def non_max_suppression(prediction: torch.Tensor, conf_thres: float = 0.25,
                        iou_thres: float = 0.45, classes: Optional[Tuple[int, ...]] = None,
                        agnostic: bool = False, max_det: int = 300,
                        max_nms_static: int = 512, merge: bool = False,
                        redundant: bool = True) -> NmsOutput:
    """prediction: (B, N, 5 + nc) decoded xywh + obj + class scores.
    ``merge`` is the reference's Merge-NMS (``_merge``); the candidate set
    is the static top-K, so the (K, K) overlap matrix needs no size guard."""
    return _nms_core(prediction, conf_thres, iou_thres, classes, agnostic, max_det,
                     max_nms_static, merge, redundant)[0]


class NmsKptOutput(NamedTuple):
    boxes: torch.Tensor    # (B, max_det, 4) xyxy
    scores: torch.Tensor   # (B, max_det)
    classes: torch.Tensor  # (B, max_det) int32
    kpts: torch.Tensor     # (B, max_det, 3 nkpt) x, y, conf per keypoint
    valid: torch.Tensor    # (B, max_det) bool


def non_max_suppression_kpt(prediction: torch.Tensor, conf_thres: float = 0.25,
                            iou_thres: float = 0.45, nc: int = 1,
                            classes: Optional[Tuple[int, ...]] = None, agnostic: bool = False,
                            max_det: int = 300, max_nms_static: int = 512) -> NmsKptOutput:
    """The keypoint NMS: prediction (B, N, 5 + nc + 3 nkpt) from the
    IKeypoint decode; each kept box carries its 3 nkpt columns (0 on padded
    rows). The same suppression as ``non_max_suppression`` (no merge); one
    class scores by obj * cls, as the reference's keypoint path does."""
    det, kpts = prediction[..., :5 + nc], prediction[..., 5 + nc:]
    if nc == 1:
        det = torch.cat([det[..., :4], (det[..., 4] * det[..., 5])[..., None], det[..., 5:6]],
                        dim=-1)
    out, idx = _nms_core(det, conf_thres, iou_thres, classes, agnostic, max_det,
                         max_nms_static, False, True)
    out_kpts = torch.gather(kpts, 1, idx[..., None].expand(*idx.shape, kpts.shape[-1]))
    out_kpts = torch.where(out.valid[..., None], out_kpts, torch.zeros_like(out_kpts))
    return NmsKptOutput(boxes=out.boxes, scores=out.scores, classes=out.classes, kpts=out_kpts,
                        valid=out.valid)
