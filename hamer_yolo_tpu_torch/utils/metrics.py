"""Evaluation metrics (port of hamer_yolo_tpu/utils/metrics.py), numpy on
the host.

Pose (the reference's hamer/hamer/utils/pose_utils.py): Procrustes
alignment, PA-MPJPE, MPJPE, MPVPE, PCK and the streaming ``Evaluator``.
Detection (the reference's yolo/yolov7/utils/metrics.py and test.py):
``box_iou_np``, the 101-point ``compute_ap``, ``ap_per_class``, the greedy
``match_predictions`` and ``ConfusionMatrix``.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np

_trapezoid = getattr(np, "trapezoid", None) or np.trapz  # numpy 2 renamed it


# ---------------------------------------------------------------------------
# Pose metrics
# ---------------------------------------------------------------------------

def compute_similarity_transform(S1: np.ndarray, S2: np.ndarray) -> np.ndarray:
    """Procrustes: similarity transform (R, t, s) aligning S1 to S2.

    S1, S2: (N, 3). Returns S1 aligned (N, 3).
    """
    S1 = S1.T  # (3, N)
    S2 = S2.T
    mu1 = S1.mean(axis=1, keepdims=True)
    mu2 = S2.mean(axis=1, keepdims=True)
    X1 = S1 - mu1
    X2 = S2 - mu2
    var1 = np.sum(X1 ** 2)
    K = X1 @ X2.T
    U, s, Vh = np.linalg.svd(K)
    V = Vh.T
    Z = np.eye(3)
    Z[-1, -1] = np.sign(np.linalg.det(U @ V.T))
    R = V @ Z @ U.T
    scale = np.trace(R @ K) / var1
    t = mu2 - scale * (R @ mu1)
    return (scale * (R @ S1) + t).T


def reconstruction_error(pred: np.ndarray, gt: np.ndarray) -> np.ndarray:
    """PA-MPJPE per sample: pred/gt (B, N, 3) -> (B,) mean joint error."""
    errs = []
    for p, g in zip(pred, gt):
        aligned = compute_similarity_transform(p, g)
        errs.append(np.sqrt(((aligned - g) ** 2).sum(axis=-1)).mean())
    return np.asarray(errs)


def mpjpe(pred: np.ndarray, gt: np.ndarray, root_idx: Optional[int] = None) -> np.ndarray:
    """(B, N, 3) -> (B,) mean per-joint position error (optionally
    root-centered)."""
    if root_idx is not None:
        pred = pred - pred[:, root_idx:root_idx + 1]
        gt = gt - gt[:, root_idx:root_idx + 1]
    return np.sqrt(((pred - gt) ** 2).sum(axis=-1)).mean(axis=-1)


def mpvpe(pred_verts: np.ndarray, gt_verts: np.ndarray) -> np.ndarray:
    """Mean per-vertex position error (the BASELINE parity metric)."""
    return np.sqrt(((pred_verts - gt_verts) ** 2).sum(axis=-1)).mean(axis=-1)


def eval_pose(pred: np.ndarray, gt: np.ndarray, scale_mm: float = 1000.0
              ) -> Tuple[float, float]:
    """(B, N, 3) in meters -> (MPJPE mm, PA-MPJPE mm)."""
    return (
        float(mpjpe(pred, gt).mean() * scale_mm),
        float(reconstruction_error(pred, gt).mean() * scale_mm),
    )


def pck(pred2d: np.ndarray, gt2d: np.ndarray, thresholds: np.ndarray,
        valid: Optional[np.ndarray] = None) -> np.ndarray:
    """Percentage of correct keypoints at pixel thresholds.

    pred2d/gt2d: (B, N, 2); thresholds: (T,); valid: (B, N) mask.
    Returns (T,) PCK values.
    """
    d = np.sqrt(((pred2d - gt2d) ** 2).sum(axis=-1))  # (B, N)
    if valid is None:
        valid = np.ones_like(d, bool)
    out = []
    for t in thresholds:
        out.append(((d < t) & valid).sum() / max(valid.sum(), 1))
    return np.asarray(out)


class Evaluator:
    """Streaming accumulation of MPJPE / PA-MPJPE / MPVPE over batches."""

    def __init__(self):
        self.mpjpe_all: List[np.ndarray] = []
        self.re_all: List[np.ndarray] = []
        self.mpvpe_all: List[np.ndarray] = []

    def update(self, pred_joints: np.ndarray, gt_joints: np.ndarray,
               pred_verts: Optional[np.ndarray] = None,
               gt_verts: Optional[np.ndarray] = None) -> None:
        self.mpjpe_all.append(mpjpe(pred_joints, gt_joints, root_idx=0))
        self.re_all.append(reconstruction_error(pred_joints, gt_joints))
        if pred_verts is not None and gt_verts is not None:
            self.mpvpe_all.append(mpvpe(pred_verts, gt_verts))

    def results(self, scale_mm: float = 1000.0) -> Dict[str, float]:
        out = {
            "mpjpe_mm": float(np.concatenate(self.mpjpe_all).mean() * scale_mm),
            "pa_mpjpe_mm": float(np.concatenate(self.re_all).mean() * scale_mm),
        }
        if self.mpvpe_all:
            out["mpvpe_mm"] = float(np.concatenate(self.mpvpe_all).mean() * scale_mm)
        return out


# ---------------------------------------------------------------------------
# Detection metrics (COCO-style)
# ---------------------------------------------------------------------------

def box_iou_np(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    lt = np.maximum(a[:, None, :2], b[None, :, :2])
    rb = np.minimum(a[:, None, 2:], b[None, :, 2:])
    wh = np.clip(rb - lt, 0, None)
    inter = wh[..., 0] * wh[..., 1]
    area_a = (a[:, 2] - a[:, 0]) * (a[:, 3] - a[:, 1])
    area_b = (b[:, 2] - b[:, 0]) * (b[:, 3] - b[:, 1])
    return inter / np.maximum(area_a[:, None] + area_b[None, :] - inter, 1e-12)


def compute_ap(recall: np.ndarray, precision: np.ndarray) -> float:
    """101-point interpolated AP (reference metrics.py compute_ap)."""
    mrec = np.concatenate(([0.0], recall, [recall[-1] + 0.01]))
    mpre = np.concatenate(([1.0], precision, [0.0]))
    mpre = np.flip(np.maximum.accumulate(np.flip(mpre)))
    x = np.linspace(0, 1, 101)
    return float(_trapezoid(np.interp(x, mrec, mpre), x))


def ap_per_class(
    tp: np.ndarray, conf: np.ndarray, pred_cls: np.ndarray, target_cls: np.ndarray
) -> Dict[str, np.ndarray]:
    """tp: (N, T) bool at IoU thresholds; returns per-class P/R/AP arrays."""
    order = np.argsort(-conf)
    tp, conf, pred_cls = tp[order], conf[order], pred_cls[order]
    classes = np.unique(target_cls)
    T = tp.shape[1]
    ap = np.zeros((len(classes), T))
    p = np.zeros(len(classes))
    r = np.zeros(len(classes))
    for ci, c in enumerate(classes):
        mask = pred_cls == c
        n_gt = (target_cls == c).sum()
        if not mask.any() or n_gt == 0:
            continue
        fpc = (1 - tp[mask]).cumsum(axis=0)
        tpc = tp[mask].cumsum(axis=0)
        recall = tpc / (n_gt + 1e-16)
        precision = tpc / (tpc + fpc)
        for t in range(T):
            ap[ci, t] = compute_ap(recall[:, t], precision[:, t])
        p[ci] = precision[-1, 0]
        r[ci] = recall[-1, 0]
    return {"classes": classes, "ap": ap, "precision": p, "recall": r,
            "map50": float(ap[:, 0].mean()) if len(classes) else 0.0,
            "map": float(ap.mean()) if len(classes) else 0.0}


def match_predictions(
    pred_boxes: np.ndarray, pred_cls: np.ndarray,
    gt_boxes: np.ndarray, gt_cls: np.ndarray,
    iou_thresholds: np.ndarray,
) -> np.ndarray:
    """Greedy IoU matching -> tp matrix (N_pred, T) (reference test.py)."""
    T = len(iou_thresholds)
    tp = np.zeros((len(pred_boxes), T), bool)
    if len(gt_boxes) == 0 or len(pred_boxes) == 0:
        return tp
    iou = box_iou_np(pred_boxes, gt_boxes)
    correct_cls = pred_cls[:, None] == gt_cls[None, :]
    for t, thr in enumerate(iou_thresholds):
        cand = (iou >= thr) & correct_cls
        used = np.zeros(len(gt_boxes), bool)
        for i in range(len(pred_boxes)):
            js = np.where(cand[i] & ~used)[0]
            if len(js):
                j = js[np.argmax(iou[i, js])]
                tp[i, t] = True
                used[j] = True
    return tp


class ConfusionMatrix:
    """Detection confusion matrix (reference metrics.py ConfusionMatrix)."""

    def __init__(self, nc: int, conf: float = 0.25, iou_thres: float = 0.45):
        self.matrix = np.zeros((nc + 1, nc + 1))
        self.nc = nc
        self.conf = conf
        self.iou_thres = iou_thres

    def process_batch(self, detections: np.ndarray, labels: np.ndarray) -> None:
        """detections (N, 6) [x1 y1 x2 y2 conf cls]; labels (M, 5) [cls x1 y1 x2 y2]."""
        detections = detections[detections[:, 4] > self.conf]
        gt_classes = labels[:, 0].astype(int)
        det_classes = detections[:, 5].astype(int)
        iou = box_iou_np(labels[:, 1:], detections[:, :4])
        matched = iou > self.iou_thres
        gi, di = np.where(matched)
        if len(gi):
            order = np.argsort(-iou[gi, di])
            seen_g, seen_d = set(), set()
            for idx in order:
                g, d = gi[idx], di[idx]
                if g in seen_g or d in seen_d:
                    continue
                seen_g.add(g)
                seen_d.add(d)
                self.matrix[det_classes[d], gt_classes[g]] += 1
        for g in range(len(gt_classes)):
            if not matched[g].any():
                self.matrix[self.nc, gt_classes[g]] += 1  # missed
        for d in range(len(det_classes)):
            if not matched[:, d].any():
                self.matrix[det_classes[d], self.nc] += 1  # false positive
