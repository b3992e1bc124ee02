"""Anchor tuning (port of hamer_yolo_tpu/utils/autoanchor.py; the
reference's yolo/yolov7/utils/autoanchor.py), numpy on the host: the best
possible recall of the anchors over the labels' box sizes and, below a
threshold, new anchors by k-means under the ratio metric and a mutation
search, from an explicit seed.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np


def anchor_metric(wh: np.ndarray, anchors: np.ndarray, thr: float = 4.0
                  ) -> Tuple[float, float]:
    """(bpr, aat): best-possible recall and anchors-above-threshold.

    wh: (N, 2) label sizes (pixels at train scale); anchors: (M, 2).
    """
    r = wh[:, None] / anchors[None]  # (N, M, 2)
    x = np.minimum(r, 1.0 / r).min(axis=2)  # (N, M) worst-side ratio
    best = x.max(axis=1)
    bpr = float((best > 1.0 / thr).mean())
    aat = float((x > 1.0 / thr).sum(axis=1).mean())
    return bpr, aat


def kmeans_anchors(wh: np.ndarray, n: int = 9, iters: int = 30,
                   generations: int = 300, seed: int = 0) -> np.ndarray:
    """k-means (ratio-metric) + genetic mutation; returns (n, 2) sorted by area."""
    rng = np.random.default_rng(seed)
    wh = wh[(wh > 2.0).all(axis=1)]  # filter tiny labels (reference does)

    # init: k-means++ style on log-wh
    centers = wh[rng.choice(len(wh), n, replace=False)].astype(np.float64)

    def fitness(anc):
        r = wh[:, None] / anc[None]
        x = np.minimum(r, 1.0 / r).min(axis=2)
        best = x.max(axis=1)
        return (best * (best > 0.25)).mean()

    for _ in range(iters):
        r = wh[:, None] / centers[None]
        x = np.minimum(r, 1.0 / r).min(axis=2)
        assign = x.argmax(axis=1)
        for k in range(n):
            members = wh[assign == k]
            if len(members):
                centers[k] = members.mean(axis=0)

    # genetic refinement (kmean_anchors' evolve loop)
    best_f = fitness(centers)
    best = centers.copy()
    for _ in range(generations):
        mut = best * (1 + rng.normal(0, 0.1, best.shape).clip(-0.3, 0.3))
        f = fitness(mut)
        if f > best_f:
            best_f, best = f, mut
    return best[np.argsort(best.prod(axis=1))].astype(np.float32)


def check_anchors(wh: np.ndarray, anchors: np.ndarray, thr: float = 4.0,
                  bpr_threshold: float = 0.98) -> Tuple[np.ndarray, bool]:
    """Return (possibly re-derived anchors, changed flag)."""
    bpr, _ = anchor_metric(wh, anchors.reshape(-1, 2), thr)
    if bpr >= bpr_threshold:
        return anchors, False
    new = kmeans_anchors(wh, n=anchors.reshape(-1, 2).shape[0])
    new_bpr, _ = anchor_metric(wh, new, thr)
    if new_bpr > bpr:
        return new.reshape(anchors.shape), True
    return anchors, False
