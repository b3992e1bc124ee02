"""Training curves, 3D pose and point-cloud plots, batch mosaics and label
statistics (port of hamer_yolo_tpu/utils/plots.py), headless.

- ``plot_results``: a grid of training curves, one a numeric series of a
  MetricLogger JSONL (utils/logging.py).
- ``plot_3d_pose`` / ``plot_point_cloud``: a 3D hand skeleton with an
  optional point cloud, and a point cloud alone, as PNGs.
- ``plot_images`` / ``output_to_target``: a mosaic of a batch with label
  or prediction boxes, from NHWC images and the fixed-slot NMS output.
- ``plot_skeleton_kpts`` / ``output_to_keypoint``: pose keypoints and limbs
  of a keypoint head (COCO-17 person by default).
- ``plot_labels``: the class histogram and the xy and wh densities.
- ``plot_lr_scheduler``: the learning rate of a schedule callable over steps.

Host code on numpy, cv2 and matplotlib, as in the JAX package, so a figure
is the JAX package's pixel for pixel. cv2 and matplotlib are imported inside
the functions: the package imports where they are missing, and a plot
there raises ImportError. The functions that write a file return its path.
"""
from __future__ import annotations

import json
import os
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from hamer_yolo_tpu_torch.utils.viz import HAND_SKELETON


def _load_jsonl(path: str) -> List[Dict]:
    rows = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if line:
                try:
                    rows.append(json.loads(line))
                except json.JSONDecodeError:
                    continue
    return rows


def plot_results(log_dir_or_jsonl: str, out: Optional[str] = None,
                 keys: Optional[Sequence[str]] = None,
                 max_cols: int = 4) -> str:
    """Training curves from a MetricLogger JSONL -> results.png.

    ``keys`` limits which series are plotted (default: every float key
    except step/time). Equivalent of the reference's plot_results grid
    (yolov7/utils/plots.py:397)."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    path = log_dir_or_jsonl
    if os.path.isdir(path):
        path = os.path.join(path, "metrics.jsonl")
    rows = _load_jsonl(path)
    if not rows:
        raise ValueError(f"no metric rows in {path}")

    series: Dict[str, Tuple[List[float], List[float]]] = {}
    for r in rows:
        step = float(r.get("step", len(series)))
        for k, v in r.items():
            if k in ("step", "time") or not isinstance(v, (int, float)):
                continue
            if keys is not None and k not in keys:
                continue
            series.setdefault(k, ([], []))
            series[k][0].append(step)
            series[k][1].append(float(v))
    if not series:
        raise ValueError(f"no numeric series in {path}")

    names = sorted(series)
    ncols = min(max_cols, len(names))
    nrows = -(-len(names) // ncols)
    fig, axes = plt.subplots(nrows, ncols,
                             figsize=(4 * ncols, 3 * nrows), squeeze=False)
    for i, name in enumerate(names):
        ax = axes[i // ncols][i % ncols]
        xs, ys = series[name]
        ax.plot(xs, ys, linewidth=1.2)
        ax.set_title(name, fontsize=10)
        ax.set_xlabel("step", fontsize=8)
        ax.grid(True, alpha=0.3)
    for j in range(len(names), nrows * ncols):
        axes[j // ncols][j % ncols].axis("off")
    fig.tight_layout()
    out = out or os.path.join(os.path.dirname(path), "results.png")
    fig.savefig(out, dpi=120)
    plt.close(fig)
    return out


def plot_3d_pose(joints: np.ndarray, out: str,
                 skeleton: Sequence[Tuple[int, int]] = HAND_SKELETON,
                 pcl: Optional[np.ndarray] = None,
                 title: str = "hand pose") -> str:
    """3D skeleton (21, 3) [+ optional point cloud (N, 3)] -> PNG.

    The reference's vis_tool.draw_pose 3D branch: bones as colored line
    segments, joints as scatter, equal-ish axes."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    joints = np.asarray(joints, np.float64)
    fig = plt.figure(figsize=(6, 6))
    ax = fig.add_subplot(111, projection="3d")
    if pcl is not None:
        pcl = np.asarray(pcl, np.float64)
        ax.scatter(pcl[:, 0], pcl[:, 1], pcl[:, 2], s=1, c="lightgray",
                   alpha=0.5, depthshade=False)
    cmap = plt.get_cmap("tab10")
    for ei, (a, b) in enumerate(skeleton):
        seg = joints[[a, b]]
        ax.plot(seg[:, 0], seg[:, 1], seg[:, 2],
                color=cmap((ei // 4) % 10), linewidth=2)
    ax.scatter(joints[:, 0], joints[:, 1], joints[:, 2], s=14, c="black",
               depthshade=False)
    # equal aspect: cube around the data
    ref = np.concatenate([joints] + ([pcl] if pcl is not None else []))
    c = ref.mean(0)
    r = max(float(np.ptp(ref - c, axis=0).max()) / 2.0, 1e-6)
    ax.set_xlim(c[0] - r, c[0] + r)
    ax.set_ylim(c[1] - r, c[1] + r)
    ax.set_zlim(c[2] - r, c[2] + r)
    ax.set_title(title)
    fig.tight_layout()
    os.makedirs(os.path.dirname(os.path.abspath(out)), exist_ok=True)
    fig.savefig(out, dpi=120)
    plt.close(fig)
    return out


# COCO 17-keypoint person skeleton, 0-indexed (the reference hardcodes the
# 1-indexed equivalent in plot_skeleton_kpts, plots.py:497).
COCO_PERSON_SKELETON = (
    (15, 13), (13, 11), (16, 14), (14, 12), (11, 12), (5, 11), (6, 12),
    (5, 6), (5, 7), (6, 8), (7, 9), (8, 10), (1, 2), (0, 1), (0, 2),
    (1, 3), (2, 4), (3, 5), (4, 6),
)


def _xyxy2xywh_np(b: np.ndarray) -> np.ndarray:
    out = b.copy()
    out[..., 0] = (b[..., 0] + b[..., 2]) / 2
    out[..., 1] = (b[..., 1] + b[..., 3]) / 2
    out[..., 2] = b[..., 2] - b[..., 0]
    out[..., 3] = b[..., 3] - b[..., 1]
    return out


def output_to_target(boxes, scores, classes, valid) -> np.ndarray:
    """Fixed-slot NMS output -> (M, 7) [img_idx, cls, x, y, w, h, conf].

    Equivalent of plots.py:155 output_to_target over our batched
    (B, max_det, ...) arrays: only valid slots are emitted, boxes go
    xyxy -> xywh (pixel units)."""
    boxes = np.asarray(boxes, np.float64)
    scores = np.asarray(scores, np.float64)
    classes = np.asarray(classes, np.float64)
    valid = np.asarray(valid, bool)
    rows = []
    for i in range(boxes.shape[0]):
        m = valid[i]
        if not m.any():
            continue
        xywh = _xyxy2xywh_np(boxes[i][m])
        for j in range(xywh.shape[0]):
            rows.append([i, classes[i][m][j], *xywh[j], scores[i][m][j]])
    return np.asarray(rows, np.float64).reshape(-1, 7)


def output_to_keypoint(boxes, scores, classes, kpts, valid) -> np.ndarray:
    """Keypoint-NMS output -> (M, 7 + 3*nkpt) rows (plots.py:486)."""
    base = output_to_target(boxes, scores, classes, valid)
    kpts = np.asarray(kpts, np.float64)
    valid = np.asarray(valid, bool)
    if base.shape[0] == 0:
        return base.reshape(0, 7 + kpts.shape[-1])
    kept = np.concatenate([kpts[i][valid[i]] for i in range(kpts.shape[0])
                           if valid[i].any()], axis=0)
    return np.concatenate([base, kept], axis=1)


def plot_images(images: np.ndarray, targets: np.ndarray,
                paths: Optional[Sequence[str]] = None,
                fname: Optional[str] = None,
                names: Optional[Sequence[str]] = None,
                max_size: int = 640, max_subplots: int = 16) -> np.ndarray:
    """Square mosaic of a training/eval batch with boxes (plots.py:164).

    images: (B, H, W, 3) NHWC, uint8 or float in [0, 1] (RGB or BGR —
    drawn as given). targets: rows of [img_idx, cls, x, y, w, h(, conf)];
    boxes are xywh, normalized (max <= 1.01) or pixel. Label rows (no
    conf column) always draw; prediction rows draw above conf 0.25,
    matching the reference. Returns the mosaic; saves it if ``fname``.
    """
    import cv2

    from hamer_yolo_tpu_torch.utils.viz import plot_box

    images = np.asarray(images)
    if images.dtype != np.uint8:
        scale = 255.0 if float(images.max(initial=0.0)) <= 1.0 else 1.0
        images = np.clip(images * scale, 0, 255).astype(np.uint8)
    targets = np.asarray(targets, np.float64).reshape(-1, targets.shape[-1]) \
        if len(targets) else np.zeros((0, 6))

    bs = min(images.shape[0], max_subplots)
    h, w = images.shape[1:3]
    sf = min(1.0, max_size / max(h, w))
    if sf < 1.0:
        h, w = int(round(h * sf)), int(round(w * sf))
    ns = int(np.ceil(bs ** 0.5))
    mosaic = np.full((ns * h, ns * w, 3), 255, np.uint8)
    cmap = [(56, 56, 255), (151, 157, 255), (31, 112, 255), (29, 178, 255),
            (49, 210, 207), (10, 249, 72), (23, 204, 146), (134, 219, 61),
            (52, 147, 26), (187, 212, 0)]
    for i in range(bs):
        bx, by = w * (i // ns), h * (i % ns)
        img = images[i]
        if sf < 1.0:
            img = cv2.resize(img, (w, h))
        mosaic[by:by + h, bx:bx + w] = img
        rows = targets[targets[:, 0] == i] if targets.shape[0] else targets
        is_label = targets.shape[-1] == 6
        for r in rows:
            conf = None if is_label else r[6]
            if conf is not None and conf <= 0.25:
                continue
            cx, cy, bw, bh = r[2:6]
            if max(r[2:6]) <= 1.01:  # normalized
                cx, bw = cx * w, bw * w
                cy, bh = cy * h, bh * h
            else:
                cx, cy, bw, bh = (v * sf for v in (cx, cy, bw, bh))
            cls = int(r[1])
            name = names[cls] if names else str(cls)
            label = name if conf is None else f"{name} {conf:.1f}"
            box = (bx + cx - bw / 2, by + cy - bh / 2,
                   bx + cx + bw / 2, by + cy + bh / 2)
            mosaic = plot_box(mosaic, box, label, cmap[cls % len(cmap)])
        if paths:
            tag = os.path.basename(str(paths[i]))[:40]
            cv2.putText(mosaic, tag, (bx + 5, by + 18),
                        cv2.FONT_HERSHEY_SIMPLEX, 0.5, (220, 220, 220), 1,
                        cv2.LINE_AA)
        cv2.rectangle(mosaic, (bx, by), (bx + w, by + h),
                      (255, 255, 255), 3)
    if fname:
        r = min(1280.0 / max(h, w) / ns, 1.0)
        small = cv2.resize(mosaic, (int(ns * w * r), int(ns * h * r)),
                           interpolation=cv2.INTER_AREA)
        cv2.imwrite(fname, small)
    return mosaic


def plot_skeleton_kpts(im: np.ndarray, kpts: np.ndarray, steps: int = 3,
                       skeleton: Sequence[Tuple[int, int]] = COCO_PERSON_SKELETON,
                       conf_thres: float = 0.5, radius: int = 5) -> np.ndarray:
    """Draw one instance's pose keypoints + limbs on ``im`` (plots.py:497).

    kpts: flat (steps * nkpt,) — x, y[, conf] per keypoint, pixel units,
    as produced by output_to_keypoint rows [7:]. With steps == 3, points
    and limbs below ``conf_thres`` are skipped (reference threshold 0.5).
    Returns the image (drawn in place, also returned for chaining)."""
    import cv2

    kpts = np.asarray(kpts, np.float64)
    nkpt = len(kpts) // steps
    palette = [(0, 128, 255), (51, 153, 255), (255, 178, 102),
               (0, 230, 230), (255, 153, 255), (255, 204, 153),
               (255, 102, 255), (255, 51, 255), (255, 178, 102),
               (255, 153, 51), (153, 153, 255), (102, 102, 255),
               (51, 51, 255), (153, 255, 153), (102, 255, 102),
               (51, 255, 51), (0, 255, 0), (255, 0, 0), (0, 0, 255)]

    def _ok(k):
        x, y = kpts[steps * k], kpts[steps * k + 1]
        if x < 0 or y < 0 or (steps == 3 and kpts[steps * k + 2] < conf_thres):
            return False
        return True

    for k in range(nkpt):
        if _ok(k):
            cv2.circle(im, (int(kpts[steps * k]), int(kpts[steps * k + 1])),
                       radius, palette[k % len(palette)], -1)
    for si, (a, b) in enumerate(skeleton):
        if a < nkpt and b < nkpt and _ok(a) and _ok(b):
            p1 = (int(kpts[steps * a]), int(kpts[steps * a + 1]))
            p2 = (int(kpts[steps * b]), int(kpts[steps * b + 1]))
            cv2.line(im, p1, p2, palette[si % len(palette)], 2)
    return im


def plot_labels(labels: np.ndarray, out: str,
                names: Optional[Sequence[str]] = None) -> str:
    """Dataset label statistics -> PNG (plots.py:322 plot_labels).

    labels: (N, 5) rows of [cls, x, y, w, h] (normalized xywh). Panels:
    per-class instance counts, xy center density, wh density."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    labels = np.asarray(labels, np.float64).reshape(-1, 5)
    cls = labels[:, 0].astype(int)
    nc = int(cls.max()) + 1 if len(cls) else 1
    fig, axes = plt.subplots(1, 3, figsize=(12, 4))
    counts = np.bincount(cls, minlength=nc)
    axes[0].bar(range(nc), counts, color="steelblue")
    axes[0].set_title("instances / class")
    if names:
        axes[0].set_xticks(range(nc))
        axes[0].set_xticklabels([str(n) for n in names[:nc]], rotation=45,
                                fontsize=8)
    axes[1].hist2d(labels[:, 1], labels[:, 2], bins=50, range=((0, 1), (0, 1)),
                   cmap="viridis")
    axes[1].set_title("xy centers")
    axes[2].hist2d(labels[:, 3], labels[:, 4], bins=50, range=((0, 1), (0, 1)),
                   cmap="viridis")
    axes[2].set_title("wh")
    fig.tight_layout()
    os.makedirs(os.path.dirname(os.path.abspath(out)), exist_ok=True)
    fig.savefig(out, dpi=120)
    plt.close(fig)
    return out


def plot_lr_scheduler(schedule, total_steps: int, out: str) -> str:
    """LR-vs-step curve of a schedule callable, step -> learning rate."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    xs = np.arange(total_steps)
    ys = [float(schedule(int(s))) for s in xs]
    fig, ax = plt.subplots(figsize=(6, 4))
    ax.plot(xs, ys)
    ax.set_xlabel("step")
    ax.set_ylabel("LR")
    ax.grid(True, alpha=0.3)
    fig.tight_layout()
    os.makedirs(os.path.dirname(os.path.abspath(out)), exist_ok=True)
    fig.savefig(out, dpi=120)
    plt.close(fig)
    return out


def plot_point_cloud(pcl: np.ndarray, out: str,
                     color_by: Optional[np.ndarray] = None,
                     title: str = "point cloud") -> str:
    """(N, 3) scatter -> PNG (vis_tool pcl plotting equivalent);
    ``color_by`` is an (N,) scalar mapped through viridis."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    pcl = np.asarray(pcl, np.float64)
    fig = plt.figure(figsize=(6, 6))
    ax = fig.add_subplot(111, projection="3d")
    kw = {"c": color_by, "cmap": "viridis"} if color_by is not None else \
         {"c": "steelblue"}
    ax.scatter(pcl[:, 0], pcl[:, 1], pcl[:, 2], s=2, depthshade=False, **kw)
    ax.set_title(title)
    fig.tight_layout()
    os.makedirs(os.path.dirname(os.path.abspath(out)), exist_ok=True)
    fig.savefig(out, dpi=120)
    plt.close(fig)
    return out
