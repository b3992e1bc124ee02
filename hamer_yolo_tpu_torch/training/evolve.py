"""Genetic hyperparameter evolution (port of hamer_yolo_tpu/training/evolve.py;
the reference's yolov7 train.py --evolve, :590-700).

Each generation picks a parent among the 5 fittest earlier results by
fitness-weighted choice, multiplies every hyperparameter by a mutation
(probability 0.8, sigma 0.2, gains per key, clipped to [0.3, 3.0] of the
parent and to each key's limits), trains a fresh model under it and
appends (results, hyps) to evolve.txt, sorted by fitness 0.1 mAP@.5 +
0.9 mAP@.5:.95; the best row goes to hyp_evolved.yaml. The draws come from
an explicit numpy Generator (the reference seeds from the clock), the
history lives in the run's folder, and the result rows are the reference's
7 columns (P, R, mAP@.5, mAP@.5:.95, box, obj, cls). hyp_evolved.yaml is
written as PyYAML's ``dump(sort_keys=False)`` writes a flat mapping of
floats, without PyYAML.
"""
from __future__ import annotations

import os
from typing import Callable, Dict, Optional, Sequence, Tuple

import numpy as np

# (mutation gain 0-1, lower limit, upper limit) — train.py:621-650.
META: Dict[str, Tuple[float, float, float]] = {
    "lr0": (1, 1e-5, 1e-1),
    "lrf": (1, 0.01, 1.0),
    "momentum": (0.3, 0.6, 0.98),
    "weight_decay": (1, 0.0, 0.001),
    "warmup_epochs": (1, 0.0, 5.0),
    "warmup_momentum": (1, 0.0, 0.95),
    "warmup_bias_lr": (1, 0.0, 0.2),
    "box": (1, 0.02, 0.2),
    "cls": (1, 0.2, 4.0),
    "cls_pw": (1, 0.5, 2.0),
    "obj": (1, 0.2, 4.0),
    "obj_pw": (1, 0.5, 2.0),
    "iou_t": (0, 0.1, 0.7),
    "anchor_t": (1, 2.0, 8.0),
    "anchors": (2, 2.0, 10.0),
    "fl_gamma": (0, 0.0, 2.0),
    "hsv_h": (1, 0.0, 0.1),
    "hsv_s": (1, 0.0, 0.9),
    "hsv_v": (1, 0.0, 0.9),
    "degrees": (1, 0.0, 45.0),
    "translate": (1, 0.0, 0.9),
    "scale": (1, 0.0, 0.9),
    "shear": (1, 0.0, 10.0),
    "perspective": (0, 0.0, 0.001),
    "flipud": (1, 0.0, 1.0),
    "fliplr": (0, 0.0, 1.0),
    "mosaic": (1, 0.0, 1.0),
    "mixup": (1, 0.0, 1.0),
    "copy_paste": (1, 0.0, 1.0),
    "paste_in": (1, 0.0, 1.0),
}

# data/hyp.scratch.p5.yaml defaults (the shipped starting point).
DEFAULT_HYP: Dict[str, float] = {
    "lr0": 0.01, "lrf": 0.1, "momentum": 0.937, "weight_decay": 0.0005,
    "warmup_epochs": 3.0, "warmup_momentum": 0.8, "warmup_bias_lr": 0.1,
    "box": 0.05, "cls": 0.3, "cls_pw": 1.0, "obj": 0.7, "obj_pw": 1.0,
    "iou_t": 0.2, "anchor_t": 4.0, "anchors": 3.0, "fl_gamma": 0.0,
    "hsv_h": 0.015, "hsv_s": 0.7, "hsv_v": 0.4, "degrees": 0.0,
    "translate": 0.2, "scale": 0.9, "shear": 0.0, "perspective": 0.0,
    "flipud": 0.0, "fliplr": 0.5, "mosaic": 1.0, "mixup": 0.15,
    "copy_paste": 0.0, "paste_in": 0.15,
}

N_RESULT_COLS = 7  # (P, R, mAP@.5, mAP@.5:.95, box, obj, cls)


def yaml_float(v: float) -> str:
    """A float as PyYAML's representer writes it: repr, lower case, ".0"
    before an exponent that follows no point, .nan / .inf / -.inf."""
    if v != v:
        return ".nan"
    if v in (float("inf"), float("-inf")):
        return ".inf" if v > 0 else "-.inf"
    value = repr(float(v)).lower()
    if "." not in value and "e" in value:
        value = value.replace("e", ".0e", 1)
    return value


def yaml_floats(d: Dict[str, float]) -> str:
    """``yaml.dump(d, sort_keys=False)`` of a flat mapping of plain keys to floats."""
    return "".join(f"{k}: {yaml_float(v)}\n" for k, v in d.items())


def fitness(x: np.ndarray) -> np.ndarray:
    """utils/metrics.py fitness:12-16 on (N, >=4) result rows."""
    w = np.array([0.0, 0.0, 0.1, 0.9])
    return (np.atleast_2d(np.asarray(x, np.float64))[:, :4] * w).sum(1)


def mutate_hyp(
    hyp: Dict[str, float],
    history: np.ndarray,
    rng: np.random.Generator,
    mp: float = 0.8,
    sigma: float = 0.2,
) -> Dict[str, float]:
    """One generation's candidate (train.py:670-700).

    ``history``: (N, 7 + n_keys) rows of prior (results, hyp values), or
    empty — first generation runs the seed hyp unmutated (the reference
    behavior when evolve.txt doesn't exist yet). Keys follow META order.
    """
    keys = list(META)
    hyp = {k: float(hyp.get(k, DEFAULT_HYP[k])) for k in keys}
    if history.size:
        x = np.atleast_2d(history)
        n = min(5, len(x))
        x = x[np.argsort(-fitness(x))][:n]            # top-n by fitness
        w = fitness(x) - fitness(x).min() + 1e-12     # selection weights
        pick = rng.choice(n, p=w / w.sum())           # weighted 'single'
        parent = x[pick]
        g = np.array([META[k][0] for k in keys])
        if mp <= 0 or sigma <= 0:
            raise ValueError(
                f"mutate_hyp needs mp > 0 and sigma > 0 (got mp={mp}, "
                f"sigma={sigma}): the retry-until-changed loop below "
                "could never terminate")
        ng = len(keys)
        v = np.ones(ng)
        for _ in range(100):  # mutate until a change occurs (bounded)
            v = (g * (rng.random(ng) < mp) * rng.standard_normal(ng)
                 * rng.random() * sigma + 1).clip(0.3, 3.0)
            if not (v == 1).all():
                break
        for i, k in enumerate(keys):
            hyp[k] = float(parent[i + N_RESULT_COLS] * v[i])
    for k in keys:  # constrain to limits + significant digits
        lo, hi = META[k][1], META[k][2]
        hyp[k] = round(min(max(hyp[k], lo), hi), 5)
    return hyp


class EvolveLog:
    """evolve.txt + hyp_evolved.yaml bookkeeping (print_mutation,
    general.py:819-845): rows sorted by fitness, unique, best row
    exported as yaml with the results header."""

    def __init__(self, out_dir: str):
        self.out_dir = out_dir
        os.makedirs(out_dir, exist_ok=True)
        self.txt = os.path.join(out_dir, "evolve.txt")
        self.yaml = os.path.join(out_dir, "hyp_evolved.yaml")

    def history(self) -> np.ndarray:
        if not os.path.exists(self.txt):
            return np.zeros((0, N_RESULT_COLS + len(META)))
        return np.loadtxt(self.txt, ndmin=2)

    def record(self, hyp: Dict[str, float],
               results: Sequence[float]) -> Dict[str, float]:
        """Append one generation; rewrite sorted/unique; export best."""
        keys = list(META)
        results = list(results)[:N_RESULT_COLS]
        results += [0.0] * (N_RESULT_COLS - len(results))
        row = np.array(results + [hyp[k] for k in keys], np.float64)
        x = np.vstack([self.history(), row]) if os.path.exists(self.txt) \
            else row[None]
        x = np.unique(x, axis=0)
        x = x[np.argsort(-fitness(x))]
        np.savetxt(self.txt, x, "%10.4g")
        best = {k: float(x[0, i + N_RESULT_COLS]) for i, k in enumerate(keys)}
        with open(self.yaml, "w") as f:
            c = "%10.4g" * N_RESULT_COLS % tuple(x[0, :N_RESULT_COLS])
            f.write(f"# Hyperparameter Evolution Results\n"
                    f"# Generations: {len(x)}\n# Metrics: {c}\n\n")
            f.write(yaml_floats(best))
        return best


def evolve(
    train_and_eval: Callable[[Dict[str, float], int], Sequence[float]],
    generations: int,
    out_dir: str,
    hyp0: Optional[Dict[str, float]] = None,
    seed: int = 0,
    log: Callable[[str], None] = print,
) -> Dict[str, float]:
    """Run the evolution loop; returns the best hyp dict.

    ``train_and_eval(hyp, generation)`` trains a fresh model under the
    candidate hyp and returns >= 4 result values
    (P, R, mAP@.5, mAP@.5:.95[, box, obj, cls]).
    """
    rng = np.random.default_rng(seed)
    elog = EvolveLog(out_dir)
    hyp = dict(DEFAULT_HYP, **(hyp0 or {}))
    best: Dict[str, float] = hyp
    for gen in range(generations):
        cand = mutate_hyp(hyp, elog.history(), rng)
        results = list(train_and_eval(cand, gen))
        best = elog.record(cand, results)
        fit = float(fitness(np.array(results)[None])[0])
        log(f"evolve gen {gen}: fitness {fit:.4f}  "
            f"P {results[0]:.3f} R {results[1]:.3f} "
            f"mAP50 {results[2]:.3f} mAP {results[3]:.3f}")
    return best
