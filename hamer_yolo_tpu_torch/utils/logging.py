"""Training metric logging (port of hamer_yolo_tpu/utils/logging.py): every
``log`` appends one JSON line, {"step", "time", the metrics}, to
``<log_dir>/metrics.jsonl``, the run's record. ``log_image`` writes
``<log_dir>/images/<name>_<step>.png`` through cv2, and skips the file where
cv2 is missing or fails, as JAX's does. JAX's optional TensorBoard and
Weights & Biases mirrors are not ported.
"""
from __future__ import annotations

import contextlib
import json
import os
import time
from typing import Dict, List

import numpy as np
import torch


class MetricLogger:
    def __init__(self, log_dir: str):
        os.makedirs(log_dir, exist_ok=True)
        self.path = os.path.join(log_dir, "metrics.jsonl")
        self._file = open(self.path, "a")

    def log(self, step: int, metrics: Dict[str, float]) -> None:
        rec = {"step": int(step), "time": time.time()}
        for k, v in metrics.items():
            try:
                rec[k] = float(v)
            except (TypeError, ValueError):
                rec[k] = str(v)
        self._file.write(json.dumps(rec) + "\n")
        self._file.flush()

    def log_image(self, step: int, name: str, image_bgr) -> None:
        """A prediction image (the reference's hamer.py:213-267 grids) as
        ``images/<name>_<step>.png``."""
        img_dir = os.path.join(os.path.dirname(self.path), "images")
        os.makedirs(img_dir, exist_ok=True)
        try:
            import cv2

            cv2.imwrite(os.path.join(img_dir, f"{name}_{int(step)}.png"), np.asarray(image_bgr))
        except Exception:  # no cv2, or it cannot write: the image is optional
            pass

    def close(self) -> None:
        self._file.close()

    def __enter__(self) -> "MetricLogger":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


class StepTimer:
    """A training loop's timings: the loader's host ms a batch (``load``) and
    the step's ms (``step``), by CUDA events on the card and by the host's
    clock elsewhere."""

    def __init__(self, device: torch.device):
        self.device = device
        self.load_ms: List[float] = []
        self._events: list = []
        self._host_ms: List[float] = []

    @contextlib.contextmanager
    def load(self):
        t = time.perf_counter()
        yield
        self.load_ms.append((time.perf_counter() - t) * 1e3)

    @contextlib.contextmanager
    def step(self):
        if self.device.type == "cuda":
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            yield
            end.record()
            self._events.append((start, end))
        else:
            t = time.perf_counter()
            yield
            self._host_ms.append((time.perf_counter() - t) * 1e3)

    def times(self) -> Dict[str, List[float]]:
        """{"load_ms", "step_ms"}; waits for the card's last step."""
        if self._events:
            torch.cuda.synchronize(self.device)
            step_ms = [a.elapsed_time(b) for a, b in self._events]
        else:
            step_ms = list(self._host_ms)
        return {"load_ms": list(self.load_ms), "step_ms": step_ms}


def step_summary(times: Dict[str, List[float]]) -> str:
    """A StepTimer's times as one line of medians."""
    return (f"loader {np.median(times['load_ms']):.1f} ms a batch, step "
            f"{np.median(times['step_ms']):.1f} ms (medians over {len(times['load_ms'])})")
