"""Host-side runner: frames -> per-frame npy + OBJ outputs (port of
hamer_yolo_tpu/pipeline/runner.py, single-frame mode).

Two steps: ``read_images`` reads an image dir on the host (cv2, imported
lazily), and ``process_frames`` takes (name, BGR uint8 frame) pairs and
needs no cv2, so a machine without it can drive the whole path. Frames are
padded to a bucket shape and uploaded as uint8; the cast to f32 happens on
the device (exact for 0..255, 4x fewer bytes over the bus).

Unlike the JAX runner, an inference error is not turned into a skipped
frame: a device fault stops the run where it happened.
"""
from __future__ import annotations

import os
import time
from dataclasses import dataclass
from typing import Dict, Iterable, Iterator, Optional, Tuple

import numpy as np
import torch

from hamer_yolo_tpu_torch.core import nn
from hamer_yolo_tpu_torch.io.writers import (frame_outputs_to_hand_dicts, list_images,
                                             load_intrinsics, save_hand_npy)
from hamer_yolo_tpu_torch.models.mano import ManoModel
from hamer_yolo_tpu_torch.pipeline.frame import PipelineConfig, infer_frame
from hamer_yolo_tpu_torch.pipeline.reconstruct import reconstruct_and_save_obj

# Common camera resolutions, smallest first; frames pad up to the first fit.
DEFAULT_BUCKETS: Tuple[Tuple[int, int], ...] = (
    (480, 640), (720, 1280), (1080, 1920), (1536, 2048), (2160, 3840),
)


def pick_bucket(h: int, w: int,
                buckets: Tuple[Tuple[int, int], ...] = DEFAULT_BUCKETS) -> Tuple[int, int]:
    portrait = h > w
    for bh, bw in buckets:
        if portrait:
            bh, bw = bw, bh
        if h <= bh and w <= bw:
            return bh, bw
    return int(np.ceil(h / 64) * 64), int(np.ceil(w / 64) * 64)


def default_intrinsics(shape) -> np.ndarray:
    """Reference fallback: f = 5000/256 * max(h, w), principal point at the center."""
    h, w = shape[:2]
    f = 5000.0 / 256.0 * max(h, w)
    return np.array([[f, 0, w / 2], [0, f, h / 2], [0, 0, 1]], np.float32)


class FrameProgram:
    """One frame through the pipeline on ``device`` (the card unless the
    caller names another): numpy in, numpy out."""

    def __init__(self, params: nn.Params, mano_model: ManoModel, cfg: PipelineConfig,
                 device="cuda"):
        self.params = params
        self.mano_model = mano_model
        self.cfg = cfg
        self.device = torch.device(device)

    @torch.inference_mode()
    def __call__(self, image_bgr: np.ndarray, K: np.ndarray) -> Dict[str, np.ndarray]:
        h, w = image_bgr.shape[:2]
        bh, bw = pick_bucket(h, w)
        dtype = np.uint8 if image_bgr.dtype == np.uint8 else np.float32
        padded = np.zeros((bh, bw, 3), dtype)
        padded[:h, :w] = image_bgr
        img = torch.from_numpy(padded).to(self.device).to(torch.float32)
        hw = torch.tensor([h, w], dtype=torch.float32, device=self.device)
        Kt = torch.as_tensor(np.asarray(K, np.float32), device=self.device)
        out = infer_frame(self.params, self.mano_model, img, hw, Kt, self.cfg)
        return {k: v.cpu().numpy() for k, v in out.items()}


@dataclass
class RunStats:
    frames: int = 0
    hands: int = 0
    skipped: int = 0
    total_s: float = 0.0


def read_images(input_dir: str) -> Iterator[Tuple[str, Optional[np.ndarray]]]:
    """(name, BGR uint8 image or None if unreadable) for every image of a dir."""
    import cv2

    for path in list_images(input_dir):
        yield os.path.splitext(os.path.basename(path))[0], cv2.imread(path)


def process_frames(frames: Iterable[Tuple[str, Optional[np.ndarray]]], output_dir: str,
                   program: FrameProgram, K: Optional[np.ndarray] = None,
                   save_obj: bool = True, progress: bool = True) -> RunStats:
    """Run ``program`` over (name, frame) pairs, writing <name>.npy and
    obj/<name>.obj (when a hand is found) under ``output_dir``."""
    os.makedirs(output_dir, exist_ok=True)
    obj_dir = os.path.join(output_dir, "obj")
    if save_obj:
        os.makedirs(obj_dir, exist_ok=True)
    stats = RunStats()
    t0 = time.time()
    for name, image in frames:
        if image is None:
            stats.skipped += 1
            continue
        out = program(image, K if K is not None else default_intrinsics(image.shape))
        results = frame_outputs_to_hand_dicts(out)
        save_hand_npy(os.path.join(output_dir, f"{name}.npy"), results)
        n_hands = sum(1 for v in results.values() if v is not None)
        stats.hands += n_hands
        if save_obj and n_hands:
            reconstruct_and_save_obj(program.mano_model, results,
                                     os.path.join(obj_dir, f"{name}.obj"))
        stats.frames += 1
        if progress:
            print(f"[{stats.frames}] {name}: {n_hands} hand(s)")
    stats.total_s = time.time() - t0
    return stats


def process_image_dir(input_dir: str, output_dir: str, params: nn.Params,
                      mano_model: ManoModel, cfg: Optional[PipelineConfig] = None,
                      intrinsics_path: Optional[str] = None, save_obj: bool = True,
                      device="cuda", progress: bool = True) -> RunStats:
    """CLI-parity inference over an image dir: per-image .npy + .obj."""
    K = load_intrinsics(intrinsics_path) if intrinsics_path and os.path.exists(intrinsics_path) \
        else None
    program = FrameProgram(params, mano_model, cfg or PipelineConfig(), device)
    return process_frames(read_images(input_dir), output_dir, program, K, save_obj, progress)
