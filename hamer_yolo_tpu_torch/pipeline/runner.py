"""Host-side runner: frames -> per-frame npy + OBJ outputs (port of
hamer_yolo_tpu/pipeline/runner.py).

Two steps: ``read_images`` reads an image dir on the host (cv2, imported
lazily), and ``process_frames`` (one frame a call), ``process_frames_batched``
(chunks of frames through serving.BatchedPipeline) and
``process_masked_frames`` (boxes from per-image masks, the detector
bypassed) take numpy frames and need no cv2, so a machine without it can
drive every path. Frames are padded to a bucket shape and uploaded as uint8
where they are uint8; the cast to f32 happens on the device (exact for
0..255, 4x fewer bytes over the bus). On the card each program runs as a
captured CUDA graph per bucket (pipeline/captured.py), as JAX jits one per
bucket.

Unlike the JAX runner, an inference error in the one-frame and the masked
paths is not turned into a skipped frame: a device fault stops the run where
it happened. The batched path keeps JAX's behaviour: a chunk that raises is
skipped whole and counted in ``RunStats.skipped``.
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
from hamer_yolo_tpu_torch.pipeline.captured import CapturedProgram
from hamer_yolo_tpu_torch.pipeline.frame import PipelineConfig, infer_frame, infer_frame_with_boxes
from hamer_yolo_tpu_torch.pipeline.reconstruct import reconstruct_and_save_obj
from hamer_yolo_tpu_torch.pipeline.sar_mesh import bbox_from_mask

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


def _bucket_pad(image_bgr: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """One frame padded to its bucket (uint8 frames stay uint8; the cast to
    f32 is made on the device) and its (h, w)."""
    h, w = image_bgr.shape[:2]
    bh, bw = pick_bucket(h, w)
    padded = np.zeros((bh, bw, 3), np.uint8 if image_bgr.dtype == np.uint8 else np.float32)
    padded[:h, :w] = image_bgr
    return padded, np.float32([h, w])


class FrameProgram:
    """One frame through the pipeline on ``device`` (the card unless the
    caller names another), numpy in, numpy out: a captured CUDA graph per
    bucket and upload dtype on the card (pipeline/captured.py)."""

    def __init__(self, params: nn.Params, mano_model: ManoModel, cfg: PipelineConfig,
                 device="cuda"):
        self.params = params
        self.mano_model = mano_model
        self.cfg = cfg
        self.device = torch.device(device)
        self.program = CapturedProgram(type(self).__name__, self._fn, self.device)

    def _fn(self, image, hw, K):
        return infer_frame(self.params, self.mano_model, image.to(torch.float32), hw, K,
                           self.cfg)

    def __call__(self, image_bgr: np.ndarray, K: np.ndarray) -> Dict[str, np.ndarray]:
        padded, hw = _bucket_pad(image_bgr)
        out = self.program(padded, hw, np.asarray(K, np.float32))
        return {k: v.cpu().numpy() for k, v in out.items()}


class MaskedProgram(FrameProgram):
    """One frame with its hand boxes given (``infer_frame_with_boxes``)."""

    def _fn(self, image, boxes, is_right, valid, hw, K):
        return infer_frame_with_boxes(self.params, self.mano_model, image.to(torch.float32),
                                      boxes, is_right, valid, hw, K, self.cfg)

    def __call__(self, image_bgr: np.ndarray, boxes: np.ndarray, is_right: np.ndarray,
                 valid: np.ndarray, K: np.ndarray) -> Dict[str, np.ndarray]:
        padded, hw = _bucket_pad(image_bgr)
        f32 = (lambda a: np.asarray(a, np.float32))  # noqa: E731
        out = self.program(padded, f32(boxes), f32(is_right), f32(valid), hw, f32(K))
        return {k: v.cpu().numpy() for k, v in out.items()}


@dataclass
class RunStats:
    frames: int = 0
    hands: int = 0
    skipped: int = 0
    total_s: float = 0.0


def read_images(input_dir: str) -> Iterator[Tuple[str, Optional[np.ndarray]]]:
    """(file name, BGR uint8 image or None if unreadable) for every image of a dir."""
    import cv2

    for path in list_images(input_dir):
        yield os.path.basename(path), cv2.imread(path)


def _stems(images: Iterator[Tuple[str, Optional[np.ndarray]]]):
    """read_images' pairs named by the file name without its extension."""
    return ((os.path.splitext(name)[0], image) for name, image in images)


class _Writer:
    """Writes <name>.npy and obj/<name>.obj (when a hand is found) under
    ``output_dir`` and counts frames and hands in ``stats``."""

    def __init__(self, output_dir: str, mano_model: ManoModel, save_obj: bool, progress: bool):
        os.makedirs(output_dir, exist_ok=True)
        self.obj_dir = os.path.join(output_dir, "obj")
        if save_obj:
            os.makedirs(self.obj_dir, exist_ok=True)
        self.output_dir, self.mano_model = output_dir, mano_model
        self.save_obj, self.progress = save_obj, progress
        self.stats = RunStats()
        self.t0 = time.time()

    def __call__(self, name: str, out: Dict[str, np.ndarray]) -> int:
        results = frame_outputs_to_hand_dicts(out)
        save_hand_npy(os.path.join(self.output_dir, f"{name}.npy"), results)
        n_hands = sum(1 for v in results.values() if v is not None)
        self.stats.hands += n_hands
        if self.save_obj and n_hands:
            reconstruct_and_save_obj(self.mano_model, results,
                                     os.path.join(self.obj_dir, f"{name}.obj"))
        self.stats.frames += 1
        if self.progress:
            print(f"[{self.stats.frames}] {name}: {n_hands} hand(s)")
        return n_hands

    def done(self) -> RunStats:
        self.stats.total_s = time.time() - self.t0
        return self.stats


def process_frames(frames: Iterable[Tuple[str, Optional[np.ndarray]]], output_dir: str,
                   program: FrameProgram, K: Optional[np.ndarray] = None,
                   save_obj: bool = True, progress: bool = True) -> RunStats:
    """Run ``program`` over (name, frame) pairs, writing <name>.npy and
    obj/<name>.obj (when a hand is found) under ``output_dir``."""
    write = _Writer(output_dir, program.mano_model, save_obj, progress)
    for name, image in frames:
        if image is None:
            write.stats.skipped += 1
            continue
        write(name, program(image, K if K is not None else default_intrinsics(image.shape)))
    return write.done()


def process_frames_batched(frames: Iterable[Tuple[str, Optional[np.ndarray]]],
                           output_dir: str, pipe, K: Optional[np.ndarray] = None,
                           save_obj: bool = True, progress: bool = True) -> RunStats:
    """``process_frames`` in chunks of ``pipe.batch_size`` frames through a
    serving.BatchedPipeline: the same per-frame files. A chunk whose batch
    raises is skipped whole (JAX's runner does the same) and its frames
    counted in ``skipped``."""
    write = _Writer(output_dir, pipe.mano_model, save_obj, progress)
    chunk: list = []

    def flush():
        if not chunk:
            return
        names, images, Ks = zip(*chunk)
        try:
            out = pipe.process_batch(list(images), np.stack(Ks))
            for i, name in enumerate(names):
                write(name, {k: v[i] for k, v in out.items()})
        except Exception as e:  # the whole chunk
            write.stats.skipped += len(chunk)
            if progress:
                print(f"skip chunk [{names[0]}..{names[-1]}]: {e}")
        chunk.clear()

    for name, image in frames:
        if image is None:
            write.stats.skipped += 1
            continue
        chunk.append((name, image, K if K is not None else default_intrinsics(image.shape)))
        if len(chunk) == pipe.batch_size:
            flush()
    flush()
    return write.done()


def process_masked_frames(frames: Iterable[Tuple[str, Optional[np.ndarray], Optional[np.ndarray]]],
                          output_dir: str, program: MaskedProgram,
                          K: Optional[np.ndarray] = None, mask_value: int = 3,
                          mask_hand: str = "right", save_obj: bool = True,
                          progress: bool = True) -> RunStats:
    """The mask-driven runner over (name, frame, mask) triples: the box of
    the ``mask_value`` pixels of each mask fills slot 0 as a ``mask_hand``
    hand, the detector bypassed. A missing frame or mask, or a mask without
    that value, is skipped."""
    write = _Writer(output_dir, program.mano_model, save_obj, progress)
    S = program.cfg.max_hands
    for name, image, mask in frames:
        bbox = None if image is None or mask is None else bbox_from_mask(mask, mask_value)
        if bbox is None:
            write.stats.skipped += 1
            continue
        boxes = np.zeros((S, 4), np.float32)
        boxes[0] = bbox
        valid = np.zeros((S,), np.float32)
        valid[0] = 1.0
        is_right = np.full((S,), 1.0 if mask_hand == "right" else 0.0, np.float32)
        Ki = K if K is not None else default_intrinsics(image.shape)
        write(name, program(image, boxes, is_right, valid, Ki))
    return write.done()


def _intrinsics(path: Optional[str]) -> Optional[np.ndarray]:
    return load_intrinsics(path) if path and os.path.exists(path) else None


def process_image_dir(input_dir: str, output_dir: str, params: nn.Params,
                      mano_model: ManoModel, cfg: Optional[PipelineConfig] = None,
                      intrinsics_path: Optional[str] = None, save_obj: bool = True,
                      device="cuda", progress: bool = True, batch_size: int = 1) -> RunStats:
    """CLI-parity inference over an image dir: per-image .npy + .obj.
    ``batch_size`` > 1 runs chunks of frames through serving.BatchedPipeline
    (the same per-image outputs, one device call a chunk)."""
    cfg = cfg or PipelineConfig()
    K = _intrinsics(intrinsics_path)
    if batch_size > 1:
        from hamer_yolo_tpu_torch.pipeline.serving import BatchedPipeline

        pipe = BatchedPipeline(params, mano_model, cfg, batch_size=batch_size, device=device)
        return process_frames_batched(_stems(read_images(input_dir)), output_dir, pipe, K,
                                      save_obj, progress)
    program = FrameProgram(params, mano_model, cfg, device)
    return process_frames(_stems(read_images(input_dir)), output_dir, program, K, save_obj,
                          progress)


def process_masked_dir(input_dir: str, mask_dir: str, output_dir: str, params: nn.Params,
                       mano_model: ManoModel, cfg: Optional[PipelineConfig] = None,
                       intrinsics_path: Optional[str] = None, mask_value: int = 3,
                       mask_hand: str = "right", save_obj: bool = True, device="cuda",
                       progress: bool = True) -> RunStats:
    """The mask-driven variant over an image dir: <mask_dir>/<name>.npy per
    image (the reference's process_batch_manopara_with_mask)."""
    def frames():
        for name, image in _stems(read_images(input_dir)):
            path = os.path.join(mask_dir, f"{name}.npy")
            yield name, image, (np.load(path) if os.path.exists(path) else None)

    program = MaskedProgram(params, mano_model, cfg or PipelineConfig(), device)
    return process_masked_frames(frames(), output_dir, program, _intrinsics(intrinsics_path),
                                 mask_value, mask_hand, save_obj, progress)
