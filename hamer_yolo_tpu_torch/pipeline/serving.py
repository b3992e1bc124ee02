"""Batched frame processing (port of hamer_yolo_tpu/pipeline/serving.py,
the single-stream form): frames are grouped into fixed-size batches, each
padded to one bucket shape and run through ``infer_frames`` in one call on
the device, so the host's per-call work is shared by the batch.

Two departures from JAX's loop (ROADMAP.md, F2, closed for the port):
``process_batch`` raises when it is given more frames than ``batch_size``
(JAX drops the frames past it), and a float frame with values outside 0..255
raises (JAX's uint8 upload wraps them modulo 256). The tracked and the
multi-stream forms are not ported yet (ROADMAP.md, Queue 1 item 8).
"""
from __future__ import annotations

import time
from collections import deque
from dataclasses import dataclass
from typing import Dict, Iterator, List, Optional

import numpy as np
import torch

from hamer_yolo_tpu_torch.core import nn
from hamer_yolo_tpu_torch.models.mano import ManoModel
from hamer_yolo_tpu_torch.pipeline.frame import PipelineConfig, infer_frames
from hamer_yolo_tpu_torch.pipeline.runner import pick_bucket

QUEUED_BATCHES = 2  # stream: batches queued on the device before the oldest is fetched


@dataclass
class ServingStats:
    frames: int = 0
    batches: int = 0
    total_s: float = 0.0

    @property
    def fps(self) -> float:
        return self.frames / self.total_s if self.total_s else 0.0


class BatchedPipeline:
    """Fixed-batch frame processor on ``device`` (the card unless the caller
    names another)."""

    def __init__(self, params: nn.Params, mano_model: ManoModel,
                 cfg: Optional[PipelineConfig] = None, batch_size: int = 16, device="cuda"):
        self.params = params
        self.mano_model = mano_model
        self.cfg = cfg or PipelineConfig()
        self.batch_size = batch_size
        self.device = torch.device(device)
        self.last_stats = ServingStats()

    def _pad_frames(self, frames: List[np.ndarray], K: np.ndarray):
        """Bucket-pad a frame list to (images, hws, Ks) batch arrays.

        All-uint8 lists stay uint8 through the upload (the cast to f32 is made
        on the device, exact for 0..255, 4x fewer bytes); any float frame
        makes the batch f32. Pad rows get the bucket's shape as their size
        and the last intrinsics."""
        n = len(frames)
        if not 0 < n <= self.batch_size:
            raise ValueError(f"{n} frames for a batch of {self.batch_size}")
        for f in frames:
            if f.dtype != np.uint8 and (f.size and (np.min(f) < 0 or np.max(f) > 255)):
                raise ValueError(f"a float frame holds values outside 0..255 "
                                 f"({float(np.min(f))}..{float(np.max(f))}); frames are raw "
                                 "BGR 0..255")
        hmax = max(f.shape[0] for f in frames)
        wmax = max(f.shape[1] for f in frames)
        bh, bw = pick_bucket(hmax, wmax)
        dtype = np.uint8 if all(f.dtype == np.uint8 for f in frames) else np.float32
        images = np.zeros((self.batch_size, bh, bw, 3), dtype)
        hws = np.zeros((self.batch_size, 2), np.float32)
        for i, f in enumerate(frames):
            images[i, : f.shape[0], : f.shape[1]] = f
            hws[i] = f.shape[:2]
        hws[n:] = [bh, bw]  # harmless defaults for pad rows
        K = np.asarray(K, np.float32)
        if K.ndim == 3:  # per-frame intrinsics (n, 3, 3)
            Ks = np.broadcast_to(K[-1], (self.batch_size, 3, 3)).copy()
            Ks[: K.shape[0]] = K
        else:
            Ks = np.broadcast_to(K, (self.batch_size, 3, 3)).copy()
        return images, hws, Ks

    @torch.inference_mode()
    def _dispatch(self, frames: List[np.ndarray], K: np.ndarray):
        """Pad, upload and run one batch; returns (device outputs, n). The
        launches are queued on the card and return at once, so the host can
        prepare the next batch while the card works on this one."""
        images, hws, Ks = self._pad_frames(frames, K)
        dev = self.device
        imgs = torch.from_numpy(images).to(dev).to(torch.float32)
        out = infer_frames(self.params, self.mano_model, imgs, torch.from_numpy(hws).to(dev),
                           torch.from_numpy(Ks).to(dev), self.cfg)
        return out, len(frames)

    @staticmethod
    def _fetch(out: Dict[str, torch.Tensor], n: int) -> Dict[str, np.ndarray]:
        return {k: v[:n].cpu().numpy() for k, v in out.items()}

    def process_batch(self, frames: List[np.ndarray], K: np.ndarray) -> Dict[str, np.ndarray]:
        """frames: at most ``batch_size`` HWC BGR uint8 / float 0..255 frames;
        K: (3, 3) shared or (len(frames), 3, 3) per frame. Returns the
        stacked outputs, leading dim len(frames)."""
        return self._fetch(*self._dispatch(frames, K))

    def stream(self, frame_iter: Iterator[np.ndarray], K: np.ndarray
               ) -> Iterator[Dict[str, np.ndarray]]:
        """Consume a frame iterator in batches and yield each batch's
        outputs, with up to QUEUED_BATCHES batches queued on the device."""
        stats = ServingStats()
        buf: List[np.ndarray] = []
        pending: deque = deque()
        t0 = time.time()

        def drain_one():
            out, n = pending.popleft()
            stats.frames += n
            stats.batches += 1
            return self._fetch(out, n)

        for frame in frame_iter:
            buf.append(frame)
            if len(buf) == self.batch_size:
                pending.append(self._dispatch(buf, K))
                buf = []
                if len(pending) >= QUEUED_BATCHES:
                    yield drain_one()
        if buf:
            pending.append(self._dispatch(buf, K))
        while pending:
            yield drain_one()
        stats.total_s = time.time() - t0
        self.last_stats = stats
