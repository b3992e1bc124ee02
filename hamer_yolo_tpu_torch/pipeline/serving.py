"""Batched serving (port of hamer_yolo_tpu/pipeline/serving.py, without the
data mesh): frames are grouped into fixed-size batches, each padded to one
bucket shape and run as one program, a captured CUDA graph per bucket on the
card (pipeline/captured.py), so that the host's per-batch work is one
upload, one replay and one fetch.

- ``process_batch`` and ``stream``: a video or a folder, batched over time,
  with up to ``depth`` batches queued on the device before the oldest is
  fetched;
- ``stream_multi``: N live sources, one batch a tick with a row per source
  (the reference's LoadStreams webcam loop). With ``detect_every`` = K > 1
  the detector runs on every K-th tick and on sources without a state; in
  between, each source's boxes are tracked from its previous tick's
  keypoints by the tracked program (``frame.infer_frames_tracked``).

Two departures from JAX's loop (ROADMAP.md, F2, closed for the port):
``process_batch`` raises when it is given more frames than ``batch_size``
(JAX drops the frames past it), and a float frame with values outside 0..255
raises (JAX's uint8 upload wraps them modulo 256). The data mesh (JAX's
``mesh``) is not ported (ROADMAP.md, Queue 1 item 8).
"""
from __future__ import annotations

import time
from collections import deque
from dataclasses import dataclass
from typing import Any, Dict, Iterator, List, Optional, Tuple

import numpy as np
import torch

from hamer_yolo_tpu_torch.core import nn
from hamer_yolo_tpu_torch.models.mano import ManoModel
from hamer_yolo_tpu_torch.pipeline.captured import CapturedProgram
from hamer_yolo_tpu_torch.pipeline.frame import (PipelineConfig, infer_frames,
                                                 infer_frames_tracked)
from hamer_yolo_tpu_torch.pipeline.runner import pick_bucket


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
    names another). ``bucket_hw`` pins the padded frame shape (default: the
    bucket of each batch's largest frame); ``upload_dtype`` pins the upload
    dtype (default: uint8 when every frame of the batch is uint8, else f32),
    so that a stray float frame does not capture a second program;
    ``detect_every`` and ``track_expand`` drive ``stream_multi``'s tracking."""

    def __init__(self, params: nn.Params, mano_model: ManoModel,
                 cfg: Optional[PipelineConfig] = None, batch_size: int = 16,
                 bucket_hw: Optional[Tuple[int, int]] = None, detect_every: int = 1,
                 track_expand: float = 1.3, upload_dtype=None, device="cuda"):
        self.params = params
        self.mano_model = mano_model
        self.cfg = cfg or PipelineConfig()
        self.batch_size = batch_size
        self.bucket_hw = bucket_hw
        self.upload_dtype = None if upload_dtype is None else np.dtype(upload_dtype)
        self.detect_every = max(1, int(detect_every))
        self.track_expand = float(track_expand)
        self.device = torch.device(device)
        self.last_stats = ServingStats()
        self.programs = {"detect": CapturedProgram("BatchedPipeline detect program",
                                                   self._detect_fn, self.device),
                         "tracked": CapturedProgram("BatchedPipeline tracked program",
                                                    self._tracked_fn, self.device)}

    def _detect_fn(self, images, hws, Ks):
        # uint8 frames are cast on the device: 4x fewer bytes uploaded, exact for 0..255
        return infer_frames(self.params, self.mano_model, images.to(torch.float32), hws, Ks,
                            self.cfg)

    def _tracked_fn(self, images, kp2d, is_right, valid, hws, Ks):
        return infer_frames_tracked(self.params, self.mano_model, images.to(torch.float32),
                                    kp2d, is_right, valid, hws, Ks, self.cfg,
                                    track_expand=self.track_expand)

    def _pad_frames(self, frames: List[np.ndarray], K: np.ndarray):
        """Bucket-pad a frame list to (images, hws, Ks) batch arrays. Pad
        rows get the bucket's shape as their size and the last intrinsics."""
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
        bh, bw = self.bucket_hw or pick_bucket(hmax, wmax)
        if hmax > bh or wmax > bw:
            raise ValueError(f"a {hmax}x{wmax} frame does not fit the bucket {bh}x{bw}")
        if self.upload_dtype is not None:
            dtype = self.upload_dtype
        else:
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

    def _dispatch(self, frames: List[np.ndarray], K: np.ndarray):
        """Pad, upload and queue one batch on the detect program; returns
        (device outputs, n). The work is queued on the card and this returns
        at once, so the host can prepare the next batch meanwhile."""
        return self.programs["detect"](*self._pad_frames(frames, K)), len(frames)

    def _dispatch_tracked(self, frames: List[np.ndarray], states: List[dict], K: np.ndarray):
        """Queue a detector-skip batch: each frame's boxes come from its
        source's previous tick (``states`` rows, one per frame: {"kp2d":
        (S, 21, 2), "is_right": (S,), "valid": (S,)})."""
        images, hws, Ks = self._pad_frames(frames, K)
        S = self.cfg.max_hands
        kp2d = np.zeros((self.batch_size, S, 21, 2), np.float32)
        is_right = np.zeros((self.batch_size, S), np.float32)
        valid = np.zeros((self.batch_size, S), np.bool_)
        for i, st in enumerate(states):
            kp2d[i] = st["kp2d"]
            is_right[i] = st["is_right"]
            valid[i] = st["valid"]
        return self.programs["tracked"](images, kp2d, is_right, valid, hws, Ks), len(frames)

    @staticmethod
    def _fetch(out: Dict[str, torch.Tensor], n: int) -> Dict[str, np.ndarray]:
        return {k: v[:n].cpu().numpy() for k, v in out.items()}

    def process_batch(self, frames: List[np.ndarray], K: np.ndarray) -> Dict[str, np.ndarray]:
        """frames: at most ``batch_size`` HWC BGR uint8 / float 0..255 frames;
        K: (3, 3) shared or (len(frames), 3, 3) per frame. Returns the
        stacked outputs, leading dim len(frames)."""
        return self._fetch(*self._dispatch(frames, K))

    def stream(self, frame_iter: Iterator[np.ndarray], K: np.ndarray, depth: int = 2
               ) -> Iterator[Dict[str, np.ndarray]]:
        """Consume a frame iterator in batches and yield each batch's
        outputs in order, with up to ``depth`` batches queued on the device:
        batch i + 1 is padded, uploaded and queued before batch i is
        fetched."""
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
                if len(pending) >= depth:
                    yield drain_one()
        if buf:
            pending.append(self._dispatch(buf, K))
        while pending:
            yield drain_one()
        stats.total_s = time.time() - t0
        self.last_stats = stats

    def stream_multi(self, sources, K: np.ndarray, max_batches: Optional[int] = None,
                     timeout: float = 1.0, buffer: int = 4) -> Iterator[Dict[str, Any]]:
        """Drive N live sources (capture indices, files, URLs or frame
        iterators; io/video.MultiStreamReader) as one batch a tick. Yields
        {"outputs": stacked outputs (n_live leading dim), "source_idx": the
        live sources}; a source with no new frame within ``timeout`` sits the
        tick out.

        With ``detect_every`` = K > 1 the tick also carries "detected", the
        sources that ran the detector: all of them on every K-th tick, and
        any source without a state (new, or frameless so far). The others
        run the tracked program on boxes from their previous tick's
        keypoints, queued before either sub-batch is fetched. A hand that
        appears between keyframes is found at the next one; a hand that
        leaves keeps its slot until then."""
        from hamer_yolo_tpu_torch.io.video import MultiStreamReader

        reader = MultiStreamReader(sources, buffer=buffer)
        stats = ServingStats()
        track: Dict[int, dict] = {}
        tick = 0
        t0 = time.time()
        try:
            for batch in reader.batches(max_batches=max_batches, timeout=timeout):
                live = [(i, f) for i, f in enumerate(batch) if f is not None]
                if not live:
                    continue
                keyframe = tick % self.detect_every == 0
                tick += 1
                if self.detect_every <= 1:
                    out = self.process_batch([f for _, f in live], K)
                    stats.frames += len(live)
                    stats.batches += 1
                    yield {"outputs": out, "source_idx": [i for i, _ in live]}
                    continue
                det = [(i, f) for i, f in live if keyframe or i not in track]
                det_ids = {i for i, _ in det}
                trk = [(i, f) for i, f in live if i not in det_ids]
                pend = []  # both are queued before either is fetched
                if det:
                    pend.append((det, self._dispatch([f for _, f in det], K)))
                if trk:
                    pend.append((trk, self._dispatch_tracked(
                        [f for _, f in trk], [track[i] for i, _ in trk], K)))
                per_src: Dict[int, Dict[str, np.ndarray]] = {}
                for items, (out, n) in pend:
                    o = self._fetch(out, n)
                    for j, (i, _) in enumerate(items):
                        row = {k: v[j] for k, v in o.items()}
                        per_src[i] = row
                        track[i] = {"kp2d": row["keypoints_2d"], "is_right": row["is_right"],
                                    "valid": row["valid"]}
                order = [i for i, _ in live]
                stacked = {k: np.stack([per_src[i][k] for i in order])
                           for k in per_src[order[0]]}
                stats.frames += len(live)
                stats.batches += len(pend)
                yield {"outputs": stacked, "source_idx": order, "detected": sorted(det_ids)}
        finally:
            reader.close()
            stats.total_s = time.time() - t0
            self.last_stats = stats
