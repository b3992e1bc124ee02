"""Video, webcam and image-stream readers (port of hamer_yolo_tpu/io/video.py,
the reference's LoadImages and LoadStreams):

- ``iter_media`` yields BGR frames from an image dir, an image or video
  file, or a glob, in order;
- ``StreamReader`` keeps the latest frame of a live capture in a thread, so
  that the consumer never blocks on IO;
- ``MultiStreamReader`` reads N sources in threads into bounded buffers
  (the oldest frame goes when one is full) and hands out one frame per
  source a tick.

cv2 is imported only where a file or a capture is opened: frame iterators as
sources need none. Every thread is a daemon, stops on ``close()`` and is
joined with a timeout; every read takes a timeout.
"""
from __future__ import annotations

import glob
import os
import threading
import time
from collections import deque
from typing import Iterator, List, Optional

import numpy as np

VIDEO_EXTS = (".mp4", ".avi", ".mov", ".mkv", ".webm")
IMAGE_EXTS = (".jpg", ".jpeg", ".png", ".bmp")
JOIN_TIMEOUT_S = 1.0  # close(): how long each reader thread is waited for


def iter_media(source: str, max_frames: Optional[int] = None) -> Iterator[np.ndarray]:
    """BGR frames from an image dir / image file / video file / glob, at most
    ``max_frames`` of them; unreadable images are skipped."""
    import cv2

    def iter_video(path):
        cap = cv2.VideoCapture(path)
        try:
            while True:
                ok, frame = cap.read()
                if not ok:
                    break
                yield frame
        finally:
            cap.release()

    def iter_image(path):
        img = cv2.imread(path)
        if img is not None:
            yield img

    if os.path.isdir(source):
        paths = sorted(p for p in glob.glob(os.path.join(source, "*"))
                       if p.lower().endswith(IMAGE_EXTS + VIDEO_EXTS))
    elif any(ch in source for ch in "*?["):
        paths = sorted(glob.glob(source))
    else:
        paths = [source]
    count = 0
    for path in paths:
        frames = iter_video(path) if path.lower().endswith(VIDEO_EXTS) else iter_image(path)
        for frame in frames:
            yield frame
            count += 1
            if max_frames and count >= max_frames:
                return


class StreamReader:
    """The latest frame of a live source (capture index or URL), read by a
    daemon thread."""

    def __init__(self, source=0):
        import cv2

        self.cap = cv2.VideoCapture(source)
        if not self.cap.isOpened():
            raise RuntimeError(f"cannot open stream {source}")
        self.frame: Optional[np.ndarray] = None
        self.running = True
        self._lock = threading.Lock()
        self._thread = threading.Thread(target=self._loop, daemon=True)
        self._thread.start()

    def _loop(self):
        while self.running:
            ok, frame = self.cap.read()
            if not ok:
                time.sleep(0.005)
                continue
            with self._lock:
                self.frame = frame

    def read(self, timeout: float = 1.0) -> Optional[np.ndarray]:
        """The newest frame not yet read, or None after ``timeout`` seconds."""
        deadline = time.time() + timeout
        while time.time() < deadline:
            with self._lock:
                if self.frame is not None:
                    f, self.frame = self.frame, None
                    return f
            time.sleep(0.002)
        return None

    def frames(self, timeout: float = 1.0) -> Iterator[np.ndarray]:
        while self.running:
            f = self.read(timeout)
            if f is not None:
                yield f

    def close(self):
        self.running = False
        self._thread.join(timeout=JOIN_TIMEOUT_S)
        self.cap.release()


class MultiStreamReader:
    """N concurrent sources -> one frame per source a tick (LoadStreams):
    one daemon thread per source fills a ring of ``buffer`` frames. Sources
    are capture indices, files or URLs (``int`` / ``str``, opened with cv2)
    or iterators of frames (synthetic streams, tests)."""

    def __init__(self, sources, buffer: int = 4):
        self.n = len(sources)
        self._buffers: List[deque] = [deque(maxlen=buffer) for _ in sources]
        self._locks = [threading.Lock() for _ in sources]
        self.running = True
        self._threads: List[threading.Thread] = []
        self._caps = []
        for i, src in enumerate(sources):
            if isinstance(src, (int, str)):
                import cv2

                cap = cv2.VideoCapture(src)
                if not cap.isOpened():
                    self.close()
                    raise RuntimeError(f"cannot open stream {src}")
                self._caps.append(cap)
                t = threading.Thread(target=self._cap_loop, args=(i, cap), daemon=True)
            else:
                t = threading.Thread(target=self._iter_loop, args=(i, iter(src)), daemon=True)
            t.start()
            self._threads.append(t)

    def _push(self, i: int, frame: np.ndarray):
        with self._locks[i]:
            self._buffers[i].append(frame)

    def _cap_loop(self, i: int, cap):
        while self.running:
            ok, frame = cap.read()
            if not ok:
                time.sleep(0.005)
                continue
            self._push(i, frame)

    def _iter_loop(self, i: int, it):
        for frame in it:
            if not self.running:
                return
            self._push(i, frame)

    def read_batch(self, timeout: float = 1.0) -> list:
        """One frame per source, the oldest buffered (in-order playback);
        None for a source with nothing new within ``timeout`` seconds."""
        out = [None] * self.n
        deadline = time.time() + timeout
        remaining = set(range(self.n))
        while remaining and time.time() < deadline:
            for i in list(remaining):
                with self._locks[i]:
                    if self._buffers[i]:
                        out[i] = self._buffers[i].popleft()
                        remaining.discard(i)
            if remaining:
                time.sleep(0.002)
        return out

    def batches(self, max_batches: Optional[int] = None, timeout: float = 1.0
                ) -> Iterator[list]:
        """[frame or None] * n batches until closed, until every source is
        dry for ``timeout`` seconds, or after ``max_batches``."""
        count = 0
        while self.running:
            batch = self.read_batch(timeout)
            if all(f is None for f in batch):
                return
            yield batch
            count += 1
            if max_batches and count >= max_batches:
                return

    def close(self):
        self.running = False
        for t in self._threads:
            t.join(timeout=JOIN_TIMEOUT_S)
        for cap in self._caps:
            cap.release()
