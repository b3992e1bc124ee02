"""HTTP serving front end (port of hamer_yolo_tpu/pipeline/http_server.py):
POST an image, get its hands back as JSON.

The reference deploys its detector behind Triton with client-side batching.
Here a stdlib ThreadingHTTPServer feeds a ``MicroBatcher``: concurrent
requests are collected for up to ``max_wait_ms`` (or until ``batch_size``
frames wait) and run as one batch of a serving.BatchedPipeline, a replay of
its captured CUDA graph on the card. One dispatcher thread owns the device:
it captures and replays, the request threads only decode and wait.

Endpoints:
  POST /infer    image bytes (anything ``decode_image`` reads) ->
                 {"hands": [{side, box, score, betas, theta, cam_t,
                 root_depth}, ...], "height", "width"};
                 ?vertices=1 adds each hand's 778 x 3 vertices
  GET  /healthz  {"ok": true, "device": the torch device, "device_name"}
  GET  /stats    frames, batches, uptime_s, fps, batch_size

Where a batch mixes frame sizes, each frame without intrinsics of its own
gets the default intrinsics of its own size (JAX gives every frame those of
the first frame's size: ROADMAP.md, F13). Decoded frames are submitted as
uint8 (JAX casts them to f32 on the host first; the outputs are the same, the
upload is 4x smaller).
"""
from __future__ import annotations

import json
import threading
import time
import traceback
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any, Dict, List, Optional

import numpy as np
import torch

CLOSE_TIMEOUT_S = 5.0  # MicroBatcher.close: how long the dispatcher is waited for


def _default_K(hw) -> np.ndarray:
    """The server's fallback intrinsics for an (h, w) frame (JAX's)."""
    h, w = hw
    return np.array([[906.96, 0.0, w / 2.0],
                     [0.0, 906.79, h / 2.0],
                     [0.0, 0.0, 1.0]], np.float32)


def decode_image(raw: bytes) -> Optional[np.ndarray]:
    """An encoded image (jpg, png, anything cv2 decodes) -> BGR uint8, or
    None where it does not decode."""
    import cv2

    return cv2.imdecode(np.frombuffer(raw, np.uint8), cv2.IMREAD_COLOR)


class MicroBatcher:
    """Collects concurrent requests into device-sized batches. ``submit``
    blocks the calling request thread until its frame's outputs are ready;
    one dispatcher thread runs the batches."""

    def __init__(self, pipe, K_default: Optional[np.ndarray] = None,
                 max_wait_ms: float = 15.0):
        self.pipe = pipe
        self.K_default = K_default
        self.max_wait = max_wait_ms / 1e3
        self._lock = threading.Lock()
        self._queue: List[dict] = []
        self._wake = threading.Event()
        self._stop = False
        self.frames = 0
        self.batches = 0
        self.t0 = time.time()
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    def submit(self, image: np.ndarray, K: Optional[np.ndarray] = None
               ) -> Dict[str, np.ndarray]:
        item = {"img": image, "K": K, "ev": threading.Event(), "out": None, "err": None}
        with self._lock:
            self._queue.append(item)
        self._wake.set()
        item["ev"].wait()
        if item["err"] is not None:
            raise item["err"]
        return item["out"]

    def close(self):
        self._stop = True
        self._wake.set()
        self._thread.join(timeout=CLOSE_TIMEOUT_S)

    def intrinsics(self, batch: List[dict]) -> np.ndarray:
        """(n, 3, 3): each item's own K, else ``K_default``, else the
        default of its frame's size (F13)."""
        return np.stack([it["K"] if it["K"] is not None
                         else self.K_default if self.K_default is not None
                         else _default_K(it["img"].shape[:2]) for it in batch]).astype(np.float32)

    def _run(self):
        while not self._stop:
            self._wake.wait(timeout=0.25)
            self._wake.clear()
            with self._lock:
                pending = bool(self._queue)
            if not pending:
                continue
            deadline = time.time() + self.max_wait  # the window in which requests pile up
            while time.time() < deadline:
                with self._lock:
                    if len(self._queue) >= self.pipe.batch_size:
                        break
                time.sleep(0.001)
            with self._lock:
                batch = self._queue[: self.pipe.batch_size]
                self._queue = self._queue[self.pipe.batch_size:]
            if not batch:
                continue
            try:
                out = self.pipe.process_batch([it["img"] for it in batch], self.intrinsics(batch))
                for i, it in enumerate(batch):
                    it["out"] = {k: v[i] for k, v in out.items()}
                    it["ev"].set()
                self.frames += len(batch)
                self.batches += 1
            except Exception as e:  # the waiting clients get the error
                traceback.print_exc()
                for it in batch:
                    it["err"] = e
                    it["ev"].set()
            with self._lock:
                if self._queue:
                    self._wake.set()


def _hands_json(out: Dict[str, np.ndarray], include_vertices: bool) -> List[Dict[str, Any]]:
    """One frame's valid slots as JSON-able hands, slot order (JAX's keys
    and types)."""
    hands = []
    valid = np.asarray(out["valid"]).astype(bool)
    for s in range(valid.shape[0]):
        if not valid[s]:
            continue
        h = {
            "side": "right" if float(out["is_right"][s]) > 0.5 else "left",
            "box": np.asarray(out["boxes"][s], np.float64).tolist(),
            "score": float(out["scores"][s]),
            "betas": np.asarray(out["betas"][s], np.float64).tolist(),
            "theta": np.asarray(out["theta"][s], np.float64).ravel().tolist(),
            "cam_t": np.asarray(out["cam_t"][s], np.float64).tolist(),
        }
        if "root_depth" in out:
            h["root_depth"] = float(np.asarray(out["root_depth"][s]).ravel()[0])
        if include_vertices:
            h["vertices"] = np.asarray(out["vertices"][s], np.float64).tolist()
        hands.append(h)
    return hands


def make_http_server(pipe, host: str = "127.0.0.1", port: int = 8100,
                     K_default: Optional[np.ndarray] = None,
                     max_wait_ms: float = 15.0) -> ThreadingHTTPServer:
    """Build (not start) the server over ``pipe`` (a BatchedPipeline); run
    it with ``serve_forever()`` and stop it with ``shutdown()``, then
    ``batcher.close()``. ``port`` 0 takes a free port
    (``server_address[1]``)."""
    batcher = MicroBatcher(pipe, K_default, max_wait_ms)
    dev = pipe.device
    health = {"ok": True, "device": str(dev),
              "device_name": torch.cuda.get_device_name(dev) if dev.type == "cuda" else dev.type}

    class Handler(BaseHTTPRequestHandler):
        def log_message(self, *a):  # quiet
            pass

        def _json(self, code: int, payload: dict):
            body = json.dumps(payload).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            if self.path.startswith("/healthz"):
                self._json(200, health)
            elif self.path.startswith("/stats"):
                dt = time.time() - batcher.t0
                self._json(200, {"frames": batcher.frames, "batches": batcher.batches,
                                 "uptime_s": round(dt, 2),
                                 "fps": round(batcher.frames / dt, 2) if dt else 0.0,
                                 "batch_size": pipe.batch_size})
            else:
                self._json(404, {"error": "unknown path"})

        def do_POST(self):
            if not self.path.startswith("/infer"):
                self._json(404, {"error": "unknown path"})
                return
            try:
                raw = self.rfile.read(int(self.headers.get("Content-Length", "0")))
                img = decode_image(raw)
                if img is None:
                    self._json(400, {"error": "undecodable image"})
                    return
                out = batcher.submit(img)
                include_v = "vertices=1" in (self.path.split("?", 1) + [""])[1]
                self._json(200, {"hands": _hands_json(out, include_v),
                                 "height": img.shape[0], "width": img.shape[1]})
            except Exception as e:
                self._json(500, {"error": f"{type(e).__name__}: {e}"})

    srv = ThreadingHTTPServer((host, port), Handler)
    srv.batcher = batcher
    return srv
