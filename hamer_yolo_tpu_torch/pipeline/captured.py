"""One captured CUDA graph per input signature: the port's counterpart of the
JAX package's per-bucket ``jax.jit`` caches (``FrameProgram._fn_for_bucket``
and the masked runner's ``fn_for`` in hamer_yolo_tpu/pipeline/runner.py,
``BatchedPipeline``'s ``fn`` and ``fn_tracked`` in
hamer_yolo_tpu/pipeline/serving.py), so that one batch is one dispatch.

A ``CapturedProgram`` wraps a function of fixed-shape device tensors that
returns a dict of tensors, and is called with numpy arrays. On the card it
keeps one ``torch.cuda.CUDAGraph`` per key: the shapes and dtypes of the
arrays, which for the pipeline programs are the bucket H x W, the batch and
the upload dtype, where JAX's jit signature would retrace. The first call of
a key
  1. uploads the arrays into the key's static device buffers;
  2. runs the function once eagerly on a side stream, the warm-up: the first
     use of a kernel builds it and raises its shared-memory limit, and the
     weight caches (``core/nn.cast_weight``, ``ops/attn_block.bf16_weight``,
     ``ops/int8_matmul.kmajor_weight``, ``ops/mano_lbs.fk_constants``) are
     made, none of which may happen inside a capture;
  3. captures the function into a graph with a private memory pool of its
     own: graphs whose replays alternate (the detect and tracked programs of
     ``stream_multi``) must not share one.
Every call then copies its arrays into the static buffers, replays the graph
and returns its outputs cloned, each step queued on the caller's current
stream, so a second batch can be queued before the first is fetched and a
replay never overwrites outputs that a caller still holds.

The arrays reach the card through page-locked staging buffers, ``SLOTS`` per
key, taken in turns. Before a slot is written again the host waits on the
event recorded after that slot's last copy, so an asynchronous upload never
reads a buffer that the next batch is filling.

Everything else the function reads (weights, the config, switches such as
HYT_ATTN) is fixed at capture, as JAX fixes it at trace time. The kernels'
launch counters count at the warm-up and at the capture, not at a replay.
The host work of the kernels' wrappers (argument checks, TMA maps encoded
from device addresses) is captured with them, which is right only because a
replay reads and writes the addresses of the capture.

A program keeps at most ``MAX_GRAPHS`` keys (``LruCache``). A new key past
that evicts the least recently used one, and with it everything the key holds:
the graph, its static inputs and outputs, its pinned slots and its private
memory pool, which ``torch.cuda.empty_cache`` then returns to the card. The
outputs already handed to callers are clones and outlive it. Past the largest
bucket each new frame size is a new key (runner.pick_bucket), so without the
bound a long run over frames of many sizes would keep a pool for each.

On the CPU the function runs eagerly on the arrays: CUDA graphs exist only on
the card. A capture that fails raises, naming the program and the key. One
thread at a time may call a program.
"""
from __future__ import annotations

from collections import OrderedDict
from typing import Any, Callable, Dict, Hashable, Iterator, List, Sequence, Tuple

import numpy as np
import torch

Tensors = Dict[str, torch.Tensor]
SLOTS = 2  # staging buffers per key: batches whose uploads may be in flight at once
# Keys (graphs) a program keeps: the five default buckets at one batch and
# upload dtype, and three more (portrait frames, a float upload, sizes past
# the largest bucket) before the least recently used goes.
MAX_GRAPHS = 8


class LruCache:
    """At most ``capacity`` values by key, least recently used first. ``get``
    returns the value of a key and marks it used, making it with ``make()``
    where the key is new; a new key past the capacity first evicts the least
    recently used one, handing it to ``release(key, value)``."""

    def __init__(self, capacity: int, release: Callable[[Hashable, Any], None]):
        self.capacity = capacity
        self.release = release
        self._values: "OrderedDict[Hashable, Any]" = OrderedDict()

    def get(self, key: Hashable, make: Callable[[], Any]) -> Tuple[Any, bool]:
        """(value, whether it was made by this call)."""
        if key in self._values:
            self._values.move_to_end(key)
            return self._values[key], False
        while len(self._values) >= self.capacity:
            self.release(*self._values.popitem(last=False))
        value = self._values[key] = make()
        return value, True

    def __len__(self) -> int:
        return len(self._values)

    def keys(self) -> List[Hashable]:
        """The keys, least recently used first."""
        return list(self._values)

    def items(self) -> Iterator[Tuple[Hashable, Any]]:
        return iter(list(self._values.items()))


class _Graph:
    """One key's graph, its static inputs and outputs, and its staging slots."""

    def __init__(self, arrays: Sequence[np.ndarray], device: torch.device):
        dtypes = [torch.from_numpy(np.empty(0, a.dtype)).dtype for a in arrays]
        self.static = [torch.empty(a.shape, dtype=d, device=device)
                       for a, d in zip(arrays, dtypes)]
        self.slots = [([torch.empty(a.shape, dtype=d, pin_memory=True)
                        for a, d in zip(arrays, dtypes)], torch.cuda.Event())
                      for _ in range(SLOTS)]
        self.turn = 0
        self.graph = torch.cuda.CUDAGraph()
        self.outputs: Tensors = {}
        self.pool_bytes = 0

    def upload(self, arrays: Sequence[np.ndarray]) -> None:
        host, copied = self.slots[self.turn]
        self.turn = (self.turn + 1) % len(self.slots)
        copied.synchronize()  # this slot's previous upload has been read
        for h, a in zip(host, arrays):
            h.numpy()[...] = a
        for d, h in zip(self.static, host):
            d.copy_(h, non_blocking=True)
        copied.record()

    def release(self) -> None:
        """Drops the graph, its buffers and its pinned slots, once the card
        has finished with them; the private pool's memory goes back to the
        caching allocator with the last tensor allocated in it."""
        torch.cuda.synchronize(self.static[0].device if self.static else None)
        self.graph.reset()
        self.static, self.slots, self.outputs = [], [], {}


def _describe_key(key: Tuple) -> str:
    return ", ".join(f"{tuple(shape)} {np.dtype(dt).name}" for shape, dt in key)


class CapturedProgram:
    """``fn`` (device tensors -> dict of tensors) as one CUDA graph per
    signature of its inputs on a CUDA ``device``, eager elsewhere; ``name``
    names it in errors and reports."""

    def __init__(self, name: str, fn: Callable[..., Tensors], device):
        self.name = name
        self.fn = fn
        self.device = torch.device(device)
        self._graphs = LruCache(MAX_GRAPHS, lambda key, g: g.release())

    def __call__(self, *arrays: np.ndarray) -> Tensors:
        """The outputs of ``fn`` on the arrays, on the program's device. On
        the card they are queued and not yet computed when this returns."""
        arrays = [np.ascontiguousarray(a) for a in arrays]
        with torch.inference_mode():  # the static buffers are inference tensors
            if self.device.type != "cuda":
                return self.fn(*(torch.from_numpy(a).to(self.device) for a in arrays))
            key = tuple((a.shape, a.dtype.str) for a in arrays)
            g, made = self._graphs.get(key, lambda: self._capture(key, arrays))
            if not made:
                g.upload(arrays)
            g.graph.replay()
            return {k: v.clone() for k, v in g.outputs.items()}

    def _capture(self, key: Tuple, arrays: List[np.ndarray]) -> _Graph:
        dev = self.device
        g = _Graph(arrays, dev)
        g.upload(arrays)
        side = torch.cuda.Stream(dev)
        side.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(side):
            self.fn(*g.static)  # the warm-up
        torch.cuda.current_stream(dev).wait_stream(side)
        try:
            with torch.cuda.graph(g.graph, stream=side, capture_error_mode="thread_local"):
                g.outputs = self.fn(*g.static)
        except Exception as e:
            raise RuntimeError(f"{self.name}: capturing the CUDA graph of the inputs "
                               f"[{_describe_key(key)}] failed: {e}") from e
        g.pool_bytes = _pool_bytes(g.graph.pool(), dev)
        return g

    @property
    def pool_bytes(self) -> Dict[str, int]:
        """The bytes each kept graph's private memory pool held after its
        capture, by key, least recently used first."""
        return {_describe_key(k): g.pool_bytes for k, g in self._graphs.items()}


def _pool_bytes(pool, device: torch.device) -> int:
    """The bytes of the segments the caching allocator keeps for ``pool``."""
    pool = tuple(pool)
    return sum(seg["total_size"] for seg in torch.cuda.memory._snapshot(device)["segments"]
               if tuple(seg.get("segment_pool_id", ())) == pool)
