"""Profiling and timing (port of hamer_yolo_tpu/utils/profiling.py): a
torch.profiler trace of a block, a stage timer that synchronizes the card
before it reads the clock, a p50 / p90 / mean latency benchmark, and a count
of a function's floating-point operations and bytes, counted as XLA's cost
analysis counts a compiled program (the reference's thop FLOPs).
"""
from __future__ import annotations

import contextlib
import os
import time
from typing import Any, Callable, Dict, List, Optional

import numpy as np
import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves


@contextlib.contextmanager
def trace(log_dir: str, device="cuda"):
    """Profile the block: the host's ops and, where ``device`` is a CUDA
    device, the card's kernels; on exit the trace goes to
    ``<log_dir>/trace.json`` (view it in Perfetto, chrome://tracing or
    TensorBoard's profiler plugin)."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.device(device).type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield log_dir
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


def block_until_ready(tree: Any) -> Any:
    """Wait for the work that makes the tensors of ``tree``: one
    torch.cuda.synchronize per CUDA device among them (jax.block_until_ready)."""
    for dev in {t.device for t in tree_leaves(tree)
                if isinstance(t, torch.Tensor) and t.device.type == "cuda"}:
        torch.cuda.synchronize(dev)
    return tree


class StageTimer:
    """Wall-clock stage timing: ``stop`` waits for the tensors it is given
    before it reads the clock, so that the card's queued work is counted in
    its stage (the reference's time_synchronized pairs)."""

    def __init__(self):
        self.stages: List[tuple] = []
        self._t0: Optional[float] = None
        self._name: Optional[str] = None

    def start(self, name: str) -> None:
        self._name = name
        self._t0 = time.perf_counter()

    def stop(self, *block_on) -> float:
        if block_on:
            block_until_ready(block_on)
        dt = time.perf_counter() - self._t0
        self.stages.append((self._name, dt))
        return dt

    def report(self) -> str:
        total = sum(dt for _, dt in self.stages)
        lines = [f"{n:<24s} {dt * 1e3:8.2f} ms  {dt / total * 100:5.1f}%"
                 for n, dt in self.stages]
        lines.append(f"{'total':<24s} {total * 1e3:8.2f} ms")
        return "\n".join(lines)


def benchmark(fn: Callable, *args, iters: int = 10, warmup: int = 2) -> Dict[str, float]:
    """p50 / p90 / mean latency in ms of ``fn(*args)`` on the host's clock,
    each call waited for (``block_until_ready`` on its outputs)."""
    for _ in range(warmup):
        block_until_ready(fn(*args))
    lat = []
    for _ in range(iters):
        t0 = time.perf_counter()
        block_until_ready(fn(*args))
        lat.append(time.perf_counter() - t0)
    lat_ms = np.asarray(lat) * 1e3
    return {"p50_ms": float(np.percentile(lat_ms, 50)),
            "p90_ms": float(np.percentile(lat_ms, 90)),
            "mean_ms": float(lat_ms.mean())}


def _valid_taps(n_in: int, k: int, stride: int, pad: int, dilation: int, n_out: int) -> int:
    """Kernel taps that land inside the input, summed over the outputs of
    one spatial axis (XLA counts no product with a padding element)."""
    return sum(sum(0 <= o * stride - pad + j * dilation < n_in for j in range(k))
               for o in range(n_out))


def _nbytes(tree: Any) -> int:
    return sum(t.numel() * t.element_size() for t in tree_leaves(tree)
               if isinstance(t, torch.Tensor))


class _Counter(TorchDispatchMode):
    """Bytes each op reads and writes (its tensor operands and results, each
    once; views move nothing) and the flops of convolutions. A zero pad that
    a convolution consumes is folded into it, as XLA folds it: the pad moves
    no bytes, the convolution reads the unpadded input and multiplies only
    the taps inside it."""

    def __init__(self):
        super().__init__()
        self.bytes = 0
        self.conv_flops = 0
        self._pads: Dict[int, tuple] = {}  # id(padded) -> (padded, its bytes, input, pads)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        aten = torch.ops.aten
        if func.is_view:
            return out
        if func is aten.constant_pad_nd.default and not (args[2:] or [kwargs.get("value", 0)])[0]:
            self._pads[id(out)] = (out, _nbytes((args, out)), args[0], list(args[1]))
            return out
        if func is aten.convolution.default:
            x, w, bias, stride, padding, dilation, transposed = args[:7]
            pad = [(p, p) for p in padding]
            hit = self._pads.pop(id(x), None)
            if hit is not None and hit[0] is x and len(hit[3]) == 2 * (x.ndim - 2):
                x, tp = hit[2], hit[3]  # tp: the last axis first, (left, right, top, bottom)
                last = x.ndim - 3
                pad = [(p + tp[2 * (last - i)], p + tp[2 * (last - i) + 1])
                       for i, p in enumerate(padding)]
            elif hit is not None:
                self.bytes += hit[1]
            self.bytes += _nbytes((x, w, bias, out))
            if not transposed:
                taps = 1
                for i in range(x.ndim - 2):
                    n_in, n_out = x.shape[2 + i], out.shape[2 + i]
                    taps *= _valid_taps(n_in, w.shape[2 + i], stride[i], pad[i][0],
                                        dilation[i], n_out)
                self.conv_flops += 2 * x.shape[0] * w.shape[0] * w.shape[1] * taps
            return out
        self.bytes += _nbytes((args, kwargs, out))
        return out

    def total_bytes(self) -> int:
        return self.bytes + sum(hit[1] for hit in self._pads.values())


def compiled_flops(fn: Callable, *args) -> Dict[str, float]:
    """{"flops", "bytes_accessed"} of one call of ``fn(*args)``, run eagerly
    under torch.utils.flop_counter.FlopCounterMode and a dispatch mode that
    adds up each op's operand and result bytes. It matches XLA's cost
    analysis on a single matmul or convolution (a padded convolution counts
    only the taps inside the input, as XLA does); on a whole forward XLA
    also counts elementwise operations and fuses ops, so that it reports
    more flops and fewer bytes. A hand-written kernel called through its
    own library is not seen: count a model's plain twin."""
    from torch.utils.flop_counter import FlopCounterMode

    aten = torch.ops.aten
    counted_here = {aten.convolution: lambda *a, **k: 0}  # _Counter counts them
    with torch.no_grad(), FlopCounterMode(display=False, custom_mapping=counted_here) as fc, \
            _Counter() as counter:
        block_until_ready(fn(*args))
    return {"flops": float(fc.get_total_flops() + counter.conv_flops),
            "bytes_accessed": float(counter.total_bytes())}
