#!/usr/bin/env python3
"""ops/pointnet.smallest_k's order on the card and its cost: three forms of
the k smallest entries along the last axis, ascending, ties to the lower
index.

- "stable sort": torch.sort(d, stable=True), its first k columns;
- "total-order sort": the same stable sort over int32 keys that order the
  floats totally (-0 below +0, as lax.top_k(-d, k) orders them), the values
  gathered at the chosen indices;
- "top-k of unique keys": a top-k over int64 keys (the value's order above
  the index), -0 taken as +0.

Each form's indices on the card against the CPU's, and against numpy's
stable argsort of the total-order keys, on rows full of ties and of -0 and
+0; then each form's device ms by CUDA events at the shapes the main paths
give it (A B C C B A), the CPU's seconds at DGCNN semseg's shape on one
thread and on every core, and KPFusion's loss forward (B = 1) and train step
(B = 4) at the default config with each form in place.

    python3 chip_smallest_k.py

Needs a CUDA card. Seeded inputs.
"""
import os
import subprocess
import sys
import time

import numpy as np
import torch

from hamer_yolo_tpu_torch.models.kpfusion_rgbd import geometry as G
from hamer_yolo_tpu_torch.ops import pointnet as pn

# (name, (B, N, M), k): rgbd's img2pcl_index (1,024 points against the
# 32 x 32 features), KPFusion's train batch, three_nn, pointMLP's grouper, DGCNN
SHAPES = [("img2pcl_index B=1", (1, 1024, 1024), 4),
          ("img2pcl_index B=4", (4, 1024, 1024), 4),
          ("three_nn", (8, 1024, 256), 3),
          ("pointMLP grouper", (8, 512, 1024), 24),
          ("DGCNN partseg kNN", (8, 2048, 2048), 40),
          ("DGCNN semseg kNN", (8, 4096, 4096), 40)]


def total_keys(d):
    """int32 keys of f32 ``d`` in the floats' total order."""
    bits = d.contiguous().view(torch.int32)
    return torch.where(bits < 0, bits ^ 0x7FFFFFFF, bits)


def stable_sort(d, k):
    vals, idx = torch.sort(d, dim=-1, stable=True)
    return vals[..., :k], idx[..., :k]


def total_order_sort(d, k):
    idx = torch.sort(total_keys(d), dim=-1, stable=True).indices[..., :k]
    return torch.gather(d, -1, idx), idx


def unique_key_topk(d, k):
    ordered = total_keys(d + 0.0).long()
    index = torch.arange(d.shape[-1], device=d.device)
    idx = torch.topk((ordered << 32) | index, k, dim=-1, largest=False, sorted=True).indices
    return torch.gather(d, -1, idx), idx


FORMS = {"stable sort": stable_sort, "total-order sort": total_order_sort,
         "top-k of unique keys": unique_key_topk}


def tie_rows(rng, rows, n):
    """Rows of few distinct values, about a quarter of them -0 or +0."""
    d = rng.choice(np.float32([0.0, -0.0, 0.25, 0.5, 1.0, 3.0]), size=(rows, n),
                   p=[0.15, 0.15, 0.2, 0.2, 0.2, 0.1])
    return d.astype(np.float32)


def order_check(dev):
    rng = np.random.default_rng(0)
    for n, k in ((7, 7), (64, 16), (1024, 40), (4096, 40)):
        d = tie_rows(rng, 64, n)
        want = np.argsort(total_keys(torch.from_numpy(d)).numpy(), axis=-1, kind="stable")[:, :k]
        parts = []
        for name, f in FORMS.items():
            cpu = f(torch.from_numpy(d), k)[1].numpy()
            card = f(torch.from_numpy(d).to(dev), k)[1].cpu().numpy()
            parts.append(f"{name}: card against CPU {int((card != cpu).any(-1).sum())} rows, "
                         f"card against the total order {int((card != want).any(-1).sum())}, "
                         f"CPU against it {int((cpu != want).any(-1).sum())}")
        print(f"order on ties and +-0, 64 rows of {n}, k={k}: " + "; ".join(parts), flush=True)


def cuda_ms(fn, iters=10, warmup=2):
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(iters):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


def shape_times(dev):
    g = torch.Generator(device=dev).manual_seed(1)
    order = list(FORMS) + list(FORMS)[::-1]
    for label, (B, N, M), k in SHAPES:
        d = pn.pairwise_sqdist(torch.rand(B, N, 3, generator=g, device=dev),
                               torch.rand(B, M, 3, generator=g, device=dev))
        got = {name: [] for name in FORMS}
        for name in order:
            got[name].append(cuda_ms(lambda: FORMS[name](d, k)))
        print(f"smallest_k at {label} ({B}, {N}, {M}), k={k}, device ms (A B C C B A): "
              + "; ".join(f"{name} {', '.join(f'{t:.4f}' for t in ts)}"
                          for name, ts in got.items()), flush=True)
        del d


def cpu_times():
    d = pn.pairwise_sqdist(torch.rand(8, 4096, 3, generator=torch.Generator().manual_seed(2)),
                           torch.rand(8, 4096, 3, generator=torch.Generator().manual_seed(3)))
    threads = torch.get_num_threads()
    for n in (1, os.cpu_count() or 1):
        torch.set_num_threads(n)
        parts = []
        for name, f in FORMS.items():
            t0 = time.perf_counter()
            f(d, 40)
            parts.append(f"{name} {time.perf_counter() - t0:.2f} s")
        print(f"smallest_k on the CPU at DGCNN semseg's (8, 4096, 4096), k=40, {n} thread(s): "
              + "; ".join(parts), flush=True)
    torch.set_num_threads(threads)


def kpfusion_times(dev):
    from hamer_yolo_tpu_torch.models.kpfusion_rgbd.model import KPFusionConfig
    from hamer_yolo_tpu_torch.training import train_kpfusion_rgbd as TK

    cfg = KPFusionConfig()
    state = TK.init_train_state(torch.Generator(device=dev).manual_seed(4), cfg)
    rng = np.random.default_rng(5)
    batches = {B: {k: torch.from_numpy(v).to(dev)
                   for k, v in TK.synthetic_rgbd_batch(rng, B, cfg).items()} for B in (1, 4)}
    parent = pn.smallest_k

    def forward():
        with torch.no_grad():
            TK.kpfusion_rgbd_loss(state.params, batches[1], cfg)

    def step():
        TK.train_step(state, batches[4], cfg)

    order = list(FORMS) + list(FORMS)[::-1]
    for label, fn, iters in (("loss forward B=1", forward, 10), ("train step B=4", step, 6)):
        got = {name: [] for name in FORMS}
        try:
            for name in order:
                pn.smallest_k = G.smallest_k = FORMS[name]
                got[name].append(cuda_ms(fn, iters=iters))
        finally:
            pn.smallest_k = G.smallest_k = parent
        print(f"KPFusion default config, {label}, ms by CUDA events (A B C C B A): "
              + "; ".join(f"{name} {', '.join(f'{t:.2f}' for t in ts)}"
                          for name, ts in got.items()), flush=True)


def main():
    if not torch.cuda.is_available():
        print("chip_smallest_k.py needs a CUDA card", file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader",
                          "--id=0"], capture_output=True, text=True, check=True).stdout.strip()
    print(f"{smi}; torch {torch.__version__}", flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    order_check(dev)
    shape_times(dev)
    kpfusion_times(dev)
    cpu_times()
    return 0


if __name__ == "__main__":
    sys.exit(main())
