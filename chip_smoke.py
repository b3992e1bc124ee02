#!/usr/bin/env python3
"""GPU smoke run of the PyTorch port (hamer_yolo_tpu_torch) on one NVIDIA card.

    python3 chip_smoke.py

Run from the root of a checkout. It builds the port's CUDA kernels from
csrc/ (one nvcc per source, all at once), checks each of the ten against its
plain PyTorch version on the card, and drives these paths at full width
(YOLOv7 at 640, ViT-H with 32 blocks, the MANO head, 4 hand slots, SAR's
ResNet-34 RootNet at 256; seeded random weights, synthetic MANO, numpy-made
720p frames):

- the exact-bf16 ``infer`` path with RootNet ("sar" in the params, as JAX's
  ``infer`` has it), through the runner and one ``infer_frames`` batch
  (kernels K1, K2); root_depth must be there and finite; the same batch
  with ``use_depth_refine`` (``infer --depth-refine``: cam_t z must equal
  root_depth on every valid slot); the batched runner (``infer --batch 4``:
  serving.BatchedPipeline, no chunk skipped, the per-frame runner's hands
  in its npy files);
- the int8 fast path: the ViT quantized to W8A8, calibrated on the crops of
  the frames (K7), then ``infer_frames`` with the static scales (K3, K4) and
  without them (K5, K7), and both again with ToMe merging 4 tokens a block
  (``--fast-path int8-tome``: the same launches at 192 ... 64 tokens);
- the opt-in kernel paths on the same batch: A, static scales with
  HYT_ATTN=megakernel, HYT_INT8_MLP=megakernel1 and ``fused_mano`` (K6, K10,
  K9); B, no scales with HYT_ATTN=pallas_fusedqkv (K5, K8). Each is held to
  the default int8 path of the same batch;
- the mask-driven path (``infer --mask-dir``: boxes from masks, the detector
  bypassed: K2 only);
- the serving path ("serving"): the runner, the batched runner, the masked
  runner and BatchedPipeline run as captured CUDA graphs, one per bucket
  (pipeline/captured.py). BatchedPipeline at batch 4 (bf16 and int8 static)
  and FrameProgram must equal eager ``infer_frames`` / ``infer_frame`` on
  the same padded inputs bit for bit (or, where two eager runs differ,
  within their spread, printed); ``stream_multi`` over four iterator
  sources at ``detect_every=2`` must follow the keyframe cadence, a tracked
  tick's replay must launch K2's kernels and no K1 (counted by name with
  torch.profiler), a keyframe's both, and the tracked tick must equal eager
  ``infer_frames_tracked`` on the same state; the HTTP server on port 0
  must answer six concurrent POSTs in at most two batches (``decode_image``
  is replaced by np.load of .npy bodies: the script needs no cv2) and shut
  down within a time limit. It prints graph against eager e2e p50 at B = 1,
  4, 16 (bf16, int8 static), the stream_multi ticks' times and each graph's
  memory pool. A captured program's first call of a bucket counts its
  launches twice (the warm-up and the capture), a replay not at all;
- the CLI ("cli"): ``serve --batch 4``, ``serve --multi --detect-every 2``
  and ``serve-http`` through cli.main at full width, with a stand-in for
  cv2 that reads .npy files (the script needs no cv2);
- real weights ("checkpoint"): the full-width seeded weights written in the
  reference's three torch formats, converted (core/convert), saved as a port
  checkpoint and run by ``infer --checkpoint`` through cli.main on 720p
  frames (K1, K2), whose npy files must equal those of the converted tree
  held in memory bit for bit; the seconds of each step are printed;
- the rest of the YOLO family ("YOLO family"): a spec of every deploy op and
  variant at 256-1024 channels with the DET, BIN and KPT heads at 640, a
  P6 yaml dict at 1280, the f32 forward against the CPU's, ``detect
  --augment`` through cli.main and the TTA detector at B = 4, Merge-NMS
  and the keypoint NMS on K1 against the CPU's (K1's keep sets against its
  plain version); the detect stage's ms with and without TTA are printed;
- the bounded graph cache ("graph cache"): each default bucket's graph pool,
  then MAX_GRAPHS + 2 sizes past the largest bucket through one
  FrameProgram: at most MAX_GRAPHS graphs held, the memory of evicted ones
  returned, an evicted key captured again bit-equal to its first capture
  and to eager;
- the RGB-D branch ("rgbd"): KPFusion at the default config (29,375,132
  parameters: two ResNet-18 UNets at 128 x 128, two stages of DESA, BERT
  and the cross decoder over 1,024 points; seeded weights) in RGBDRuntime on
  a numpy-made 1920x1080 RGB-D frame, its forward one captured CUDA graph,
  against the same runtime on the CPU with the same RandomState seed (final
  joints at atol 5e-4, rtol 1e-3; the img2pcl_index and ball-query index
  sets that differ between the two are counted), the graph bit-equal to
  eager, and ``rgbd --kpf-checkpoint`` through cli.main (a KPFusion .pth
  written by torch.save; the cv2 stand-in) printing the runtime's JSON line.
  No TPU kernel lies on this path (plain torch ops, as JAX's are plain
  JAX), so no kernel may launch. It prints the forward's device time by
  graph replay and eager, by part, and the host's pre- and post-processing;
- the int8 detector, the ConvNeXt SAR and the overlays ("int8 detector,
  ConvNeXt SAR, overlays"): ``--int8-yolo 1x1`` and ``all`` (the detector's
  convs W8A8 on torch._int_mm, static scales calibrated on two of the
  phase's 720p frames) through infer_frames with the bf16 ViT (K1, K2) and
  the int8 static ViT (K1, K3, K4), K1's keep sets on their candidates, a
  BatchedPipeline graph against eager; the detect stage's device ms against
  the bf16 trunk at B = 1, 4, 16 and infer_frames at B = 4 with and without
  the 1x1 trunk, in turns; the card against the CPU at 64 (every int8 conv
  bit-equal on the same input, the int8 activations that differ over a
  whole forward counted); SAR with ConvNeXt-base at 256 (its depth stage
  on 16 slots beside ResNet-34's; sar_full_mesh with RootNet's depth and
  with a depth image; card against CPU at 64); two lit MANO hands on a
  720p frame by utils/render.py, card against CPU and timed, and
  ``reconstruct --overlay-images`` through cli.main with the cv2 stand-in.
  No TPU kernel lies on these modules; ``detect --save-img`` draws with
  cv2 and is left to the CPU tests;
- training ("training"): tools/train_hamer at the default HamerConfig
  (ViT-H, the discriminator) at B = 8 for 3 steps with its viz (K2, 32
  launches a forward, under no_grad) and checkpoints, then --resume auto
  for a fourth; YOLOv7's training form at 640, B = 8, three steps (the BN
  stats move, the EMA counts 3); tools/train_kpfusion_rgbd at the default
  KPFusionConfig, B = 4. No train step may launch a kernel. Each model's
  step is timed (CUDA events) with its peak memory and profiled once; one
  f32 step of each, card against CPU (HaMeR at full width with 2 blocks,
  YOLO at 64 px, KPFusion at --tiny), the loss and each gradient held at
  the stated limits; a train state reloaded bit-equal; K2 refusing a token
  tensor that requires grad;
- RGB-D training on data and the point-cloud zoo ("RGB-D training on data
  and the point-cloud zoo"): tools/train_kpfusion_rgbd --data --augment at
  the default KPFusionConfig, B = 4, on 16 numpy-made 1920x1080 samples in
  the fixture layout and on 8 in STB's (--data-format stb), with the
  loader's host ms against the step's; one disk batch's loss and gradients,
  card against CPU; the nine forwards of KeypointFusion's pointNet zoo at
  the published widths, B = 8, card against CPU with the index sets that
  differ counted; the geometry helpers card against CPU. No kernel may
  launch (none lies on this slice);
- YOLO training on data ("YOLO training on data"): tools/train_yolo at full
  width (YOLOv7 at 640, nc 3, B = 16, the default recipe's mosaic, mixup,
  HSV and perspective, SimOTA) on a labelled folder of 32 numpy-made 720p
  frames (.npy bytes under .png names, read by the cv2 stand-in): 4 steps
  with checkpoints, --resume auto for a fifth, detector_map over the 32
  frames (K1 once an image: the kernels line's K1 keeps the bf16 path's
  count under "launches" and gives these beside it under
  "launches_by_path"), --evolve 2 --steps 1; the loader's host ms a batch
  against the step's, the peak memory, SimOTA's step against the neighbor
  assigner's in turns, the eval's images/s.

- deploy ("deploy"): the export tool's ``frame`` (720p, 4 slots, ViT-H with
  32 blocks, YOLOv7 at 640, RootNet) and ``yolo`` programs on the seeded
  weights, traced by torch.export (K1 and K2 the dispatcher's operators of
  ops/torch_ops.py, each against its ctypes wrapper bit for bit; the
  exported graph against eager bit for bit) and compiled by AOTInductor
  (the yolo package in a process of its own beside the frame's); each
  package loaded from Python and held to eager on 720p frames (the same
  number of kept slots, the keep sets matched by box as the folded
  detector's (F3); the fields within check_reference's limits or, as bf16
  forms, as accurate as eager bf16 against an f32 ViT, a hold that must
  report its control, the ViT blocks' weights at 4 significant bits, wrong);
  its device kernels counted by name in a process of its own (K1 once and
  each of K2's kernels 32 times a frame run, no ctypes library loaded);
  the C++ runner built and run one-shot on the yolo package and --serve
  over three 720p PPMs on the frame package, its checksums against
  Python's. It prints the seconds of export, compile, runner build and
  package load, the package bytes, and the p50 of 20 runs of each package
  against eager (the frame also against FrameProgram's graph).

A phase "switches and chain" drives JAX's switches of the kernels at full
width: K3 under HYT_SOFTMAX=exp2 and exp2p, HYT_ATTN_MATH=int8 and int8 with
exp2 through infer_frames (their launches: the kernels line's rows "K3 exp2"
and so on) and alone against each form's plain version, timed; K5's chain
form (JAX's XLA chain above FUSED_GEMM_MAX_M rows) at 12,288 rows for
ViT-H's four GEMMs under both HYT_INT8_EP values against its plain version,
timed beside K5's kernel form; the int8 dynamic infer_frames at 16 frames,
where every K5 call takes the chain (rows "K5 chain", "K5 chain bf16");
HYT_ATTN=auto launching K7 at 64 crops and not at 16.

A phase "ToMe shapes" holds K3, K4, K5 and K7 against their plain versions
at the token counts ToMe gives them (N = 124 and 68 a crop, 16 crops), and
the RootNet stage's time is printed beside the card's name and power limit.

Each path runs with the launch counts set to 0 just before it and read just
after, and fails unless every kernel of the path launched as often as the
path needs; the int8 paths also fail if they make a K-major weight copy
(quantizing on the card makes them all). It then checks the outputs against
the port's CPU path on a small input, and times each path and each kernel
beside its plain version, a PyTorch library call where one computes the same
function, and its bound. A phase "int8 GEMM alone" holds the GEMM launch of
K3-K6 to its plain version bit for bit at ViT-H's four GEMM shapes (M = 3072
and 12288), times it by CUDA graph replay beside torch._int_mm's bare GEMM,
and times the host work a call of the GEMM's two wrappers. A phase "K2
alone" does the same for K2's LN + QKV GEMM launches at the bf16 path's
rows (M = 768, 3072, 12288), beside the library composition
F.layer_norm + torch.addmm (+ scaled_dot_product_attention for all of K2),
timed for reference only. A phase "K10 alone" holds K10 to K4 bit for bit
at ViT-H's MLP for those rows (both GELUs, bf16 and f32 tokens) and times
both by CUDA graph replay, with TOP/s and the share of K10's bound. K1 is
held to its plain version on random, on-threshold and ragged boxes, K = 1024
and 2048, its worst case, all inactive, a negative threshold and the
detector's candidates at B = 4 and 16, and timed by CUDA graph replay at
(4, 512) and (16, 512) beside the launch floor of an empty kernel. K9 must
make exactly one device launch a call. The bf16 path fails if a ViT forward
after the first casts a weight to bf16. The reference checks hold RootNet
in f32 at the JAX package's composed-oracle limit and, in bf16, to the bf16
trunk's own noise floor (cuDNN sums its convolutions in its own order). They
hold the int8 ViT with ToMe on the card to the CPU's on the card's merge
choices (a merge is an argmax, which an int8 flip can move), and print how
many choices the CPU would have made otherwise.

The last line of stdout is {"ok": true, "device": {...}}; the line before it
is the kernels' JSON record. Any failed phase raises and the script exits
non-zero. Without a CUDA device, or without the package beside it, it exits
non-zero before printing anything.
"""
import contextlib
import dataclasses
import json
import os
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor
from types import SimpleNamespace

import numpy as np

KERNELS = {
    "K1": {"name": "greedy_nms_keep", "route": "cuda",
           "source": "hamer_yolo_tpu_torch/csrc/nms.cu",
           "replaces": "hamer_yolo_tpu/ops/nms_pallas.py:62"},
    "K2": {"name": "fused_bf16_attn_block", "route": "cuda",
           "source": "hamer_yolo_tpu_torch/csrc/attn_block.cu, "
                     "hamer_yolo_tpu_torch/csrc/short_attention.cu",
           "replaces": "hamer_yolo_tpu/ops/attention_pallas.py:255"},
    "K3": {"name": "fused_int8_attn_proj_block", "route": "cuda",
           "source": "hamer_yolo_tpu_torch/csrc/int8_gemm.cu, "
                     "hamer_yolo_tpu_torch/csrc/short_attention.cu",
           "replaces": "hamer_yolo_tpu/ops/attention_pallas.py:543"},
    "K4": {"name": "fused_int8_mlp_block", "route": "cuda",
           "source": "hamer_yolo_tpu_torch/csrc/int8_gemm.cu",
           "replaces": "hamer_yolo_tpu/ops/int8_matmul.py:286"},
    "K5": {"name": "fused_int8_matmul", "route": "cuda",
           "source": "hamer_yolo_tpu_torch/csrc/int8_gemm.cu",
           "replaces": "hamer_yolo_tpu/ops/int8_matmul.py:589"},
    "K6": {"name": "fused_int8_attn_block", "route": "cuda",
           "source": "hamer_yolo_tpu_torch/csrc/int8_gemm.cu, "
                     "hamer_yolo_tpu_torch/csrc/short_attention.cu",
           "replaces": "hamer_yolo_tpu/ops/attention_pallas.py:353"},
    "K7": {"name": "fused_short_attention", "route": "cuda",
           "source": "hamer_yolo_tpu_torch/csrc/short_attention.cu",
           "replaces": "hamer_yolo_tpu/ops/attention_pallas.py:94"},
    "K8": {"name": "fused_qkv_attention", "route": "cuda",
           "source": "hamer_yolo_tpu_torch/csrc/short_attention.cu",
           "replaces": "hamer_yolo_tpu/ops/attention_pallas.py:173"},
    "K9": {"name": "mano_lbs_fused", "route": "cuda",
           "source": "hamer_yolo_tpu_torch/csrc/mano_lbs.cu",
           "replaces": "hamer_yolo_tpu/ops/mano_pallas.py:76"},
    "K10": {"name": "fused_int8_mlp_block1", "route": "cuda",
            "source": "hamer_yolo_tpu_torch/csrc/int8_gemm.cu",
            "replaces": "hamer_yolo_tpu/ops/int8_matmul.py:408"},
}
# The switched forms of K3 and K5 (phase "switches and chain"), each a row of
# the kernels line beside the default form's.
for _form, _env in (("exp2", "HYT_SOFTMAX=exp2"), ("exp2p", "HYT_SOFTMAX=exp2p"),
                    ("int8", "HYT_ATTN_MATH=int8"),
                    ("int8 exp2", "HYT_ATTN_MATH=int8 HYT_SOFTMAX=exp2")):
    KERNELS[f"K3 {_form}"] = {
        "name": f"fused_int8_attn_proj_block ({_env})", "route": "cuda",
        "source": "hamer_yolo_tpu_torch/csrc/int8_gemm.cu, "
                  "hamer_yolo_tpu_torch/csrc/attention_flavours.cu",
        "replaces": "hamer_yolo_tpu/ops/attention_pallas.py:543"}
for _form, _env in (("chain", "chain form, above 8192 rows"),
                    ("chain bf16", "chain form, above 8192 rows, HYT_INT8_EP=bf16")):
    KERNELS[f"K5 {_form}"] = {
        "name": f"fused_int8_matmul ({_env})", "route": "cuda",
        "source": "hamer_yolo_tpu_torch/csrc/int8_gemm.cu",
        "replaces": "hamer_yolo_tpu/ops/int8_matmul.py:589"}
# The switches of the two opt-in paths (core/quant.py reads them per call).
PATH_A_ENV = {"HYT_ATTN": "megakernel", "HYT_INT8_MLP": "megakernel1"}
PATH_B_ENV = {"HYT_ATTN": "pallas_fusedqkv"}
# Paths A and B against the default int8 path of the same batch: K10 equals
# K4 and K8 equals K7 bit for bit, K6 + the pre-quantized proj product is
# K3's arithmetic, and K9 differs from the einsum LBS by f32 sum order, so the
# joints should agree to far less than this.
MAX_OPTIN_JOINT_DIST_MM = 0.1
# f32 attention against its plain version: f32 products and sums of 80 and
# 192 terms in another order, outputs of magnitude <= 1.
F32_ATTN_ATOL = 2e-5
INT8_KERNELS = ("K3", "K4", "K5", "K6", "K7", "K8", "K10")
# ViT-H's int8 GEMMs, (K, N): the attention's qkv and proj, the MLP's fc1 and
# fc2; and the rows of 16 and 64 crops of 192 tokens
VITH_GEMMS = {"qkv": (1280, 3840), "proj": (1280, 1280), "fc1": (1280, 5120), "fc2": (5120, 1280)}
GEMM_ROWS = (3072, 12288)
# K2's rows on the bf16 path: 1, 4 and 16 frames of 4 crops of 192 tokens
K2_ROWS = (768, 3072, 12288)
# K10's rows: the same 1, 4 and 16 frames, on path A
K10_ROWS = K2_ROWS
# K1's frame batches: the main path's and 16
K1_BATCHES = (4, 16)
SEED = 0
TOME_R = 4            # --tome-r: tokens merged per ViT block (192 -> 64 over 32 blocks)
BF16_ACCURACY_FACTOR = 2.0  # bf16 RootNet: |card - CPU f32| <= this x |CPU bf16 - CPU f32|

TOME_N = (124, 68)    # ToMe token counts held against the plain versions: blocks 17 and 31
N_FRAMES = 3          # frames through the runner (FrameProgram)
# A captured program's first call of a bucket runs its function twice, the
# warm-up and the capture, and its launch counters count both; a replay
# launches its kernels without passing the wrappers (pipeline/captured.py).
CAPTURE_RUNS = 2
BATCH = 4             # frames in the infer_frames batch
TIMED_ITERS = 10
AXIS_ANGLE_KEYS = ("theta", "pose_hand", "pose_global")
# Peaks of one H100 SXM (NVIDIA's data sheet, dense, at 700 W): bytes/s of
# HBM3, operations/s of the tensor cores in bf16 and int8, f32 outside them.
HBM_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = {"bf16": 989e12, "int8": 1979e12, "f32": 67e12}


def cuda_time_ms(fn, iters=TIMED_ITERS, warmup=2):
    """Median device time of fn() in ms, CUDA events around each call."""
    import torch

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


def graph_time_ms(fn, reps=20, iters=10):
    """Median device time of fn() in ms with no host work in between: reps
    calls captured once in a CUDA graph, CUDA events around each replay."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    times = []
    for _ in range(iters):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end) / reps)
    return float(np.median(times))


def bound(nbytes, ops):
    """The least time the card could take: (ms, "bytes" or "operations"),
    bytes over the HBM rate against the operations of each type over its
    peak."""
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = sum(n / PEAK_OPS_PER_S[kind] for kind, n in ops.items())
    return (t_bytes * 1e3, "bytes") if t_bytes >= t_ops else (t_ops * 1e3, "operations")


def frames_720p(n, seed):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 256, (720, 1280, 3), dtype=np.uint8) for _ in range(n)]


@contextlib.contextmanager
def switches(env):
    """The environment switches ``env`` set for the block, then restored."""
    old = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    try:
        yield
    finally:
        for k, v in old.items():
            if v is None:
                del os.environ[k]
            else:
                os.environ[k] = v


def launch_counters():
    from hamer_yolo_tpu_torch.ops.attn_block import fused_bf16_attn_block
    from hamer_yolo_tpu_torch.ops.attn_block_int8 import fused_int8_attn_block
    from hamer_yolo_tpu_torch.ops.attn_proj_block import fused_int8_attn_proj_block
    from hamer_yolo_tpu_torch.ops.int8_matmul import (fused_int8_matmul, fused_int8_mlp_block,
                                                      fused_int8_mlp_block1)
    from hamer_yolo_tpu_torch.ops.mano_lbs import mano_lbs_fused
    from hamer_yolo_tpu_torch.ops.nms import greedy_nms_keep
    from hamer_yolo_tpu_torch.ops.short_attention import fused_qkv_attention, fused_short_attention

    return {"K1": greedy_nms_keep, "K2": fused_bf16_attn_block, "K3": fused_int8_attn_proj_block,
            "K4": fused_int8_mlp_block, "K5": fused_int8_matmul, "K6": fused_int8_attn_block,
            "K7": fused_short_attention, "K8": fused_qkv_attention, "K9": mano_lbs_fused,
            "K10": fused_int8_mlp_block1}


def run_counted(fn):
    """fn() with every launch count set to 0 just before and read just after;
    a wrapper's switched forms that launched (its ``variant_launches``) under
    "K3 exp2" and the like."""
    import torch

    counters = launch_counters()
    for f in counters.values():
        f.launches = 0
        getattr(f, "variant_launches", {}).clear()
    out = fn()
    torch.cuda.synchronize()
    n = {k: f.launches for k, f in counters.items()}
    for k, f in counters.items():
        n.update({f"{k} {form}": c for form, c in getattr(f, "variant_launches", {}).items()})
    return out, n


def expect_launches(what, got, want):
    if any(got.get(k, 0) != n for k, n in want.items()):
        raise RuntimeError(f"{what}: launches {got}, expected {want}")


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    from hamer_yolo_tpu_torch.cli.main import apply_fast_path, pipeline_config
    from hamer_yolo_tpu_torch.core import nn
    from hamer_yolo_tpu_torch.core.checkpoint import init_pipeline_params
    from hamer_yolo_tpu_torch.core.mano_assets import synthetic_mano_model
    from hamer_yolo_tpu_torch.core.quant import attach_static_act_scales
    from hamer_yolo_tpu_torch.geometry.boxes import hamer_box_params
    from hamer_yolo_tpu_torch.models.hamer import hamer_forward
    from hamer_yolo_tpu_torch.models.mano import ManoModel
    from hamer_yolo_tpu_torch.models.vit import embed_tokens
    from hamer_yolo_tpu_torch.io.writers import frame_outputs_to_hand_dicts
    from hamer_yolo_tpu_torch.ops import cuda_build, torch_ops
    from hamer_yolo_tpu_torch.ops.int8_matmul import kmajor_weight
    from hamer_yolo_tpu_torch.pipeline.frame import (detect_hands_batched, estimate_depths,
                                                     infer_frames)
    from hamer_yolo_tpu_torch.pipeline.preprocess import hamer_crop
    from hamer_yolo_tpu_torch.pipeline.runner import (FrameProgram, default_intrinsics,
                                                      process_frames, process_frames_batched)
    from hamer_yolo_tpu_torch.pipeline.serving import BatchedPipeline
    from hamer_yolo_tpu_torch.tools.calibrate_int8 import calibrate_frames

    t_start = time.perf_counter()
    dev = torch.device("cuda:0")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader",
                          "--id=0"], capture_output=True, text=True, check=True).stdout.strip()
    print(smi)  # the card's name and power limit, as nvidia-smi gives them
    print(f"torch {torch.__version__} cuda {torch.version.cuda} device "
          f"{torch.cuda.get_device_name(0)}", flush=True)

    # -- build ---------------------------------------------------------------
    t0 = time.perf_counter()
    with ThreadPoolExecutor(2) as pool:  # the operator library (g++) beside the kernels (nvcc)
        ops_lib = pool.submit(torch_ops.build)
        libs = cuda_build.build_all() + [ops_lib.result()]
    torch_ops.register()
    print(f"build: {time.perf_counter() - t0:.1f} s -> {', '.join(p.name for p in libs)}; "
          "nvcc per source and g++ for the operator library, all at once: "
          + ", ".join(f"{k} {v:.1f} s" for k, v in cuda_build.BUILD_SECONDS.items()), flush=True)

    # -- full-width setup ----------------------------------------------------
    cfg = pipeline_config(tiny=False)
    t0 = time.perf_counter()
    mano = ManoModel.from_arrays(synthetic_mano_model(SEED), dev)
    params = init_pipeline_params(SEED, mano, cfg.yolo, cfg.hamer, cfg.sar, device=dev)
    torch.cuda.synchronize()
    depth = cfg.hamer.vit.depth
    print(f"init: full-width params in {time.perf_counter() - t0:.1f} s "
          f"(vit depth {depth}, embed {cfg.hamer.vit.embed_dim}, det {cfg.det_size}, "
          f"slots {cfg.max_hands}; SAR {cfg.sar.backbone} at {cfg.sar.input_size})")
    frames = frames_720p(max(N_FRAMES, BATCH), SEED)
    K = default_intrinsics(frames[0].shape)
    imgs = torch.from_numpy(np.stack(frames[:BATCH])).to(dev).to(torch.float32)
    hws = torch.tensor([[720.0, 1280.0]] * BATCH, device=dev)
    Ks = torch.from_numpy(np.stack([K] * BATCH)).to(dev)
    launches = {}

    # -- path 1, exact bf16: runner (npy + OBJ) and one infer_frames batch ---
    def bf16_path():
        with tempfile.TemporaryDirectory() as out_dir, torch.inference_mode():
            program = FrameProgram(params, mano, cfg, dev)
            stats = process_frames(((f"frame{i}", f) for i, f in enumerate(frames[:N_FRAMES])),
                                   out_dir, program, K=K, progress=False)
            batch_out = infer_frames(params, mano, imgs, hws, Ks, cfg)
            npys = read_npys(out_dir)
            objs = sorted(os.listdir(os.path.join(out_dir, "obj")))
        return program, stats, batch_out, npys, objs

    (program, stats, batch_out, npys, objs), n = run_counted(bf16_path)
    launches.update(K1=n["K1"], K2=n["K2"])
    vit_forwards = CAPTURE_RUNS + 1  # the runner's one bucket, then the infer_frames batch
    print(f"bf16 path: {stats.frames} frames, {stats.hands} hands via the runner (captured, "
          f"{len(program.program.pool_bytes)} graph) -> "
          f"{len(npys)} npy, {len(objs)} obj; infer_frames batch {BATCH} -> "
          f"{int(batch_out['valid'].sum())} valid slots; launches {n}")
    if len(npys) != N_FRAMES or not objs:
        raise RuntimeError(f"runner wrote {len(npys)} npy and {len(objs)} obj files")
    if n["K1"] < vit_forwards:
        raise RuntimeError(f"K1 launched {n['K1']} times for {vit_forwards} detector calls")
    expect_launches("bf16 path", n, {"K2": depth * vit_forwards,
                                     **dict.fromkeys(INT8_KERNELS + ("K9",), 0)})
    check_batch(batch_out, cfg, "bf16 infer_frames")
    v = batch_out["valid"]
    print(f"bf16 path: RootNet root_depth on the {int(v.sum())} valid slots: "
          f"{float(batch_out['root_depth'][v].min()):.4g}..{float(batch_out['root_depth'][v].max()):.4g}"
          " (random weights), all finite")

    # -- the same batch with --depth-refine: tz is RootNet's depth ----------
    rcfg = dataclasses.replace(cfg, use_depth_refine=True)
    with torch.inference_mode():
        ref_out, n = run_counted(lambda: infer_frames(params, mano, imgs, hws, Ks, rcfg))
    check_batch(ref_out, cfg, "bf16 depth-refine infer_frames")
    expect_launches("bf16 depth-refine", n, {"K1": 1, "K2": depth,
                                             **dict.fromkeys(INT8_KERNELS + ("K9",), 0)})
    v = ref_out["valid"]
    if not torch.equal(ref_out["cam_t"][..., 2][v], ref_out["root_depth"][v]):
        raise RuntimeError("depth-refine: cam_t z is not RootNet's depth on every valid slot")
    print(f"bf16 depth-refine batch {BATCH}: cam_t z equals root_depth on all {int(v.sum())} "
          f"valid slots; launches {n}")

    # -- the batched runner (serving.BatchedPipeline) at batch BATCH ---------
    def batched_runner():
        with tempfile.TemporaryDirectory() as out_dir, torch.inference_mode():
            pipe = BatchedPipeline(params, mano, cfg, batch_size=BATCH, device=dev)
            st = process_frames_batched(((f"frame{i}", f) for i, f in enumerate(frames[:BATCH])),
                                        out_dir, pipe, K=K, progress=False)
            return st, read_npys(out_dir)

    (bstats, bnpys), n = run_counted(batched_runner)
    print(f"batched runner (BatchedPipeline, batch {BATCH}): {bstats.frames} frames, "
          f"{bstats.hands} hands, {bstats.skipped} skipped; launches {n}")
    if bstats.skipped or bstats.frames != BATCH:
        raise RuntimeError(f"batched runner: {bstats}")
    expect_launches("batched runner", n, {"K1": CAPTURE_RUNS, "K2": CAPTURE_RUNS * depth,
                                          **dict.fromkeys(INT8_KERNELS + ("K9",), 0)})
    # the same program, captured, on the same 4 frames as the bf16 path's
    # eager infer_frames batch: its files hold that batch's outputs bit for bit
    compare_npys(bnpys, {f"frame{i}.npy": frame_outputs_to_hand_dicts(
        {k: v[i].cpu().numpy() for k, v in batch_out.items()}) for i in range(BATCH)},
        "batched runner vs the infer_frames batch", tol=0.0)
    # the per-frame runner runs batch 1, where cuBLAS and cuDNN take other
    # kernels: the same hands, the differences printed (ROADMAP F4, F12)
    compare_npys(bnpys, npys, "batched runner vs the per-frame runner", tol=None)
    casts_before = nn.cast_weight.casts
    with torch.inference_mode():
        infer_frames(params, mano, imgs, hws, Ks, cfg)
    torch.cuda.synchronize()
    casts = nn.cast_weight.casts - casts_before
    print(f"bf16 path: weight casts to bf16 in a forward after the first: {casts} "
          f"({casts_before} in all before it)")
    if casts:
        raise RuntimeError(f"the bf16 path cast {casts} weights in a forward after the first")

    # -- path 2, int8: calibrate, then static and dynamic infer_frames -------
    qparams, qcfg = apply_fast_path(params, cfg, "int8")
    (calib, n_crops), n = run_counted(lambda: calibrate_frames(params, frames[:BATCH], cfg, dev,
                                                               batch=16))
    print(f"int8 calibration on {n_crops} crops of {BATCH} frames: launches {n}")
    if calib is None or n["K7"] < depth or n["K7"] % depth:
        raise RuntimeError(f"calibration ran K7 {n['K7']} times over {n_crops} crops")
    sparams = {**qparams, "hamer": {**qparams["hamer"], "backbone": attach_static_act_scales(
        qparams["hamer"]["backbone"], calib)}}
    # the opt-in paths: the same batch under their switches, A with the fused LBS
    acfg = dataclasses.replace(qcfg, hamer=dataclasses.replace(qcfg.hamer, fused_mano=True))
    # name: (params, config, switches, launches per ViT forward and HaMeR forward)
    # --fast-path int8-tome: ToMe (4 tokens merged a block) over the int8 ViT
    tcfg = dataclasses.replace(qcfg, hamer=dataclasses.replace(qcfg.hamer, tome_r=TOME_R))
    int8_runs = {"static": (sparams, qcfg, {}, {"K3": depth, "K4": depth}),
                 "dynamic": (qparams, qcfg, {}, {"K5": 4 * depth, "K7": depth}),
                 "path A": (sparams, acfg, PATH_A_ENV, {"K6": depth, "K10": depth, "K9": 1}),
                 "path B": (qparams, qcfg, PATH_B_ENV, {"K5": 4 * depth, "K8": depth}),
                 "tome static": (sparams, tcfg, {}, {"K3": depth, "K4": depth}),
                 "tome dynamic": (qparams, tcfg, {}, {"K5": 4 * depth, "K7": depth})}
    int8_out = {}
    for name, (p, c, env, want) in int8_runs.items():
        kmajor_weight.transposes = 0
        with torch.inference_mode(), switches(env):
            out, n = run_counted(lambda: infer_frames(p, mano, imgs, hws, Ks, c))
        print(f"int8 {name} infer_frames batch {BATCH} {env}: {int(out['valid'].sum())} valid "
              f"slots, launches per ViT forward {n}; K-major weight copies made "
              f"{kmajor_weight.transposes}")
        expect_launches(f"int8 {name}", n, {**dict.fromkeys(("K2", "K9") + INT8_KERNELS, 0),
                                             **want})
        if kmajor_weight.transposes:
            raise RuntimeError(f"int8 {name}: the forward made {kmajor_weight.transposes} "
                               "K-major weight copies (the set-up makes them all)")
        check_batch(out, cfg, f"int8 {name} infer_frames")
        int8_out[name] = out
        for k in want:
            launches.setdefault(k, n[k])

    def joint_dist_mm(a, b):
        both = a["valid"] & b["valid"]
        return float((a["keypoints_3d"] - b["keypoints_3d"]).norm(dim=-1)[both].mean()) * 1e3

    print(f"int8 static vs bf16 on the same batch: mean joint distance "
          f"{joint_dist_mm(int8_out['static'], batch_out):.3f} mm (random weights)")
    for name, base in (("path A", "static"), ("path B", "dynamic")):
        d = joint_dist_mm(int8_out[name], int8_out[base])
        dv = float((int8_out[name]["vertices"] - int8_out[base]["vertices"]).abs().max()) * 1e3
        print(f"int8 {name} vs the default int8 {base} path on the same batch: mean joint "
              f"distance {d:.6f} mm, max vertex coordinate difference {dv:.6f} mm (limit "
              f"{MAX_OPTIN_JOINT_DIST_MM} mm)")
        if not torch.equal(int8_out[name]["valid"], int8_out[base]["valid"]) or not (
                d <= MAX_OPTIN_JOINT_DIST_MM):
            raise RuntimeError(f"int8 {name} departs from the default int8 {base} path")

    # -- the mask-driven path: boxes from masks, the detector bypassed -------
    mstats, mout, n = masked_path(params, mano, cfg, dev, frames[:N_FRAMES], K)
    print(f"masked path: {mstats.frames} frames, {mstats.hands} hands, {mstats.skipped} skipped; "
          f"launches {n}; root_depth of the mask's hand {float(mout['root_depth'][0]):.4g}")
    expect_launches("masked path", n, {"K1": 0, "K2": CAPTURE_RUNS * depth,
                                       **dict.fromkeys(INT8_KERNELS + ("K9",), 0)})

    # -- the main path's own kernel inputs -----------------------------------
    cands = {B: detector_candidates(params["yolo"], cfg, dev, B) for B in K1_BATCHES}
    with torch.inference_mode():
        dets = detect_hands_batched(params["yolo"], imgs, hws, cfg)
        center, size = hamer_box_params(dets["boxes"])
        crops = hamer_crop(imgs, center, size, 1.0 - dets["is_right"], cfg.crop_size)
        crops = crops.reshape(-1, *crops.shape[2:])
        m = cfg.hamer.crop_margin
        tok0 = embed_tokens(params["hamer"]["backbone"], crops[:, :, m:-m, :], cfg.hamer.vit)
    record = {}
    record["K1"] = check_k1(cands, cfg)
    record["K2"] = check_k2(params["hamer"]["backbone"]["blocks"][0], tok0, cfg.hamer.vit.num_heads)
    sblk = sparams["hamer"]["backbone"]["blocks"][0]
    record.update(check_int8_kernels(sblk, tok0, cfg.hamer.vit.num_heads))
    with torch.inference_mode():
        pred_mano = hamer_forward(sparams["hamer"], mano, crops, qcfg.hamer)["pred_mano_params"]
    record.update(check_optin_kernels(sblk, tok0, cfg.hamer.vit.num_heads, mano, pred_mano,
                                      record["K3"]["ms"], record["K4"]["ms"], record["K7"]["ms"]))
    check_tome_shapes(sblk, cfg.hamer.vit.num_heads, dev)
    int8_gemm_alone(dev)
    blk0 = params["hamer"]["backbone"]["blocks"][0]
    wrapper_host_us(dev, k1=(cands[BATCH].shifted, cands[BATCH].active, cfg.iou_thres),
                    k2=(tok0, blk0["attn"]["qkv"]["w"], blk0["attn"]["qkv"]["b"],
                        blk0["norm1"]["scale"], blk0["norm1"]["bias"], cfg.hamer.vit.num_heads))
    k2_alone(dev)
    k10_alone(dev)
    forms, form_launches = switches_chain_phase(dev, smi, sparams, qparams, qcfg, mano, cfg, imgs,
                                                hws, Ks, tok0, int8_out["static"], depth)
    record.update(forms)
    launches.update(form_launches)

    # -- end to end timing ---------------------------------------------------
    with torch.inference_mode():
        depth_ms = cuda_time_ms(lambda: estimate_depths(params["sar"], imgs, dets, hws, Ks, cfg),
                                iters=5)
        no_sar = {k: v for k, v in params.items() if k != "sar"}
        no_sar_ms = cuda_time_ms(lambda: infer_frames(no_sar, mano, imgs, hws, Ks, cfg), iters=5)
        batch_ms = cuda_time_ms(lambda: infer_frames(params, mano, imgs, hws, Ks, cfg), iters=5)
        int8_ms = {}
        for name, (p, c, env, _) in int8_runs.items():
            with switches(env):
                int8_ms[name] = cuda_time_ms(lambda: infer_frames(p, mano, imgs, hws, Ks, c),
                                             iters=5)
    single = interleaved_p50({"graph": lambda: program(frames[0], K),
                              "eager": lambda: eager_frame(params, mano, cfg, dev, frames[0], K)},
                             rounds=3)
    print(f"RootNet stage (estimate_depths: {BATCH * cfg.max_hands} SAR patches of "
          f"{cfg.sar.input_size}x{cfg.sar.input_size}, ResNet-34 in {cfg.sar.compute_dtype}) at "
          f"b{BATCH}: p50 {depth_ms:.3f} ms on {smi} (CUDA events, 2 warm-up, 5 timed)")
    print(f"e2e infer_frames b{BATCH} 720p, exact bf16: p50 {batch_ms:.2f} ms = "
          f"{BATCH / batch_ms * 1e3:.2f} frames/s (CUDA events, 2 warm-up, 5 timed); "
          f"without \"sar\" in the params (no RootNet) {no_sar_ms:.2f} ms")
    for name, ms in int8_ms.items():
        print(f"e2e infer_frames b{BATCH} 720p, int8 {name}: p50 {ms:.2f} ms = "
              f"{BATCH / ms * 1e3:.2f} frames/s (CUDA events, 2 warm-up, 5 timed)")
    print(f"e2e FrameProgram single 720p frame incl. upload and copy back: p50 "
          f"{single['graph']:.2f} ms by its captured graph, {single['eager']:.2f} ms eager "
          "(host clock, in turns graph, eager, eager, graph; 1 warm-up, 6 timed each)")

    # -- serving: captured programs, stream_multi, the HTTP server ----------
    serving_phase(params, sparams, qcfg, mano, cfg, dev, smi)
    cli_phase(dev, depth)

    # -- real-weight plumbing, the YOLO family, the bounded graph cache -----
    checkpoint_phase(dev, cfg, depth, smi)
    family_phase(params, mano, cfg, dev, depth, smi)
    graph_cache_phase(params, mano, cfg, dev, smi)
    rgbd_phase(dev, smi)
    int8_sar_overlay_phase(params, sparams, qcfg, mano, cfg, dev, depth, smi)
    training_phase(dev, smi)
    eval_k1 = yolo_data_phase(dev, smi)
    rgbd_data_zoo_phase(dev, smi)
    library = library_phase(dev, smi, params, mano, cfg, frames, K, depth)
    deploy = deploy_phase(dev, smi, params, mano, cfg, program, tok0[:cfg.max_hands], depth)
    # "launches" stays the bf16 path's own count; detector_map's K1 launches and
    # the library phase's paths, each from a run of its own, go beside it
    launches_by_path = {"K1": {"infer (bf16 path)": launches["K1"], "detector_map": eval_k1}}
    for part in (library, deploy):
        for k, paths in part.items():
            launches_by_path.setdefault(k, {}).update(paths)

    # -- reference checks on a small input: the card against the CPU path ----
    check_reference(dev)
    check_reference_int8(dev)

    print(f"chip_smoke: {time.perf_counter() - t_start:.1f} s in all, the build included")
    print(json.dumps({"kernels": [dict(KERNELS[k], launches=launches[k], **record[k],
                                       **({"launches_by_path": launches_by_path[k]}
                                          if k in launches_by_path else {}))
                                  for k in KERNELS]}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


def check_batch(out, cfg, what, frames=BATCH):
    """Finite outputs of the batch's shapes (``frames`` frames, every slot,
    masked ones too), RootNet's root_depth among them, and a valid slot."""
    import torch

    if "root_depth" not in out:
        raise RuntimeError(f"{what}: no root_depth with \"sar\" in the params")
    for k, v in out.items():
        if v.is_floating_point() and not torch.isfinite(v).all():
            raise RuntimeError(f"{what}: output {k} is not finite")
    if out["vertices"].shape != (frames, cfg.max_hands, 778, 3):
        raise RuntimeError(f"{what}: vertices shape {tuple(out['vertices'].shape)}")
    if not out["valid"].any():
        raise RuntimeError(f"{what}: no valid hand slot")


def interleaved_p50(fns, rounds=3, warmup=1):
    """Host-clock p50 in ms of each fn() (each ends in a copy to the host),
    after ``warmup`` calls each, in turns a, b, ..., b, a for ``rounds``."""
    import torch

    for fn in fns.values():
        for _ in range(warmup):
            fn()
    times = {k: [] for k in fns}
    for _ in range(rounds):
        for k in list(fns) + list(fns)[::-1]:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fns[k]()
            times[k].append((time.perf_counter() - t0) * 1e3)
    return {k: float(np.median(v)) for k, v in times.items()}


def eager_frame(params, mano, cfg, dev, frame, K):
    """FrameProgram's work without its graph: pad, upload, infer_frame, copy back."""
    import torch

    from hamer_yolo_tpu_torch.pipeline.frame import infer_frame
    from hamer_yolo_tpu_torch.pipeline.runner import _bucket_pad

    padded, hw = _bucket_pad(frame)
    with torch.inference_mode():
        out = infer_frame(params, mano, torch.from_numpy(padded).to(dev).to(torch.float32),
                          torch.from_numpy(hw).to(dev),
                          torch.from_numpy(np.asarray(K, np.float32)).to(dev), cfg)
    return {k: v.cpu().numpy() for k, v in out.items()}


def eager_batch(pipe, frames, K, state=None):
    """BatchedPipeline's work without its graphs: pad, upload, infer_frames
    (or infer_frames_tracked on ``state``, the previous tick's stacked
    outputs), copy back."""
    import torch

    from hamer_yolo_tpu_torch.pipeline.frame import infer_frames, infer_frames_tracked

    images, hws, Ks = pipe._pad_frames(frames, K)
    dev = pipe.device
    t = (lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev))  # noqa: E731
    with torch.inference_mode():
        if state is None:
            out = infer_frames(pipe.params, pipe.mano_model, t(images).to(torch.float32), t(hws),
                               t(Ks), pipe.cfg)
        else:
            out = infer_frames_tracked(pipe.params, pipe.mano_model, t(images).to(torch.float32),
                                       t(state["keypoints_2d"]), t(state["is_right"]),
                                       t(state["valid"]), t(hws), t(Ks), pipe.cfg,
                                       track_expand=pipe.track_expand)
    return {k: v[:len(frames)].cpu().numpy() for k, v in out.items()}


def _max_diff(a, b):
    if a.dtype == bool:
        return float(np.count_nonzero(a != b))
    return float(np.abs(a.astype(np.float64) - b.astype(np.float64)).max())


def hold_to_eager(got, eager, eager_again, what):
    """The captured program's outputs ``got`` equal to the eager ones bit for
    bit, or, for an output where two eager runs differ, within that spread
    (printed with the output's name)."""
    if set(got) != set(eager):
        raise RuntimeError(f"{what}: outputs {sorted(got)} against eager {sorted(eager)}")
    spread = {k: _max_diff(eager[k], eager_again[k]) for k in eager}
    diff = {k: _max_diff(got[k], eager[k]) for k in eager}
    noisy = {k: v for k, v in spread.items() if v}
    if noisy:
        print(f"{what}: two eager runs differ in {noisy} (the graph is held to that spread)")
    bad = {k: d for k, d in diff.items() if d > spread[k]}
    if bad:
        raise RuntimeError(f"{what}: the captured graph departs from eager: {bad}")
    same = [k for k, d in diff.items() if d == 0]
    print(f"{what}: captured graph against eager: {len(same)} of {len(diff)} outputs bit for "
          f"bit{'' if len(same) == len(diff) else ', the rest within the eager spread'}")


# The device kernels of K1 and of K2's three launches, counted by name in a
# profile of a graph replay (a replay does not pass the launch counters).
K1_KERNEL = "nms_keep_kernel"
K2_KERNELS = ("ln_rows_kernel", "qkv_gemm_kernel", "attention_bf16_kernel")


def kernels_by_name(fn, again=None, tries=3):
    """(fn(), {device kernel name: launches}) from torch.profiler. Now and
    then a session records no device activity at all; then ``again()``, a
    replay of the same graph on the same inputs, is profiled instead, up to
    ``tries`` sessions in all."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    out, counts = None, {}
    for i in range(tries):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            res = fn() if i == 0 else again()
            torch.cuda.synchronize()
        out = res if i == 0 else out
        for ev in prof.events():
            if ev.device_type == torch.autograd.DeviceType.CUDA:
                counts[ev.name] = counts.get(ev.name, 0) + 1
        if counts or again is None:
            break
    return out, counts


def named(counts, part):
    return sum(c for name, c in counts.items() if part in name)


def expect_replay(what, counts, k1, depth):
    """A replay's profile: ``k1`` K1 launches, each of K2's kernels once a
    ViT block."""
    got = {"K1": named(counts, K1_KERNEL), **{n: named(counts, n) for n in K2_KERNELS}}
    want = {"K1": k1, **dict.fromkeys(K2_KERNELS, depth)}
    print(f"{what}: device kernels by name in one replay: {got} of {sum(counts.values())} "
          "launches in all")
    if got != want:
        raise RuntimeError(f"{what}: a replay launched {got}, expected {want}")


def serving_phase(params, sparams, qcfg, mano, cfg, dev, smi):
    """The serving path at full width on the captured programs: (a) graphs
    against eager, bit for bit; (b) stream_multi with tracking; (c) the
    HTTP server; (d) graph against eager times and each graph's pool."""
    import torch

    from hamer_yolo_tpu_torch.pipeline.runner import FrameProgram, default_intrinsics
    from hamer_yolo_tpu_torch.pipeline.serving import BatchedPipeline

    depth = cfg.hamer.vit.depth
    frames = frames_720p(16, SEED + 1)
    K = default_intrinsics(frames[0].shape)
    none = dict.fromkeys(KERNELS, 0)
    pools = {}

    # (a) BatchedPipeline (bf16, int8 static) and FrameProgram against eager
    runs = (("bf16", params, cfg, {"K1": CAPTURE_RUNS, "K2": CAPTURE_RUNS * depth}),
            ("int8 static", sparams, qcfg, {"K1": CAPTURE_RUNS, "K3": CAPTURE_RUNS * depth,
                                            "K4": CAPTURE_RUNS * depth}))
    for name, p, c, want in runs:
        pipe = BatchedPipeline(p, mano, c, batch_size=BATCH, device=dev)
        got, n = run_counted(lambda: pipe.process_batch(frames[:BATCH], K))
        expect_launches(f"serving: BatchedPipeline {name} capture", n, {**none, **want})
        hold_to_eager(got, eager_batch(pipe, frames[:BATCH], K),
                      eager_batch(pipe, frames[:BATCH], K), f"serving: BatchedPipeline b{BATCH} {name}")
        again, counts = kernels_by_name(lambda: pipe.process_batch(frames[:BATCH], K),
                                        lambda: pipe.process_batch(frames[:BATCH], K))
        hold_to_eager(again, got, got, f"serving: BatchedPipeline b{BATCH} {name}, a replay")
        if name == "bf16":
            expect_replay(f"serving: BatchedPipeline b{BATCH} bf16", counts, 1, depth)
        pools[f"BatchedPipeline {name} b{BATCH}"] = pipe.programs["detect"].pool_bytes
    program = FrameProgram(params, mano, cfg, dev)
    got, n = run_counted(lambda: program(frames[0], K))
    expect_launches("serving: FrameProgram capture", n, {**none, "K1": CAPTURE_RUNS,
                                                         "K2": CAPTURE_RUNS * depth})
    hold_to_eager(got, eager_frame(params, mano, cfg, dev, frames[0], K),
                  eager_frame(params, mano, cfg, dev, frames[0], K), "serving: FrameProgram")
    pools["FrameProgram bf16"] = program.program.pool_bytes

    # (b) stream_multi: four sources, detect_every=2
    tick_ms = stream_multi_phase(params, mano, cfg, dev, frames, K, depth, pools)

    # (c) the HTTP server
    http_phase(params, mano, cfg, dev, frames[:6], depth, pools)

    # (d) graph against eager, end to end, at B = 1, 4, 16
    for name, p, c, _ in runs:
        for B in (1, 4, 16):
            pipe = BatchedPipeline(p, mano, c, batch_size=B, device=dev)
            ms = interleaved_p50({"graph": lambda: pipe.process_batch(frames[:B], K),
                                  "eager": lambda: eager_batch(pipe, frames[:B], K)})
            print(f"serving e2e b{B} 720p {name} (pad, upload, program, copy back): p50 "
                  f"{ms['graph']:.2f} ms by its captured graph = {B / ms['graph'] * 1e3:.2f} "
                  f"frames/s, {ms['eager']:.2f} ms eager = {B / ms['eager'] * 1e3:.2f} frames/s "
                  f"on {smi} (host clock, in turns graph, eager, eager, graph; 1 warm-up, "
                  "6 timed each)")
            pools[f"BatchedPipeline {name} b{B}"] = pipe.programs["detect"].pool_bytes
            del pipe
    print(f"serving: stream_multi tick (4 sources, 720p, read, pad, upload, replay, copy back): "
          f"p50 keyframe {tick_ms['keyframe']:.2f} ms, tracked {tick_ms['tracked']:.2f} ms on "
          f"{smi} (host clock, 3 ticks each)")
    for what, by_key in pools.items():
        for key, nbytes in by_key.items():
            print(f"serving: graph pool {what} [{key}]: {nbytes / 2**20:.1f} MiB")
    torch.cuda.synchronize()


def stream_multi_phase(params, mano, cfg, dev, frames, K, depth, pools):
    """stream_multi over four iterator sources of 720p frames at
    detect_every=2, 8 ticks: the cadence of "detected", the launches of the
    two captures, a keyframe replay's and a tracked replay's kernels by
    name (K2 in both, K1 only in the keyframe), the tracked tick against
    eager infer_frames_tracked on the same state bit for bit, and the ticks'
    times: {"keyframe": ms, "tracked": ms}."""
    from hamer_yolo_tpu_torch.pipeline.serving import BatchedPipeline

    n_src, n_ticks = 4, 8
    srcs = [[frames[(n_src * t + s) % len(frames)] for t in range(n_ticks)] for s in range(n_src)]
    pipe = BatchedPipeline(params, mano, cfg, batch_size=n_src, detect_every=2, device=dev)
    gen = pipe.stream_multi([iter(f) for f in srcs], K, max_batches=n_ticks, timeout=30.0,
                            buffer=n_ticks)
    none = dict.fromkeys(KERNELS, 0)
    ticks = []
    tick, n = run_counted(lambda: next(gen))
    ticks.append(tick)
    expect_launches("serving: stream_multi tick 0, the detect capture", n,
                    {**none, "K1": CAPTURE_RUNS, "K2": CAPTURE_RUNS * depth})
    tick, n = run_counted(lambda: next(gen))
    ticks.append(tick)
    expect_launches("serving: stream_multi tick 1, the tracked capture", n,
                    {**none, "K2": CAPTURE_RUNS * depth})
    tick, counts = kernels_by_name(lambda: next(gen), lambda: pipe.process_batch(
        [srcs[s][2] for s in range(n_src)], K))
    ticks.append(tick)
    expect_replay("serving: stream_multi tick 2, a keyframe", counts, 1, depth)
    state = [{"kp2d": tick["outputs"]["keypoints_2d"][s], "is_right": tick["outputs"]["is_right"][s],
              "valid": tick["outputs"]["valid"][s]} for s in range(n_src)]
    tick, counts = kernels_by_name(lambda: next(gen), lambda: pipe._fetch(*pipe._dispatch_tracked(
        [srcs[s][3] for s in range(n_src)], state, K)))
    ticks.append(tick)
    expect_replay("serving: stream_multi tick 3, tracked", counts, 0, depth)
    ms = {"keyframe": [], "tracked": []}
    for t in range(4, n_ticks):
        t0 = time.perf_counter()
        ticks.append(next(gen))
        ms["keyframe" if t % 2 == 0 else "tracked"].append((time.perf_counter() - t0) * 1e3)
    if next(gen, None) is not None:
        raise RuntimeError("stream_multi: more ticks than max_batches")
    want = [list(range(n_src)) if t % 2 == 0 else [] for t in range(n_ticks)]
    got = [t["detected"] for t in ticks]
    print(f"serving: stream_multi {n_src} sources, detect_every 2, {n_ticks} ticks: detected "
          f"{got}; valid slots a tick {[int(t['outputs']['valid'].sum()) for t in ticks]}")
    if got != want or any(t["source_idx"] != list(range(n_src)) for t in ticks):
        raise RuntimeError(f"stream_multi: detected {got}, expected {want}")
    cur = [srcs[s][3] for s in range(n_src)]
    hold_to_eager(ticks[3]["outputs"], eager_batch(pipe, cur, K, ticks[2]["outputs"]),
                  eager_batch(pipe, cur, K, ticks[2]["outputs"]),
                  "serving: stream_multi tick 3 (tracked)")
    pools.update({f"stream_multi {k} b{n_src}": prog.pool_bytes
                  for k, prog in pipe.programs.items()})
    return {k: float(np.median(v)) for k, v in ms.items()}


def http_phase(params, mano, cfg, dev, frames, depth, pools):
    """The HTTP server at --batch 4 on port 0 in a thread: six concurrent
    POSTs of .npy frames come back as valid JSON in at most two batches;
    the server stops within a time limit."""
    import io
    import threading
    import urllib.request

    from hamer_yolo_tpu_torch.pipeline import http_server
    from hamer_yolo_tpu_torch.pipeline.serving import BatchedPipeline

    print("serving: HTTP server: for this phase decode_image is replaced by np.load of .npy "
          "bodies, so that the script needs no cv2")
    wait_s = 120.0
    pipe = BatchedPipeline(params, mano, cfg, batch_size=BATCH, device=dev)
    decode = http_server.decode_image
    http_server.decode_image = lambda raw: np.load(io.BytesIO(raw))
    srv = http_server.make_http_server(pipe, "127.0.0.1", 0, max_wait_ms=500.0)
    server = threading.Thread(target=srv.serve_forever, daemon=True)
    server.start()
    url = f"http://127.0.0.1:{srv.server_address[1]}"

    def get(path):
        with urllib.request.urlopen(url + path, timeout=wait_s) as r:
            return json.loads(r.read())

    try:
        bodies = []
        for f in frames:
            buf = io.BytesIO()
            np.save(buf, f)
            bodies.append(buf.getvalue())
        results, errors = [None] * len(bodies), []

        def post(i):
            try:
                req = urllib.request.Request(url + "/infer", data=bodies[i], method="POST")
                with urllib.request.urlopen(req, timeout=wait_s) as r:
                    results[i] = json.loads(r.read())
            except Exception as e:  # raised below
                errors.append(e)

        def burst():
            before = get("/stats")
            clients = [threading.Thread(target=post, args=(i,)) for i in range(len(bodies))]
            for c in clients:
                c.start()
            for c in clients:
                c.join(timeout=wait_s)
            return before, get("/stats"), any(c.is_alive() for c in clients)

        (before, after, hung), n = run_counted(burst)
        health = get("/healthz")
        batches = after["batches"] - before["batches"]
        print(f"serving: HTTP {len(bodies)} concurrent POSTs at batch {BATCH}: "
              f"{after['frames'] - before['frames']} frames in {batches} batches; hands per "
              f"request {[len(r['hands']) if r else None for r in results]}; launches {n}; "
              f"/healthz {health}")
        if errors or hung or any(r is None or (r["height"], r["width"]) != (720, 1280)
                                 or not isinstance(r["hands"], list) for r in results):
            raise RuntimeError(f"HTTP server: errors {errors}, hung {hung}")
        if not 1 <= batches <= 2 or after["frames"] - before["frames"] != len(bodies):
            raise RuntimeError(f"HTTP server: {len(bodies)} requests in {batches} batches")
        expect_launches("serving: HTTP dispatcher's capture", n,
                        {**dict.fromkeys(KERNELS, 0), "K1": CAPTURE_RUNS,
                         "K2": CAPTURE_RUNS * depth})
        if health.get("device") != str(dev) or not health.get("device_name"):
            raise RuntimeError(f"HTTP server: /healthz {health}")
        pools[f"HTTP BatchedPipeline b{BATCH}"] = pipe.programs["detect"].pool_bytes
    finally:
        t0 = time.perf_counter()
        srv.shutdown()
        srv.server_close()
        srv.batcher.close()
        server.join(timeout=30.0)
        http_server.decode_image = decode
    stopped = not server.is_alive() and not srv.batcher._thread.is_alive()
    print(f"serving: HTTP server shut down in {time.perf_counter() - t0:.2f} s")
    if not stopped:
        raise RuntimeError("HTTP server: a thread did not stop")


def cv2_stand_in():
    """A module to stand in for cv2 on a machine without it: every file
    holds .npy data whatever its name (an image one frame, a 16-bit or
    3-channel depth png its array, a video a stack of frames; imwrite
    writes one), imread's flags change nothing, an encoded image is .npy
    bytes, and line and circle draw nothing."""
    import io
    import types

    class VideoCapture:
        def __init__(self, source):
            ok = isinstance(source, str) and os.path.exists(source)
            self.frames = list(np.load(source)) if ok else None

        def isOpened(self):
            return self.frames is not None

        def read(self):
            return (True, self.frames.pop(0)) if self.frames else (False, None)

        def release(self):
            self.frames = []

    cv2 = types.ModuleType("cv2")
    cv2.IMREAD_COLOR, cv2.IMREAD_ANYDEPTH, cv2.IMREAD_ANYCOLOR = 1, 2, 4
    cv2.imread = lambda path, flags=None: np.load(path)  # the data as saved, whatever the flags
    cv2.imdecode = lambda buf, flag: np.load(io.BytesIO(np.asarray(buf).tobytes()))

    def imwrite(path, img):
        with open(path, "wb") as fh:
            np.save(fh, img)
        return True

    cv2.imwrite = imwrite
    cv2.line = cv2.circle = lambda img, *args, **kwargs: img  # draw nothing
    cv2.VideoCapture = VideoCapture
    return cv2


def cli_phase(dev, depth):
    """``serve``, ``serve --multi --detect-every 2`` and ``serve-http``
    through cli.main on the card at full width, with cv2_stand_in() in
    place of cv2 (the script needs none): JAX's output lines, the captures'
    launches, one HTTP request answered and the server shut down."""
    import io
    import threading
    import urllib.request

    from hamer_yolo_tpu_torch.cli.main import main as cli
    from hamer_yolo_tpu_torch.pipeline import http_server

    print("cli: serve, serve --multi and serve-http through cli.main on the card, with a "
          "stand-in for cv2 that reads .npy files, so that the script needs no cv2")
    frames = frames_720p(8, SEED + 2)
    none = dict.fromkeys(KERNELS, 0)
    capture = {**none, "K1": CAPTURE_RUNS, "K2": CAPTURE_RUNS * depth}
    saved = sys.modules.get("cv2")
    sys.modules["cv2"] = cv2_stand_in()
    try:
        with tempfile.TemporaryDirectory() as root:
            os.makedirs(os.path.join(root, "in"))
            for i, f in enumerate(frames):
                with open(os.path.join(root, "in", f"f{i}.png"), "wb") as fh:
                    np.save(fh, f)
            videos = []
            for j in range(4):
                videos.append(os.path.join(root, f"s{j}.avi"))
                with open(videos[-1], "wb") as fh:
                    np.save(fh, np.stack(frames[2 * j:2 * j + 2] * 2))

            def run(argv):
                out = io.StringIO()
                with contextlib.redirect_stdout(out):
                    rc = cli(argv)
                return rc, out.getvalue().strip().splitlines()

            (rc, lines), n = run_counted(lambda: run(["serve", "--input", os.path.join(root, "in"),
                                                      "--batch", "4"]))
            print(f"cli serve --batch 4: rc {rc}; {lines}; launches {n}")
            if rc or [ln.split(",")[0] for ln in lines[:-1]] != ["batch: 4 frames"] * 2 \
                    or not lines[-1].startswith("8 frames in "):
                raise RuntimeError("cli serve: unexpected output")
            expect_launches("cli serve", n, capture)
            (rc, lines), n = run_counted(lambda: run(
                ["serve", "--multi", "--input", ",".join(videos), "--detect-every", "2",
                 "--max-frames", "4"]))
            print(f"cli serve --multi --detect-every 2: rc {rc}; {lines}; launches {n}")
            det = [ln.split(" (detected: ")[-1] for ln in lines[:-1]]
            if rc or det != ["[0, 1, 2, 3])", "[])"] * 2 or not lines[-1].startswith("16 frames in"):
                raise RuntimeError("cli serve --multi: unexpected output")
            expect_launches("cli serve --multi", n, {**capture,
                                                     "K2": 2 * CAPTURE_RUNS * depth})
        made = []
        build = http_server.make_http_server
        http_server.make_http_server = lambda *a, **kw: made.append(build(*a, **kw)) or made[-1]
        rcs = []
        thread = threading.Thread(target=lambda: rcs.append(cli(
            ["serve-http", "--port", "0", "--batch", "2", "--max-wait-ms", "5"])), daemon=True)
        try:
            thread.start()
            for _ in range(600):
                if made or not thread.is_alive():
                    break
                thread.join(timeout=0.1)
            if not made:
                raise RuntimeError("cli serve-http: no server")
            body = io.BytesIO()
            np.save(body, frames[0])
            url = f"http://127.0.0.1:{made[0].server_address[1]}"
            req = urllib.request.Request(url + "/infer", data=body.getvalue(), method="POST")
            with urllib.request.urlopen(req, timeout=120) as r:
                res = json.loads(r.read())
            with urllib.request.urlopen(url + "/healthz", timeout=120) as r:
                health = json.loads(r.read())
        finally:
            if made:
                made[0].shutdown()
            thread.join(timeout=60)
            http_server.make_http_server = build
        print(f"cli serve-http: one POST -> {len(res['hands'])} hands at {res['height']}x"
              f"{res['width']}; /healthz {health}; rc {rcs}")
        if thread.is_alive() or rcs != [0] or (res["height"], res["width"]) != (720, 1280):
            raise RuntimeError("cli serve-http: not answered or not shut down")
    finally:
        if saved is None:
            sys.modules.pop("cv2", None)
        else:
            sys.modules["cv2"] = saved


def read_npys(out_dir):
    """{file name: hand dicts} of the npy files a runner wrote."""
    from hamer_yolo_tpu_torch.io.writers import load_hand_npy

    return {f: load_hand_npy(os.path.join(out_dir, f)) for f in sorted(os.listdir(out_dir))
            if f.endswith(".npy")}


NPY_KEYS = ("betas", "theta", "pose_hand", "pose_global", "cam_t")


def compare_npys(got, ref, what, tol):
    """The files of ``ref`` in ``got`` with the same hands (side present,
    is_right) and finite values, each field within ``tol`` (None: no limit);
    prints each field's largest difference."""
    worst = dict.fromkeys(NPY_KEYS, 0.0)
    for name, r in ref.items():
        g = got.get(name)
        if g is None:
            raise RuntimeError(f"{what}: {name} missing")
        for side, hand in r.items():
            if (hand is None) != (g[side] is None):
                raise RuntimeError(f"{what}: {name} {side} hand found by one run only")
            if hand is None:
                continue
            if hand["is_right"] != g[side]["is_right"]:
                raise RuntimeError(f"{what}: {name} {side} is_right differs")
            for k in NPY_KEYS:
                a, b = np.asarray(g[side][k], np.float64), np.asarray(hand[k], np.float64)
                if not np.isfinite(a).all():
                    raise RuntimeError(f"{what}: {name} {side} {k} not finite")
                worst[k] = max(worst[k], float(np.abs(a - b).max()))
                if tol is not None and worst[k] > tol:
                    raise RuntimeError(f"{what}: {name} {side} {k} differs by {worst[k]:.4g} "
                                       f"(limit {tol})")
    print(f"{what}: {len(ref)} files, the same hands; largest difference (limit {tol}) "
          + ", ".join(f"{k} {v:.4g}" for k, v in worst.items()))
    return worst


def masked_path(params, mano, cfg, dev, frames, K):
    """The mask-driven runner (process_masked_frames) over ``frames`` with a
    numpy-made mask each (the value-3 pixels a 200 x 160 box), counted; then
    one MaskedProgram call outside the count: (stats, outputs, launches)."""
    import torch

    from hamer_yolo_tpu_torch.pipeline.runner import MaskedProgram, process_masked_frames

    masks = []
    for i, f in enumerate(frames):
        m = np.zeros(f.shape[:2], np.uint8)
        m[200 + 40 * i:400 + 40 * i, 500:660] = 3
        masks.append(m)
    program = MaskedProgram(params, mano, cfg, dev)
    with tempfile.TemporaryDirectory() as out_dir:
        stats, n = run_counted(lambda: process_masked_frames(
            ((f"frame{i}", f, m) for i, (f, m) in enumerate(zip(frames, masks))), out_dir,
            program, K=K, progress=False))
        if stats.frames != len(frames) or stats.skipped or len(read_npys(out_dir)) != len(frames):
            raise RuntimeError(f"masked path: {stats}")
    S = cfg.max_hands
    boxes = np.zeros((S, 4), np.float32)
    boxes[0] = [500, 200, 659, 399]
    valid = np.zeros(S, np.float32)
    valid[0] = 1.0
    out = program(frames[0], boxes, np.ones(S, np.float32), valid, K)
    for k, v in out.items():
        if v.dtype != bool and not np.isfinite(v).all():
            raise RuntimeError(f"masked path: {k} not finite")
    if "root_depth" not in out or "classes" in out:
        raise RuntimeError(f"masked path: outputs {sorted(out)}")
    torch.cuda.synchronize()
    return stats, out, n


def check_tome_shapes(blk, heads, dev):
    """K3, K4, K5 and K7 against their plain versions at ToMe's token counts
    (TOME_N: N tokens a crop, 16 crops, M = 16 N rows, not multiples of 128;
    K7's query tiles partly empty), on random bf16 tokens and the int8
    weights and calibrated scales of block 0, at the limits of
    check_int8_kernels. These launches are not counted."""
    import torch

    from hamer_yolo_tpu_torch.ops import attn_proj_block as apb
    from hamer_yolo_tpu_torch.ops import int8_matmul as im
    from hamer_yolo_tpu_torch.ops.attn_block import check_against_twin
    from hamer_yolo_tpu_torch.ops.short_attention import (fused_short_attention,
                                                          fused_short_attention_ref)

    rng = np.random.default_rng(SEED + 9)

    def randn(*shape):
        return torch.from_numpy(rng.normal(size=shape).astype(np.float32)).to(dev).bfloat16()

    a, mlp = blk["attn"], blk["mlp"]
    lin = {k: (p["wq"]["q"], p["wq"]["scale"], p["b"], p["sx"])
           for k, p in (("qkv", a["qkv"]), ("proj", a["proj"]), ("fc1", mlp["fc1"]),
                        ("fc2", mlp["fc2"]))}
    ln1 = (blk["norm1"]["scale"], blk["norm1"]["bias"])
    ln2 = (blk["norm2"]["scale"], blk["norm2"]["bias"])
    Kd = ln1[0].shape[0]
    hd = Kd // heads
    for N in TOME_N:
        B, M = 16, 16 * N
        tok = randn(B, N, Kd)
        readings = {}
        (q, s, b, sq), (pq, ps, pb, sp) = lin["qkv"], lin["proj"]
        args = (q, s, b, *ln1, sq, sp, pq, ps, pb, heads)
        steps = apb.fused_int8_attn_proj_block_steps(tok, *args)
        torch.cuda.synchronize()
        readings["K3"] = apb.check_against_plain(steps, tok, *args)["max_abs_err"]
        (q1, s1, b1, sx1), (q2, s2, b2, sx2) = lin["fc1"], lin["fc2"]
        margs = (q1, s1, b1, q2, s2, b2, *ln2, sx1, sx2)
        got = im.fused_int8_mlp_block(tok, *margs, gelu="gelu_poly")
        torch.cuda.synchronize()
        readings["K4"] = im.check_against_plain(got, im.fused_int8_mlp_block_ref(
            tok, *margs, gelu="gelu_poly"), "K4")["max_abs_err"]
        err = 0.0
        for name, x, pro, (g, bt) in (("qkv", tok.reshape(M, Kd), "ln", ln1),
                                      ("proj", randn(M, Kd), "id", (None, None)),
                                      ("fc2", randn(M, 4 * Kd), "gelu_poly", (None, None))):
            q, s, b, sx = lin[name]
            for static in (None, sx):
                got = im.fused_int8_matmul(x, q, s, b, g, bt, prologue=pro, static_scale=static)
                torch.cuda.synchronize()
                err = max(err, im.check_against_plain(got, im.fused_int8_matmul_ref(
                    x, q, s, b, g, bt, prologue=pro, static_scale=static),
                    f"K5 {name}")["max_abs_err"])
        readings["K5"] = err
        qkv = randn(B, N, 3, heads, hd)
        qh, kh, vh = (qkv[:, :, i].transpose(1, 2) for i in range(3))
        err = 0.0
        for sx in (None, sp):
            got = fused_short_attention(qh, kh, vh, out_scale=sx)
            torch.cuda.synchronize()
            ref = fused_short_attention_ref(qh, kh, vh, out_scale=sx)
            r = check_against_twin(got, ref) if sx is None else im.check_against_plain(got, ref,
                                                                                       "K7")
            err = max(err, r["max_abs_err"])
        readings["K7"] = err
        print(f"ToMe shapes N {N} (tokens ({B}, {N}, {Kd}), M {M}): K3, K4, K5 (ln, id, "
              f"gelu_poly; dynamic and static) and K7 (bf16 and int8 out) within their limits "
              "of the plain versions; max abs err " + ", ".join(
                  f"{k} {v:.4g}" for k, v in readings.items()))


def detector_candidates(yolo, cfg, dev, B):
    """The detector's K1 input on B numpy-made 720p frames (the frames of
    the main path's batch first): ``nms_candidates`` of YOLOv7's output."""
    import torch

    from hamer_yolo_tpu_torch.models.yolov7.model import yolov7_forward
    from hamer_yolo_tpu_torch.ops.nms import nms_candidates
    from hamer_yolo_tpu_torch.pipeline.preprocess import device_letterbox

    imgs = torch.from_numpy(np.stack(frames_720p(B, SEED))).to(dev).to(torch.float32)
    hws = torch.tensor([[720.0, 1280.0]] * B, device=dev)
    with torch.inference_mode():
        lb, _, _ = device_letterbox(imgs, hws, cfg.det_size)
        pred = yolov7_forward(yolo, lb.flip(-1) / 255.0, cfg.yolo)
        return nms_candidates(pred, cfg.conf_thres, cfg.classes, cfg.agnostic_nms,
                              cfg.max_nms_static)


def disjoint_boxes(B, K, dev):
    """K1's worst case: B images of K active boxes that do not touch (all
    kept, none suppressed, every IoU computed)."""
    import torch

    x = torch.arange(K, dtype=torch.float32, device=dev) * 50
    boxes = torch.stack([x, x * 0, x + 40, x * 0 + 40], -1).expand(B, K, 4).contiguous()
    return boxes, torch.ones((B, K), device=dev)


def k1_bound(active):
    """K1's bound on these inputs: (ms, by). Boxes, active and keep (f32)
    each read or written once; an IoU (about 12 f32 operations) for each pair
    of active candidates of an image, the pairs the keep set depends on."""
    B, K = active.shape
    n = (active > 0.5).sum(-1).double()
    return bound(B * K * (16 + 4 + 4), {"f32": 12 * float((n * (n - 1) / 2).sum())})


def check_k1(cands, cfg):
    """K1 against its plain version, both entries (f32 masks and the bool
    masks of non_max_suppression), on random, on-threshold and ragged boxes,
    K = 1024 and 2048, the worst case (all active, none suppressed), all
    inactive, a negative threshold, and the detector's own candidates at
    B = 4 and 16; then k1_alone's timings."""
    import torch

    from hamer_yolo_tpu_torch.geometry.boxes import box_iou
    from hamer_yolo_tpu_torch.ops.nms import (greedy_nms_keep, greedy_nms_keep_mask,
                                              greedy_nms_keep_ref)

    dev = cands[4].shifted.device
    rng = np.random.default_rng(SEED)

    def random_case(B, K):
        boxes = np.zeros((B, K, 4), np.float32)
        boxes[..., :2] = rng.uniform(0, 600, (B, K, 2))
        boxes[..., 2:] = boxes[..., :2] + rng.uniform(10, 120, (B, K, 2))
        act = (rng.uniform(0, 1, (B, K)) > 0.2).astype(np.float32)
        return torch.from_numpy(boxes).to(dev), torch.from_numpy(act).to(dev), 0.45

    B1, K1n = 4, 512
    base = rng.uniform(0, 500, (B1, K1n // 4, 1, 2)).astype(np.float32)
    shift = rng.choice(np.float32([0.0, 0.25, 0.5, 0.75]), (B1, K1n // 4, 4, 2))
    xy1 = (base + shift).reshape(B1, K1n, 2)
    near = np.concatenate([xy1, xy1 + np.float32(40.0)], axis=-1).astype(np.float32)
    near_t = torch.from_numpy(near).to(dev)
    thr_near = float(box_iou(near_t[0, :1], near_t[0, 1:2])[0, 0])  # pairs sit on the threshold
    rand = random_case(B1, K1n)
    cases = {
        "random": rand,
        "at_threshold": (near_t, torch.ones((B1, K1n), device=dev), thr_near),
        "ragged_252": (rand[0][:, :252].contiguous(), torch.ones((B1, 252), device=dev), 0.45),
        "random_K1024": random_case(B1, 1024),
        "random_K2048": random_case(B1, 2048),
        "worst_case": (*disjoint_boxes(B1, K1n, dev), 0.45),
        "all_inactive": (rand[0], torch.zeros((B1, K1n), device=dev), 0.45),
        "negative_thr": (rand[0], rand[1], -0.1),
        **{f"detector_B{B}": (c.shifted.contiguous(), c.active.to(torch.float32), cfg.iou_thres)
           for B, c in cands.items()},
    }
    err = 0.0
    for name, (bx, act, thr) in cases.items():
        got = greedy_nms_keep(bx, act, thr)
        got_mask = greedy_nms_keep_mask(bx, act > 0.5, thr)
        torch.cuda.synchronize()
        ref = greedy_nms_keep_ref(bx, act, thr)
        err = max(err, float((got - ref).abs().max()))
        if not torch.equal(got, ref) or not torch.equal(got_mask, ref > 0.5):
            raise RuntimeError(f"K1 keep set differs from its twin on {name}: "
                               f"{int((got != ref).sum())} candidates (f32 entry), "
                               f"{int((got_mask != (ref > 0.5)).sum())} (bool entry)")
        on = act > 0.5
        later = torch.ones(on.shape[1:] * 2, dtype=torch.bool, device=dev).triu(1)
        rows = ((box_iou(bx, bx) > thr) & later & on[:, None, :]).any(-1) & on
        print(f"K1 {name}: B {bx.shape[0]} K {bx.shape[1]} keep sets identical, both entries "
              f"({int(got.sum())} kept of {int(act.sum())} active; {int((rows & (got > 0.5)).sum())}"
              f" kept with a row to apply, in {int(_words_with(rows & (got > 0.5)))} words of 32)")
    times = k1_alone(cands, cfg.iou_thres)
    bx, act, thr = cases["detector_B4"]
    ms = cuda_time_ms(lambda: greedy_nms_keep(bx, act, thr))
    plain_ms = cuda_time_ms(lambda: greedy_nms_keep_ref(bx, act, thr), iters=3)
    bound_ms, by = k1_bound(act)
    print(f"K1 one call with host work at the main path's shape {tuple(bx.shape)}: {ms:.4f} ms "
          f"(device {times[('detector', 4)]:.4f} ms), twin {plain_ms:.4f} ms, bound "
          f"{bound_ms:.7f} ms ({by}: {int(act.sum())} active); no PyTorch call computes it")
    return {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": by, "library_ms": None}


def _words_with(mask):
    """How many words of 32 candidates (B, K) have a set bit."""
    B, K = mask.shape
    pad = -K % 32
    import torch

    return torch.nn.functional.pad(mask, (0, pad)).reshape(B, -1, 32).any(-1).sum()


def host_times_us(fn, calls=200, rounds=7):
    """Host time of one call of fn in each of ``rounds`` rounds of ``calls``
    calls back to back on the host clock, the launches queueing on the card
    (a sync only between rounds)."""
    import torch

    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(rounds):
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        times.append((time.perf_counter() - t0) / calls * 1e6)
        torch.cuda.synchronize()
    return times


def k1_alone(cands, thr):
    """K1's device time by CUDA graph replay at (B, 512), B = 4 and 16, on
    the detector's candidates and on the worst case (disjoint_boxes); the
    launch floor (an empty kernel launched as K1 is, and as K1 was before
    its redesign: one CTA of 256 threads per image), where the package has
    it; one call with host work (CUDA events); and the wrapper's host time
    a call (host_times_us, the median). No check: another commit's package may be the
    one imported (chip_gemm.py --k1 --root). Returns {(what, B): ms}."""
    import torch

    from hamer_yolo_tpu_torch.ops import cuda_build
    from hamer_yolo_tpu_torch.ops.nms import greedy_nms_keep

    lib = cuda_build.load("nms.cu")
    times = {}
    for B, c in cands.items():
        dev = c.shifted.device
        K = c.shifted.shape[1]
        inputs = {"detector": (c.shifted.contiguous(), c.active.to(torch.float32)),
                  "worst_case": disjoint_boxes(B, K, dev)}
        for what, (bx, act) in inputs.items():
            times[(what, B)] = graph_time_ms(lambda: greedy_nms_keep(bx, act, thr))
            times[(f"{what} with host work", B)] = cuda_time_ms(
                lambda: greedy_nms_keep(bx, act, thr))
        times[("host time a call", B)] = float(np.median(host_times_us(
            lambda: greedy_nms_keep(*inputs["detector"], thr)))) / 1e3
        if hasattr(lib, "hyt_nms_floor"):
            stream = torch.cuda.current_stream().cuda_stream
            for what, parent in (("floor", 0), ("floor, parent's grid", 1)):
                cuda_build.check(lib.hyt_nms_floor(B, K, parent, stream), "nms_floor_kernel")
                times[(what, B)] = graph_time_ms(lambda: lib.hyt_nms_floor(
                    B, K, parent, torch.cuda.current_stream().cuda_stream))
        print(f"K1 at ({B}, {K}), device time by CUDA graph replay: "
              + ", ".join(f"{w} {t:.4f} ms" for (w, b), t in times.items() if b == B),
              flush=True)
    return times


def check_k2(blk0, tok0, heads):
    """K2 against its plain version (ulp limits of ops/attn_block.py) on
    the main path's block-0 tokens, random tokens of both dtypes, a ragged M
    and N past 256 keys (f32 tokens there launch by launch); timings at the
    main path's shape."""
    import torch

    from hamer_yolo_tpu_torch.ops import attn_block
    from hamer_yolo_tpu_torch.ops.attn_block import (attention_ref, check_against_twin,
                                                      fused_bf16_attn_block,
                                                      fused_bf16_attn_block_ref, ln_qkv, ln_qkv_ref,
                                                      twin_readings)

    dev = tok0.device
    args = (blk0["attn"]["qkv"]["w"], blk0["attn"]["qkv"]["b"], blk0["norm1"]["scale"],
            blk0["norm1"]["bias"], heads)
    rng = np.random.default_rng(SEED + 2)

    def randn(*shape):
        return torch.from_numpy(rng.normal(size=shape).astype(np.float32)).to(dev)

    tok_rand = randn(8, 192, 1280)
    # ViT-H's tokens, random tokens of either dtype, a ragged M (300 rows) and
    # N past the attention's single-pass 256 keys (the key-block form)
    cases = {"random_b8_bf16": tok_rand.to(torch.bfloat16), "random_b8_f32": tok_rand,
             "block0_tokens": tok0, "ragged_b3_n100_bf16": randn(3, 100, 1280).bfloat16(),
             "ragged_b3_n100_f32": randn(3, 100, 1280),
             "n266_b4_bf16": randn(4, 266, 1280).bfloat16(),
             "n577_b2_bf16": randn(2, 577, 1280).bfloat16()}
    # f32 tokens past 256 keys are held launch by launch: the LN + QKV GEMM
    # against ln_qkv_ref, the attention against attention_ref on the kernel's
    # own qkv, each at K2's limits. End to end (printed, not held), the twin's
    # own f32 GEMM rounds some bf16 qkv the other way from exact sums, as
    # often as the kernel does but at other elements, and at 577 keys an f32
    # output of the twin can lie further from the same math on exactly summed
    # qkv than the per-element limit; the lines printed here give both sides'
    # distance from it (PERF.md).
    steps = {"n577_b2_f32": randn(2, 577, 1280)}
    print(f"K2 limits against its twin (ops/attn_block.py): every element within "
          f"{attn_block.MAX_ULPS} bf16 ulps of max(|twin|, mean |twin|); at most "
          f"{attn_block.MAX_FRAC_OVER_1ULP} of elements beyond 1 ulp of their own |twin|; "
          f"bf16 outputs: at most {attn_block.MAX_FRAC_DIFFERING} of elements differing")
    err = 0.0
    for name, tok in cases.items():
        got = fused_bf16_attn_block(tok, *args)
        torch.cuda.synchronize()
        ref = fused_bf16_attn_block_ref(tok, *args)
        r = check_against_twin(got, ref)
        err = max(err, r["max_abs_err"])
        print(f"K2 {name}: tokens {tuple(tok.shape)} {tok.dtype}, max |twin| "
              f"{float(ref.abs().max()):.4g}: " + ", ".join(f"{k} {v:.6g}" for k, v in r.items()))
    for name, tok in steps.items():
        B, N, Kd = tok.shape
        x = tok.reshape(B * N, Kd)
        qkv = ln_qkv(x, *args[:4])
        got = fused_bf16_attn_block(tok, *args)
        torch.cuda.synchronize()
        twin_qkv = ln_qkv_ref(x, *args[:4])
        for step, r in (("LN + QKV GEMM", check_against_twin(qkv, twin_qkv)),
                        ("attention", check_against_twin(got, attention_ref(
                            qkv.reshape(B, N, -1), heads, tok.dtype)))):
            err = max(err, r["max_abs_err"])
            print(f"K2 {name}, {step}, on the kernel's own input of it: tokens "
                  f"{tuple(tok.shape)} {tok.dtype}: " + _fmt(r))
        exact = exact_qkv(x, *args[:4])
        ref_exact = attention_ref(exact.reshape(B, N, -1), heads, tok.dtype)
        print(f"K2 {name} end to end (not held): against the twin "
              + _fmt(twin_readings(got, fused_bf16_attn_block_ref(tok, *args)))
              + "; against the same math on exactly summed qkv: the kernel "
              + _fmt(twin_readings(got, ref_exact)) + "; the twin "
              + _fmt(twin_readings(fused_bf16_attn_block_ref(tok, *args), ref_exact))
              + f"; bf16 qkv rounded otherwise than the exact sums: kernel "
              f"{float((qkv != exact).float().mean()):.4g}, twin "
              f"{float((twin_qkv != exact).float().mean()):.4g}")
    ms = cuda_time_ms(lambda: fused_bf16_attn_block(tok0, *args))
    dev_ms = graph_time_ms(lambda: fused_bf16_attn_block(tok0, *args))
    plain_ms = cuda_time_ms(lambda: fused_bf16_attn_block_ref(tok0, *args))
    comp = k2_composition(tok0, *args)
    comp_ms = cuda_time_ms(comp)
    B, N, Kd = tok0.shape
    td = args[0].shape[1]
    D = td // 3
    bound_ms, by = bound(2 * (B * N * Kd + Kd * td + B * N * D),
                         {"bf16": 2 * B * N * Kd * td + 4 * B * N * N * D})
    print(f"K2 timing at the main path's shape {tuple(tok0.shape)}: kernel {ms:.4f} ms, device "
          f"time alone (CUDA graph of 20 launches) {dev_ms:.4f} ms, twin {plain_ms:.4f} ms, bound "
          f"{bound_ms:.6f} ms ({by}); no PyTorch call computes it; for reference only, the "
          f"library composition F.layer_norm + torch.addmm + scaled_dot_product_attention "
          f"{comp_ms:.4f} ms (device time alone {graph_time_ms(comp):.4f} ms)")
    return {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": by, "library_ms": None}


def exact_qkv(x, w, bias, ln_scale, ln_bias):
    """K2's qkv with the LN and the GEMM summed in f64, each rounded to bf16
    where the twin rounds it: the twin's math without its f32 sums."""
    import torch

    xd = x.double()
    mu = xd.mean(-1, keepdim=True)
    xn = (xd - mu) * torch.rsqrt(torch.square(xd - mu).mean(-1, keepdim=True) + 1e-6)
    xn = (xn * ln_scale.double() + ln_bias.double()).float().bfloat16()
    qkv = xn.double() @ w.bfloat16().double() + bias.double()
    return qkv.float().bfloat16()


def k2_composition(tok, w, bias, ln_scale, ln_bias, heads):
    """A function computing K2's outputs with three library calls in the
    tokens' dtype (F.layer_norm, torch.addmm, scaled_dot_product_attention),
    rounding elsewhere than K2: a yardstick for timings, never on the path."""
    import torch
    import torch.nn.functional as F

    B, N, Kd = tok.shape
    dt = tok.dtype
    w_, b_, g_, bt_ = (t.to(dt) for t in (w, bias, ln_scale, ln_bias))
    hd = w.shape[1] // 3 // heads

    def run():
        x = F.layer_norm(tok, (Kd,), g_, bt_, 1e-6).reshape(B * N, Kd)
        qkv = torch.addmm(b_, x, w_).reshape(B, N, 3, heads, hd).permute(2, 0, 3, 1, 4)
        return F.scaled_dot_product_attention(qkv[0], qkv[1], qkv[2])

    return run


def k2_alone(dev, check=True):
    """K2 of ViT-H at the bf16 path's rows (K2_ROWS): its LN + QKV GEMM
    launches alone (ops/attn_block.ln_qkv; where the package has it), held to
    their plain version within K2's limits where ``check``, and all of K2 at
    192 tokens a crop, each by CUDA graph replay; beside them, for reference
    only, the library composition F.layer_norm + torch.addmm (and
    scaled_dot_product_attention for all of K2) in bf16, which the port never
    calls. TFLOP/s count the GEMM's 2 M K N operations. Returns
    {(name, M): ms}."""
    import torch
    import torch.nn.functional as F

    from hamer_yolo_tpu_torch.ops import attn_block as ab

    rng = np.random.default_rng(SEED + 8)

    def randn(*shape, scale=1.0):
        return torch.from_numpy((rng.normal(size=shape) * scale).astype(np.float32)).to(dev)

    Kd, td, heads = 1280, 3840, 16
    w, b = randn(Kd, td, scale=Kd ** -0.5), randn(td, scale=0.1)
    g, bt = 1.0 + randn(Kd, scale=0.1), randn(Kd, scale=0.1)
    w16, b16, g16, bt16 = (t.bfloat16() for t in (w, b, g, bt))
    peak = PEAK_OPS_PER_S["bf16"]
    out = {}
    for M in K2_ROWS:
        tok = randn(M // 192, 192, Kd).bfloat16()
        x = tok.reshape(M, Kd)
        r = {}
        if hasattr(ab, "ln_qkv"):
            if check:
                got = ab.ln_qkv(x, w, b, g, bt)
                torch.cuda.synchronize()
                ab.check_against_twin(got, ab.ln_qkv_ref(x, w, b, g, bt))
            r["ln_qkv"] = graph_time_ms(lambda: ab.ln_qkv(x, w, b, g, bt))
        r["layer_norm_addmm"] = graph_time_ms(
            lambda: torch.addmm(b16, F.layer_norm(x, (Kd,), g16, bt16, 1e-6), w16))
        r["k2"] = graph_time_ms(lambda: ab.fused_bf16_attn_block(tok, w, b, g, bt, heads))
        r["composition"] = graph_time_ms(k2_composition(tok, w, b, g, bt, heads))
        ops = 2 * M * Kd * td
        gemm = {k: f"{r[k]:.4f} ms = {ops / (r[k] * 1e-3) / 1e12:.0f} TFLOP/s "
                   f"({ops / (r[k] * 1e-3) / peak:.3f} of peak)"
                for k in ("ln_qkv", "layer_norm_addmm") if k in r}
        print(f"K2 alone M {M} (tokens {tuple(tok.shape)} bf16), device time by CUDA graph "
              f"replay of 20 launches" + (" (ln_qkv within K2's limits of its plain version)"
                                          if check and "ln_qkv" in r else "")
              + ": LN + QKV GEMM " + ", ".join(f"{k} {v}" for k, v in gemm.items())
              + f"; all of K2 {r['k2']:.4f} ms, the composition F.layer_norm + torch.addmm + "
              f"scaled_dot_product_attention {r['composition']:.4f} ms (reference only)",
              flush=True)
        out.update({(k, M): v for k, v in r.items()})
    return out


def k10_alone(dev, check=True):
    """K10 of ViT-H (K 1280, H 5120, gelu_poly, bf16 tokens) at K10_ROWS,
    beside K4 on the same inputs: held to K4 bit for bit where ``check``
    (both GELU flavours, bf16 and f32 tokens), then each timed by CUDA graph
    replay, and K10's single launch with its host work by CUDA events.
    TOP/s count fc1's and fc2's 4 M K H operations; the share is the bound
    (those operations at the int8 peak, or the bytes) over the device time.
    Returns {(name, M): ms}."""
    import torch

    from hamer_yolo_tpu_torch.ops import int8_matmul as im

    rng = np.random.default_rng(SEED + 9)

    def put(a):
        return torch.from_numpy(a).to(dev)

    Kd, H = 1280, 5120
    q1 = put(rng.integers(-127, 128, (Kd, H)).astype(np.int8))
    q2 = put(rng.integers(-127, 128, (H, Kd)).astype(np.int8))
    ws1 = put((2e-5 + 2e-5 * rng.random(H)).astype(np.float32))
    ws2 = put((1e-4 + 1e-4 * rng.random(Kd)).astype(np.float32))
    b1, b2 = (put((0.1 * rng.normal(size=n)).astype(np.float32)) for n in (H, Kd))
    g = put((1.0 + 0.1 * rng.normal(size=Kd)).astype(np.float32))
    bt = put((0.1 * rng.normal(size=Kd)).astype(np.float32))
    args = (q1, ws1, b1, q2, ws2, b2, g, bt, torch.tensor(0.034, device=dev),
            torch.tensor(0.021, device=dev))
    peak = PEAK_OPS_PER_S["int8"]
    out = {}
    for M in K10_ROWS:
        tok = put(rng.normal(size=(M // 192, 192, Kd)).astype(np.float32)).bfloat16()
        if check:
            for gelu in ("gelu", "gelu_poly"):
                for t in (tok, tok.float()):
                    got = im.fused_int8_mlp_block1(t, *args, gelu=gelu)
                    torch.cuda.synchronize()
                    if not torch.equal(got, im.fused_int8_mlp_block(t, *args, gelu=gelu)):
                        raise AssertionError(f"K10 alone M {M} {gelu} {t.dtype} is not K4 bit "
                                             "for bit")
        r = {"k10": graph_time_ms(lambda: im.fused_int8_mlp_block1(tok, *args, gelu="gelu_poly")),
             "k4": graph_time_ms(lambda: im.fused_int8_mlp_block(tok, *args, gelu="gelu_poly")),
             "k10_launch": cuda_time_ms(
                 lambda: im.fused_int8_mlp_block1(tok, *args, gelu="gelu_poly"), iters=20)}
        ops = 4 * M * Kd * H
        bound_ms, by = bound(2 * M * Kd * 2 + 2 * Kd * H + 8 * (H + Kd), {"int8": ops})
        rate = {k: f"{r[k]:.4f} ms = {ops / (r[k] * 1e-3) / 1e12:.0f} TOP/s "
                   f"({ops / (r[k] * 1e-3) / peak:.3f} of peak, {bound_ms / r[k]:.3f} of the "
                   f"bound)" for k in ("k10", "k4")}
        print(f"K10 alone M {M} (tokens {tuple(tok.shape)} bf16, H {H}, gelu_poly)"
              + (" (equal to K4 bit for bit, both GELUs, bf16 and f32 tokens)" if check else "")
              + f", device time by CUDA graph replay of 20 launches: K10 {rate['k10']}; K4 "
              f"{rate['k4']}; K10 one launch with its host work {r['k10_launch']:.4f} ms; bound "
              f"{bound_ms:.6f} ms ({by})", flush=True)
        out.update({(k, M): v for k, v in r.items()})
    return out


def check_int8_kernels(blk, tok0, heads):
    """K3, K4, K5 and K7 against their plain versions at the main path's
    shapes (16 crops x 192 tokens, ViT-H), on random data and the int8
    weights and calibrated scales of block 0; timings there."""
    import torch

    from hamer_yolo_tpu_torch.core.quant import quantize_weight_int8
    from hamer_yolo_tpu_torch.ops import int8_matmul as im
    from hamer_yolo_tpu_torch.ops import attn_proj_block as apb
    from hamer_yolo_tpu_torch.ops.attn_proj_block import (fused_int8_attn_proj_block,
                                                           fused_int8_attn_proj_block_ref)
    from hamer_yolo_tpu_torch.ops.short_attention import (fused_short_attention,
                                                          fused_short_attention_ref, occupancy)

    dev = tok0.device
    B, N, Kd = tok0.shape
    M = B * N
    hd = Kd // heads
    rng = np.random.default_rng(SEED + 3)

    def randn(*shape, scale=1.0):
        return torch.from_numpy((rng.normal(size=shape) * scale).astype(np.float32)).to(dev)

    print(f"int8 limits against the plain versions (ops/int8_matmul.py): float outputs, at most "
          f"{im.MAX_FRAC_ROWS_FLIPPED} of rows (K3 end to end: {apb.MAX_FRAC_ROWS_FLIPPED}) "
          f"beyond one rounding of max(|plain|, mean |plain|) and every error within "
          f"{im.MAX_ERR_OVER_MEAN} of the mean |plain|; int8 outputs, +-1 on at most "
          f"{im.MAX_FRAC_INT8_FLIPPED} of elements; K3's qkv, attention and proj steps each "
          "against the plain version of the step on the kernel's own input of it")
    a, mlp = blk["attn"], blk["mlp"]
    lin = {k: (p["wq"]["q"], p["wq"]["scale"], p["b"], p["sx"])
           for k, p in (("qkv", a["qkv"]), ("proj", a["proj"]), ("fc1", mlp["fc1"]),
                        ("fc2", mlp["fc2"]))}
    ln1 = (blk["norm1"]["scale"], blk["norm1"]["bias"])
    ln2 = (blk["norm2"]["scale"], blk["norm2"]["bias"])
    out = {}

    # K5: each prologue, dynamic and static, bf16 rows (the path's dtype)
    x_ln, x_id = randn(M, Kd).bfloat16(), randn(M, Kd).bfloat16()
    x_gelu = randn(M, 4 * Kd).bfloat16()
    k5_cases = {"ln": ("qkv", x_ln, ln1), "id": ("proj", x_id, (None, None)),
                "gelu": ("fc2", x_gelu, (None, None)), "gelu_poly": ("fc2", x_gelu, (None, None))}
    err = 0.0
    for pro, (name, x, (g, bt)) in k5_cases.items():
        q, s, b, sx = lin[name]
        for static in (None, sx):
            got = im.fused_int8_matmul(x, q, s, b, g, bt, prologue=pro, static_scale=static)
            torch.cuda.synchronize()
            r = im.check_against_plain(got, im.fused_int8_matmul_ref(
                x, q, s, b, g, bt, prologue=pro, static_scale=static), f"K5 {pro}")
            err = max(err, r["max_abs_err"])
            print(f"K5 {pro} {'static' if static is not None else 'dynamic'} "
                  f"({M}, {x.shape[1]}) x {tuple(q.shape)}: " + _fmt(r))
    # one block of the dynamic path: qkv (ln), proj (id), fc1 (ln), fc2 (gelu_poly)
    block = [("qkv", x_ln, "ln", ln1), ("proj", x_id, "id", (None, None)),
             ("fc1", x_ln, "ln", ln2), ("fc2", x_gelu, "gelu_poly", (None, None))]
    ms = plain_ms = gemm_ms = bound_ms = dev_ms = 0.0
    for name, x, pro, (g, bt) in block:
        q, s, b, _ = lin[name]
        ms += cuda_time_ms(lambda: im.fused_int8_matmul(x, q, s, b, g, bt, prologue=pro))
        dev_ms += graph_time_ms(lambda: im.fused_int8_matmul(x, q, s, b, g, bt, prologue=pro))
        plain_ms += cuda_time_ms(lambda: im.fused_int8_matmul_ref(x, q, s, b, g, bt, prologue=pro),
                                 iters=3)
        xq = torch.randint(-127, 128, x.shape, dtype=torch.int8, device=dev)
        gemm_ms += min(cuda_time_ms(lambda: torch._int_mm(xq, q)),
                       cuda_time_ms(lambda: torch._int_mm(xq, im.kmajor_weight(q).t())))
        Kx, Nx = q.shape
        bound_ms += bound(M * Kx * 2 + Kx * Nx + M * Nx * 2 + 8 * Nx, {"int8": 2 * M * Kx * Nx})[0]
    print(f"K5 timing over one block of the dynamic path (qkv, proj, fc1, fc2 at M = {M}): "
          f"kernel {ms:.4f} ms, device time alone (CUDA graph of 20 launches) {dev_ms:.4f} ms, "
          f"plain {plain_ms:.4f} ms, bound {bound_ms:.6f} ms (operations); torch._int_mm on the "
          f"bare int8 GEMMs (a GEMM only, no prologue, quantize or dequant; the faster of the "
          f"weight as (K, N) and as the transposed view of its (N, K) copy) {gemm_ms:.4f} ms")
    out["K5"] = {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
                 "bound_by": "operations", "library_ms": None}

    # K4: both GELU flavours, on the block-0 tokens and on random tokens
    (q1, s1, b1, sx1), (q2, s2, b2, sx2) = lin["fc1"], lin["fc2"]
    args = (q1, s1, b1, q2, s2, b2, *ln2, sx1, sx2)
    err = 0.0
    for gelu in ("gelu", "gelu_poly"):
        for tname, tok in (("block0_tokens", tok0), ("random", randn(B, N, Kd).bfloat16())):
            got = im.fused_int8_mlp_block(tok, *args, gelu=gelu)
            torch.cuda.synchronize()
            r = im.check_against_plain(got, im.fused_int8_mlp_block_ref(tok, *args, gelu=gelu),
                                       "K4")
            err = max(err, r["max_abs_err"])
            print(f"K4 {gelu} {tname} {tuple(tok.shape)}: " + _fmt(r))
    ms = cuda_time_ms(lambda: im.fused_int8_mlp_block(tok0, *args, gelu="gelu_poly"))
    dev_ms = graph_time_ms(lambda: im.fused_int8_mlp_block(tok0, *args, gelu="gelu_poly"))
    plain_ms = cuda_time_ms(lambda: im.fused_int8_mlp_block_ref(tok0, *args, gelu="gelu_poly"),
                            iters=3)
    H = q1.shape[1]
    bound_ms, by = bound(2 * M * Kd * 2 + 2 * Kd * H + 8 * (H + Kd), {"int8": 4 * M * Kd * H})
    print(f"K4 timing at {tuple(tok0.shape)}, H {H}, gelu_poly: kernel {ms:.4f} ms, device time "
          f"alone (CUDA graph of 20 launches) {dev_ms:.4f} ms, plain {plain_ms:.4f} ms, bound "
          f"{bound_ms:.6f} ms ({by}); no PyTorch call computes it")
    out["K4"] = {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
                 "bound_by": by, "library_ms": None}

    # K7: bf16 and int8 outputs at the main path's (16, 16, 192, 80), at unit
    # scale and with q and k times 8 (large logits: the max subtraction decides)
    from hamer_yolo_tpu_torch.ops.attn_block import check_against_twin

    qkv = randn(B, N, 3, heads, hd).bfloat16()
    q, k, v = (qkv[:, :, i].transpose(1, 2) for i in range(3))
    err = 0.0
    for mult in (1, 8):
        scaled = qkv * torch.tensor([mult, mult, 1], device=dev).reshape(3, 1, 1).bfloat16()
        qm, km, vm = (scaled[:, :, i].transpose(1, 2) for i in range(3))
        for sx in (None, lin["proj"][3]):
            got = fused_short_attention(qm, km, vm, out_scale=sx)
            torch.cuda.synchronize()
            ref = fused_short_attention_ref(qm, km, vm, out_scale=sx)
            if sx is None:  # the limits of K2's attention, whose math this is
                r = check_against_twin(got, ref)
            else:
                r = im.check_against_plain(got, ref, "K7")
            err = max(err, r["max_abs_err"])
            print(f"K7 {'bf16' if sx is None else 'int8 (out_scale)'} {tuple(q.shape)}, q and k "
                  f"x{mult}: " + _fmt(r))
    ms = cuda_time_ms(lambda: fused_short_attention(q, k, v))
    int8_ms = cuda_time_ms(lambda: fused_short_attention(q, k, v, out_scale=lin["proj"][3]))
    plain_ms = cuda_time_ms(lambda: fused_short_attention_ref(q, k, v))
    sdpa_ms = cuda_time_ms(lambda: torch.nn.functional.scaled_dot_product_attention(q, k, v))
    bound_ms, by = bound(4 * M * Kd * 2, {"bf16": 4 * B * heads * N * N * hd})
    occ = {name: occupancy(N, hd, dt) for name, dt in (("bf16", torch.bfloat16),
                                                       ("int8", torch.int8))}
    dev_ms = {"bf16": graph_time_ms(lambda: fused_short_attention(q, k, v)),
              "int8": graph_time_ms(lambda: fused_short_attention(q, k, v,
                                                                  out_scale=lin["proj"][3])),
              "sdpa": graph_time_ms(
                  lambda: torch.nn.functional.scaled_dot_product_attention(q, k, v))}
    print(f"K7 timing at {tuple(q.shape)} bf16: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
          f"scaled_dot_product_attention {sdpa_ms:.4f} ms, bound {bound_ms:.6f} ms ({by}); "
          f"with the int8 epilogue {int8_ms:.4f} ms; device time alone (CUDA graph of 20 "
          f"launches): bf16 {dev_ms['bf16']:.4f} ms, int8 {dev_ms['int8']:.4f} ms, "
          f"scaled_dot_product_attention {dev_ms['sdpa']:.4f} ms; the kernel at N {N}, hd {hd}: "
          + "; ".join(f"{name} out {o['registers']} registers a thread, {o['ctas_per_sm']} CTAs "
                      "an SM" for name, o in occ.items()))
    out["K7"] = {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
                 "bound_by": by, "library_ms": sdpa_ms}

    # K3: the main path's block-0 tokens, random tokens, and the tiny N = 12
    (q, s, b, sq), (pq, ps, pb, sp) = lin["qkv"], lin["proj"]
    args = (q, s, b, *ln1, sq, sp, pq, ps, pb, heads)
    err = 0.0
    for tname, tok in (("block0_tokens", tok0), ("random", randn(B, N, Kd).bfloat16())):
        steps = apb.fused_int8_attn_proj_block_steps(tok, *args)
        torch.cuda.synchronize()
        r = apb.check_against_plain(steps, tok, *args)
        err = max(err, r["max_abs_err"])
        print(f"K3 {tname} {tuple(tok.shape)}: " + _fmt(r))
    t12 = randn(4, 12, 64).bfloat16()
    wt, wp = quantize_weight_int8(randn(64, 192, scale=0.05)), quantize_weight_int8(
        randn(64, 64, scale=0.05))
    targs = (wt["q"], wt["scale"], 0.1 * randn(192), torch.ones(64, device=dev),
             torch.zeros(64, device=dev), torch.tensor(0.03, device=dev),
             torch.tensor(0.012, device=dev), wp["q"], wp["scale"], 0.1 * randn(64), 4)
    steps = apb.fused_int8_attn_proj_block_steps(t12, *targs)
    torch.cuda.synchronize()
    r = apb.check_against_plain(steps, t12, *targs)
    print(f"K3 tiny {tuple(t12.shape)}, 4 heads of 16: " + _fmt(r))
    ms = cuda_time_ms(lambda: fused_int8_attn_proj_block(tok0, *args))
    plain_ms = cuda_time_ms(lambda: fused_int8_attn_proj_block_ref(tok0, *args), iters=3)
    bound_ms, by = bound(2 * M * Kd * 2 + 3 * Kd * Kd + Kd * Kd + 8 * 4 * Kd,
                         {"int8": 2 * M * Kd * 4 * Kd, "bf16": 4 * B * N * N * Kd})
    print(f"K3 timing at {tuple(tok0.shape)}: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
          f"bound {bound_ms:.6f} ms ({by}); no PyTorch call computes it")
    out["K3"] = {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
                 "bound_by": by, "library_ms": None}
    return out


def int8_gemm_alone(dev, check=True):
    """The int8 GEMM launch of K3-K6 alone (ops/int8_matmul.int8_gemm), at
    ViT-H's four GEMM shapes for each M in GEMM_ROWS, with each GEMM's
    epilogue on the static int8 path (qkv: K3's folded dequant to bf16;
    proj: K3's residual in bf16; fc1: K4's GELU and int8 requantize; fc2:
    K4's f32-added residual) and with K5's per-row dequant (the dynamic
    path's, for all four): held bit for bit to int8_gemm_ref (EPI_GELU_Q:
    within +-1 on at most MAX_FRAC_INT8_FLIPPED of elements, its GELU may sit
    on an int8 rounding midpoint) where ``check``, and timed by CUDA graph
    replay beside torch._int_mm's bare GEMM (no epilogue), fed the weight as
    (K, N) and as the transposed view of its (N, K) copy, the faster being
    the yardstick. Returns {(shape, M): readings}."""
    import torch

    from hamer_yolo_tpu_torch.ops import int8_matmul as im

    rng = np.random.default_rng(SEED + 6)
    epilogues = {"qkv": im.EPI_DEQ_FOLD, "proj": im.EPI_PROJ, "fc1": im.EPI_GELU_Q,
                 "fc2": im.EPI_RESID}
    peak = PEAK_OPS_PER_S["int8"]
    out = {}
    for M in GEMM_ROWS:
        for name, (K, N) in VITH_GEMMS.items():
            a = torch.from_numpy(rng.integers(-127, 128, (M, K)).astype(np.int8)).to(dev)
            w = torch.from_numpy(rng.integers(-127, 128, (K, N)).astype(np.int8)).to(dev)
            ws = torch.from_numpy((1e-4 + 1e-3 * rng.random(N)).astype(np.float32)).to(dev)
            b = torch.from_numpy((0.1 * rng.normal(size=N)).astype(np.float32)).to(dev)
            res = torch.from_numpy(rng.normal(size=(M, N)).astype(np.float32)).to(dev).bfloat16()
            row_scale = torch.from_numpy((1e-3 + 0.02 * rng.random(M)).astype(np.float32)).to(dev)
            s = torch.tensor([0.02], device=dev)
            epi = epilogues[name]
            cases = {"static": (epi, {"s": s, "res": res if epi in (im.EPI_RESID, im.EPI_PROJ)
                                      else None,
                                      "out_scale": (torch.tensor([0.05], device=dev)
                                                    if epi == im.EPI_GELU_Q else None)}),
                     "dynamic": (im.EPI_DEQ_ROW, {"row_scale": row_scale})}
            r = {}
            for case, (e, kw) in cases.items():
                o = torch.empty((M, N), dtype=torch.int8 if e == im.EPI_GELU_Q else torch.bfloat16,
                                device=dev)
                im.int8_gemm(a, w, e, o, ws, b, **kw, gelu_poly=True)
                torch.cuda.synchronize()
                if check:
                    ref = im.int8_gemm_ref(a, w, e, ws, b, gelu="gelu_poly", **kw)
                    if e == im.EPI_GELU_Q:
                        im.check_against_plain(o, ref, f"the int8 GEMM {name} M {M}")
                    elif not torch.equal(o, ref):
                        raise AssertionError(f"the int8 GEMM {name} M {M} {case} differs from "
                                             f"int8_gemm_ref: max abs diff "
                                             f"{float((o.float() - ref.float()).abs().max())}")
                r[case] = graph_time_ms(lambda: im.int8_gemm(a, w, e, o, ws, b, **kw,
                                                             gelu_poly=True))
            w_nk = w.t().contiguous()
            r["int_mm_kn"] = graph_time_ms(lambda: torch._int_mm(a, w))
            r["int_mm_nk"] = graph_time_ms(lambda: torch._int_mm(a, w_nk.t()))
            ops = 2 * M * K * N
            rate = {k: ops / (v * 1e-3) for k, v in r.items()}
            lib = min(r["int_mm_kn"], r["int_mm_nk"])
            print(f"int8 GEMM alone {name} M {M} K {K} N {N}"
                  + (" (bit-identical to int8_gemm_ref; GELU within +-1)" if check else "")
                  + ": " + ", ".join(f"{k} {v:.4f} ms = {rate[k] / 1e12:.0f} TOP/s "
                                     f"({rate[k] / peak:.3f} of peak)" for k, v in r.items())
                  + f"; yardstick torch._int_mm {lib:.4f} ms (device time, CUDA graph of 20 "
                  f"launches)", flush=True)
            out[(name, M)] = r
    return out


def wrapper_host_us(dev, calls=200, rounds=7, k1=None, k2=None):
    """Host time of one call of the int8 GEMM's two wrappers,
    ops/int8_matmul.quantize_rows (LN prologue, static scale) and int8_gemm
    (K3's proj epilogue), at ViT-H's proj shape with 64 rows, where a
    launch's device time (printed beside, by CUDA graph replay) is below the
    wrapper's host time: the median over ``rounds`` of ``calls`` calls back
    to back on the host clock, the launches queueing on the card (a sync
    only between rounds). With ``k1`` (boxes, active, threshold) and ``k2``
    (tokens and K2's other arguments), also K1's and K2's two routes on
    them: the ctypes wrapper of the eager path and the dispatcher's operator
    of a traced program (ops/torch_ops.py). Returns {wrapper: microseconds}."""
    import torch

    from hamer_yolo_tpu_torch.ops import int8_matmul as im
    from hamer_yolo_tpu_torch.ops import torch_ops
    from hamer_yolo_tpu_torch.ops.attn_block import bf16_weight, fused_bf16_attn_block
    from hamer_yolo_tpu_torch.ops.nms import greedy_nms_keep_mask

    rng = np.random.default_rng(SEED + 7)
    M, (K, N) = 64, VITH_GEMMS["proj"]

    def put(v):
        return torch.from_numpy(v).to(dev)

    x = put(rng.normal(size=(M, K)).astype(np.float32)).bfloat16()
    g, b = put(np.ones(K, np.float32)), put(np.zeros(K, np.float32))
    a = put(rng.integers(-127, 128, (M, K)).astype(np.int8))
    w = put(rng.integers(-127, 128, (K, N)).astype(np.int8))
    ws, bias = put(np.full(N, 1e-3, np.float32)), put(np.zeros(N, np.float32))
    res = put(rng.normal(size=(M, N)).astype(np.float32)).bfloat16()
    out = torch.empty((M, N), dtype=torch.bfloat16, device=dev)
    s = torch.tensor([0.02], device=dev)
    fns = {"quantize_rows": lambda: im.quantize_rows(x, "ln", g, b, s, "quantize_rows"),
           "int8_gemm": lambda: im.int8_gemm(a, w, im.EPI_PROJ, out, ws, bias, s=s, res=res)}
    shapes = dict.fromkeys(fns, f"M {M} K {K} N {N}")
    # K1's and K2's routes are timed under inference mode, as a package runs;
    # the int8 GEMM's wrappers outside it, as PRs 9-17 timed them
    inference = set()
    if k1 is not None:
        fns.update({"greedy_nms_keep_mask (ctypes)": lambda: greedy_nms_keep_mask(*k1),
                    "hyt_port::greedy_nms_keep_mask": lambda: torch_ops.greedy_nms_keep_mask(*k1)})
        shapes.update(dict.fromkeys(list(fns)[-2:], f"boxes {tuple(k1[0].shape)}"))
        inference.update(list(fns)[-2:])
    if k2 is not None:
        # the operator takes the bf16 weight, as an exported program holds it
        k2_op = (k2[0], bf16_weight(k2[1]), *k2[2:])
        fns.update({"fused_bf16_attn_block (ctypes)": lambda: fused_bf16_attn_block(*k2),
                    "hyt_port::fused_bf16_attn_block":
                        lambda: torch_ops.fused_bf16_attn_block(*k2_op)})
        shapes.update(dict.fromkeys(list(fns)[-2:], f"tokens {tuple(k2[0].shape)}"))
        inference.update(list(fns)[-2:])
    us = {}
    for name, fn in fns.items():
        with torch.inference_mode(name in inference):
            times = host_times_us(fn, calls, rounds)
            us[name] = float(np.median(times))
            print(f"host time a call of {name} at {shapes[name]}: {us[name]:.2f} us (median of "
                  f"{rounds} x {calls} calls; spread {min(times):.2f}-{max(times):.2f}"
                  f"{'; inference mode' if name in inference else ''}); device time a launch "
                  f"{graph_time_ms(fn) * 1e3:.2f} us", flush=True)
    return us


# K3's forms (the switches HYT_SOFTMAX and HYT_ATTN_MATH) and K5's chain form
# (above FUSED_GEMM_MAX_M rows, with HYT_INT8_EP): their rows of the kernels
# line, each checked and timed in the phase "switches and chain".
K3_FORMS = {"K3 exp2": {"HYT_SOFTMAX": "exp2"}, "K3 exp2p": {"HYT_SOFTMAX": "exp2p"},
            "K3 int8": {"HYT_ATTN_MATH": "int8"},
            "K3 int8 exp2": {"HYT_ATTN_MATH": "int8", "HYT_SOFTMAX": "exp2"}}
K5_CHAINS = {"K5 chain": {}, "K5 chain bf16": {"HYT_INT8_EP": "bf16"}}
CHAIN_FRAMES = 16     # frames of the int8 dynamic batch that takes the chain: 16 x 4 x 192 rows
CHAIN_ROWS = 12288    # K5's chain form alone: ViT-H's four GEMMs at 16 frames' rows
LONG_N = 432         # tokens of a 384 x 288 crop at ViT-H's 16-pixel patches: past 256 keys
AUTO_CROPS = (64, 16)  # HYT_ATTN=auto: K7 from MIN_PALLAS_CROPS crops on the card, not below


def int8_products_beyond(dev, smi, args, randn, softmax, B, N, Kd, heads):
    """K3 under the int8 products at LONG_N tokens (16 crops at 384 x 288,
    ViT-H widths: three sweeps over 64-key blocks) against its plain version,
    then the attention step alone (the quantize pre-pass + the attention
    launch) timed at N and LONG_N beside K7's bf16 kernel with the int8
    epilogue on the same heads and the step's bytes bound (bf16 q, k, v read
    once, the int8 output written once). Returns the readings for the
    kernels line."""
    import torch

    from hamer_yolo_tpu_torch.ops import attn_proj_block as apb
    from hamer_yolo_tpu_torch.ops.short_attention import (fused_short_attention,
                                                          int8_products_attention)

    tok = randn(B, LONG_N, Kd).bfloat16()
    steps = apb.fused_int8_attn_proj_block_steps(tok, *args, softmax=softmax, attn_math="int8")
    torch.cuda.synchronize()
    r = apb.check_against_plain(steps, tok, *args, softmax=softmax, attn_math="int8")
    print(f"K3 int8 ({softmax}) random {tuple(tok.shape)}: " + _fmt(r), flush=True)
    out = {"long_n_max_abs_err": r["max_abs_err"]}
    sp = args[6]
    for n, t in ((N, randn(B, N, Kd).bfloat16()), (LONG_N, tok)):
        qkv = apb.fused_int8_attn_proj_block_steps(t, *args, softmax=softmax,
                                                   attn_math="int8")[0]
        hd = Kd // heads
        x = qkv.reshape(B, n, 3, heads, hd).permute(2, 0, 3, 1, 4)
        step = graph_time_ms(lambda: int8_products_attention(x[0], x[1], x[2], sp, softmax))
        k7 = graph_time_ms(lambda: fused_short_attention(x[0], x[1], x[2], out_scale=sp))
        bound_ms = bound(3 * B * n * Kd * 2 + B * n * Kd, {"int8": 4 * B * n * n * Kd})[0]
        print(f"K3 int8 ({softmax}) attention step alone at ({B}, {heads}, {n}, {hd}): device "
              f"{step:.4f} ms (CUDA graph of 20 launches of the pre-pass + attention), K7's "
              f"bf16 kernel with the int8 epilogue {k7:.4f} ms, bound {bound_ms:.6f} ms "
              f"(bytes) on {smi}", flush=True)
        out[f"step_ms_n{n}"], out[f"k7_ms_n{n}"], out[f"step_bound_ms_n{n}"] = step, k7, bound_ms
    return out


def switches_chain_phase(dev, smi, sparams, qparams, qcfg, mano, cfg, imgs, hws, Ks, tok0,
                         static_out, depth):
    """The phase "switches and chain". K3 under each of its forms
    (K3_FORMS) through infer_frames on the static path (their launches), then
    at full width against each form's plain version
    (attn_proj_block.check_against_plain) and timed, the int8 products also
    at LONG_N tokens and their attention step alone (int8_products_beyond);
    K5's chain form at
    CHAIN_ROWS for ViT-H's four GEMMs under both HYT_INT8_EP values against
    its plain version, timed beside K5's kernel form at the same rows; the
    int8 dynamic infer_frames at CHAIN_FRAMES frames, where every K5 call
    takes the chain (their launches); HYT_ATTN=auto launching K7 at 64
    crops and not at 16. Returns (records, launches) for the kernels line."""
    import torch

    from hamer_yolo_tpu_torch.core import quant
    from hamer_yolo_tpu_torch.ops import attn_proj_block as apb
    from hamer_yolo_tpu_torch.ops import int8_matmul as im
    from hamer_yolo_tpu_torch.ops.attn_proj_block import (fused_int8_attn_proj_block,
                                                           fused_int8_attn_proj_block_ref,
                                                           variant_name)
    from hamer_yolo_tpu_torch.pipeline.frame import infer_frames

    t_phase = time.perf_counter()
    B, N, Kd = tok0.shape
    M = B * N
    heads = cfg.hamer.vit.num_heads
    records, launches = {}, {}
    rng = np.random.default_rng(SEED + 19)

    def randn(*shape):
        return torch.from_numpy(rng.normal(size=shape).astype(np.float32)).to(dev)

    # -- K3's forms: the main path's launches, then full width alone --------
    blk = sparams["hamer"]["backbone"]["blocks"][0]
    a = blk["attn"]
    args = (a["qkv"]["wq"]["q"], a["qkv"]["wq"]["scale"], a["qkv"]["b"], blk["norm1"]["scale"],
            blk["norm1"]["bias"], a["qkv"]["sx"], a["proj"]["sx"], a["proj"]["wq"]["q"],
            a["proj"]["wq"]["scale"], a["proj"]["b"], heads)
    base_ms = cuda_time_ms(lambda: fused_int8_attn_proj_block(tok0, *args))
    base_dev_ms = graph_time_ms(lambda: fused_int8_attn_proj_block(tok0, *args))
    for key, env in K3_FORMS.items():
        with torch.inference_mode(), switches(env):
            out, n = run_counted(lambda: infer_frames(sparams, mano, imgs, hws, Ks, qcfg))
        expect_launches(f"int8 static with {env}", n, {"K3": depth, "K4": depth, key: depth,
                                                       **dict.fromkeys(("K5", "K6", "K7"), 0)})
        check_batch(out, cfg, f"int8 static infer_frames with {env}")
        both = out["valid"] & static_out["valid"]
        dist = float((out["keypoints_3d"] - static_out["keypoints_3d"]).norm(dim=-1)[both].mean())
        launches[key] = n.get(key, 0)
        sm = env.get("HYT_SOFTMAX", "exp")
        am = env.get("HYT_ATTN_MATH", "bf16")
        assert variant_name(sm, am) == key[3:]
        err = 0.0
        for tname, tok in (("block0_tokens", tok0), ("random", randn(B, N, Kd).bfloat16())):
            steps = apb.fused_int8_attn_proj_block_steps(tok, *args, softmax=sm, attn_math=am)
            torch.cuda.synchronize()
            r = apb.check_against_plain(steps, tok, *args, softmax=sm, attn_math=am)
            err = max(err, r["max_abs_err"])
            print(f"{key} {tname} {tuple(tok.shape)}: " + _fmt(r))
        ms = cuda_time_ms(lambda: fused_int8_attn_proj_block(tok0, *args, softmax=sm,
                                                             attn_math=am))
        dev_ms = graph_time_ms(lambda: fused_int8_attn_proj_block(tok0, *args, softmax=sm,
                                                                  attn_math=am))
        plain_ms = cuda_time_ms(lambda: fused_int8_attn_proj_block_ref(tok0, *args, sm, am),
                                iters=3)
        attn_ops = {"int8" if am == "int8" else "bf16": 4 * B * N * N * Kd}
        ops = {"int8": 2 * M * Kd * 4 * Kd}
        for kind, v in attn_ops.items():
            ops[kind] = ops.get(kind, 0) + v
        bound_ms, by = bound(2 * M * Kd * 2 + 3 * Kd * Kd + Kd * Kd + 8 * 4 * Kd, ops)
        print(f"{key} through infer_frames b{BATCH} {env}: launches {n}; mean joint distance to "
              f"the default static path {dist * 1e3:.4f} mm; timing at {tuple(tok0.shape)}: "
              f"kernel {ms:.4f} ms (default form {base_ms:.4f} ms), device time alone (CUDA "
              f"graph of 20 launches) {dev_ms:.4f} ms (default form {base_dev_ms:.4f} ms), "
              f"plain {plain_ms:.4f} ms, bound "
              f"{bound_ms:.6f} ms ({by}) on {smi}", flush=True)
        records[key] = {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
                        "bound_by": by, "library_ms": None}
        if am == "int8":
            records[key].update(int8_products_beyond(dev, smi, args, randn, sm, B, N, Kd, heads))

    # -- K5's chain form alone at CHAIN_ROWS ---------------------------------
    qblk = qparams["hamer"]["backbone"]["blocks"][0]
    lin = {k: (p["wq"]["q"], p["wq"]["scale"], p["b"])
           for k, p in (("qkv", qblk["attn"]["qkv"]), ("proj", qblk["attn"]["proj"]),
                        ("fc1", qblk["mlp"]["fc1"]), ("fc2", qblk["mlp"]["fc2"]))}
    ln = {"qkv": (qblk["norm1"]["scale"], qblk["norm1"]["bias"]),
          "fc1": (qblk["norm2"]["scale"], qblk["norm2"]["bias"])}
    pros = {"qkv": "ln", "proj": "id", "fc1": "ln", "fc2": "gelu_poly"}
    xs = {name: randn(CHAIN_ROWS, VITH_GEMMS[name][0]).bfloat16() for name in pros}
    for key, env in K5_CHAINS.items():
        err, ms, dev_ms, form_ms, plain_ms, bound_ms = 0.0, 0.0, 0.0, 0.0, 0.0, 0.0
        with switches(env):
            for name, pro in pros.items():
                x, (q, s, b) = xs[name], lin[name]
                g, bt = ln.get(name, (None, None))
                for static in (None, torch.tensor(0.031, device=dev)):
                    got = im.fused_int8_matmul(x, q, s, b, g, bt, prologue=pro,
                                               static_scale=static)
                    torch.cuda.synchronize()
                    ref = im.fused_int8_matmul_ref(x, q, s, b, g, bt, prologue=pro,
                                                   static_scale=static)
                    r = im.check_against_plain(got, ref, key)
                    err = max(err, r["max_abs_err"])
                    print(f"{key} {name} {pro} {'static' if static is not None else 'dynamic'} "
                          f"({CHAIN_ROWS}, {x.shape[1]}) x {tuple(q.shape)}: " + _fmt(r)
                          + f"; bit-equal {bool(torch.equal(got, ref))}")
                call = (lambda force: lambda: im.fused_int8_matmul(x, q, s, b, g, bt, prologue=pro,
                                                                   force=force))
                t_chain, t_form = cuda_time_ms(call(None)), cuda_time_ms(call("pallas"))
                g_chain, g_form = graph_time_ms(call(None)), graph_time_ms(call("pallas"))
                ms += t_chain
                dev_ms += g_chain
                form_ms += g_form
                plain_ms += cuda_time_ms(lambda: im.fused_int8_matmul_ref(
                    x, q, s, b, g, bt, prologue=pro), iters=3)
                Kx, Nx = q.shape
                bound_ms += bound(CHAIN_ROWS * Kx * 2 + Kx * Nx + CHAIN_ROWS * Nx * 2 + 8 * Nx,
                                  {"int8": 2 * CHAIN_ROWS * Kx * Nx})[0]
                print(f"{key} {name} timing: chain {t_chain:.4f} ms (CUDA graph {g_chain:.4f}), "
                      f"kernel form {t_form:.4f} ms (CUDA graph {g_form:.4f})", flush=True)
        print(f"{key} over ViT-H's four GEMMs at M = {CHAIN_ROWS} (dynamic): kernel {ms:.4f} ms, "
              f"device time alone (CUDA graph of 20 launches) {dev_ms:.4f} ms against K5's "
              f"kernel form {form_ms:.4f} ms, plain {plain_ms:.4f} ms, bound {bound_ms:.6f} ms "
              f"(operations) on {smi}", flush=True)
        records[key] = {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
                        "bound_by": "operations", "library_ms": None}

    # -- the int8 dynamic infer_frames at CHAIN_FRAMES frames: the chain -----
    frames16 = frames_720p(CHAIN_FRAMES, SEED + 16)
    imgs16 = torch.from_numpy(np.stack(frames16)).to(dev).to(torch.float32)
    hws16 = torch.tensor([[720.0, 1280.0]] * CHAIN_FRAMES, device=dev)
    Ks16 = Ks[:1].expand(CHAIN_FRAMES, 3, 3).contiguous()
    rows = CHAIN_FRAMES * cfg.max_hands * cfg.hamer.vit.num_tokens
    if rows <= im.FUSED_GEMM_MAX_M:
        raise RuntimeError(f"{rows} rows do not cross FUSED_GEMM_MAX_M = {im.FUSED_GEMM_MAX_M}")
    for key, env in K5_CHAINS.items():
        with torch.inference_mode(), switches(env):
            out, n = run_counted(lambda: infer_frames(qparams, mano, imgs16, hws16, Ks16, qcfg))
            e2e = cuda_time_ms(lambda: infer_frames(qparams, mano, imgs16, hws16, Ks16, qcfg),
                               iters=3, warmup=1)
        expect_launches(f"int8 dynamic b{CHAIN_FRAMES} {env}", n,
                        {"K5": 4 * depth, key: 4 * depth, "K7": depth,
                         **dict.fromkeys(("K3", "K4", "K6", "K8", "K10"), 0)})
        check_batch(out, cfg, f"int8 dynamic infer_frames b{CHAIN_FRAMES} {env}", CHAIN_FRAMES)
        launches[key] = n.get(key, 0)
        print(f"int8 dynamic infer_frames b{CHAIN_FRAMES} 720p {env} (M = {rows} rows a GEMM, "
              f"every K5 call in the chain form): {int(out['valid'].sum())} valid slots, "
              f"launches {n}; e2e p50 {e2e:.2f} ms (CUDA events, 1 warm-up, 3 timed) on {smi}",
              flush=True)

    # -- HYT_ATTN=auto: K7 from MIN_PALLAS_CROPS crops on the card -----------
    with torch.inference_mode(), switches({"HYT_ATTN": "auto"}):
        for crops in AUTO_CROPS:
            tok = randn(crops, N, Kd).bfloat16()
            _, n = run_counted(lambda: quant.int8_block_attn_fused(qblk, tok, heads))
            want = 1 if crops >= 64 else 0
            expect_launches(f"HYT_ATTN=auto at {crops} crops", n, {"K7": want, "K5": 2})
            print(f"HYT_ATTN=auto at {crops} crops: launches {n} (K7 {want})")
    print(f"phase \"switches and chain\": {time.perf_counter() - t_phase:.1f} s", flush=True)
    return records, launches


def check_optin_kernels(blk, tok0, heads, mano, pred_mano, k3_ms, k4_ms, k7_ms):
    """K6, K8, K9 and K10 against their plain versions at the main path's
    shapes (16 crops x 192 tokens of ViT-H, 16 hands), on the int8 weights and
    calibrated scales of block 0 and the MANO head's own outputs; timings
    there, beside the kernel each is an option to."""
    import torch

    from hamer_yolo_tpu_torch.models.mano import lbs
    from hamer_yolo_tpu_torch.ops import attn_block_int8 as abi
    from hamer_yolo_tpu_torch.ops import int8_matmul as im
    from hamer_yolo_tpu_torch.ops import mano_lbs
    from hamer_yolo_tpu_torch.ops.attn_block import check_against_twin
    from hamer_yolo_tpu_torch.ops.short_attention import (fused_qkv_attention,
                                                          fused_qkv_attention_ref,
                                                          fused_short_attention)

    dev = tok0.device
    B, N, Kd = tok0.shape
    M = B * N
    hd = Kd // heads
    rng = np.random.default_rng(SEED + 5)

    def randn(*shape):
        return torch.from_numpy(rng.normal(size=shape).astype(np.float32)).to(dev)

    a, mlp = blk["attn"], blk["mlp"]
    lin = {k: (p["wq"]["q"], p["wq"]["scale"], p["b"], p["sx"])
           for k, p in (("qkv", a["qkv"]), ("proj", a["proj"]), ("fc1", mlp["fc1"]),
                        ("fc2", mlp["fc2"]))}
    ln1 = (blk["norm1"]["scale"], blk["norm1"]["bias"])
    ln2 = (blk["norm2"]["scale"], blk["norm2"]["bias"])
    out = {}

    # K6: step by step at K3's limits, on the block-0 tokens and random tokens
    (q, s, b, sq), (pq, ps, pb, sp) = lin["qkv"], lin["proj"]
    args = (q, s, b, *ln1, sq, sp, heads)
    print(f"K6 limits (ops/attn_block_int8.py): its qkv and attention steps at K3's limits for "
          f"them; end to end at most {abi.MAX_INT8_STEPS_END_TO_END} int8 steps, on at most "
          f"{im.MAX_FRAC_INT8_FLIPPED} of elements")
    err = 0.0
    for tname, tok in (("block0_tokens", tok0), ("random", randn(B, N, Kd).bfloat16())):
        steps = abi.fused_int8_attn_block_steps(tok, *args)
        torch.cuda.synchronize()
        r = abi.check_against_plain(steps, tok, *args)
        err = max(err, r["max_abs_err"])
        print(f"K6 {tname} {tuple(tok.shape)}: " + _fmt(r))
    ms = cuda_time_ms(lambda: abi.fused_int8_attn_block(tok0, *args))
    plain_ms = cuda_time_ms(lambda: abi.fused_int8_attn_block_ref(tok0, *args), iters=3)
    aq = abi.fused_int8_attn_block(tok0, *args)
    proj_ms = cuda_time_ms(lambda: im.int8_dot_prequant(aq, pq, ps, pb, sp))
    bound_ms, by = bound(M * Kd * 2 + 3 * Kd * Kd + M * Kd + 8 * 4 * Kd,
                         {"int8": 2 * M * Kd * 3 * Kd, "bf16": 4 * B * N * N * Kd})
    print(f"K6 timing at {tuple(tok0.shape)}: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, bound "
          f"{bound_ms:.6f} ms ({by}); no PyTorch call computes it. The proj product that follows "
          f"it on its path (int8_dot_prequant, a plain exact product as f64 matmul, not a "
          f"kernel): {proj_ms:.4f} ms; K3, which it is an option to, {k3_ms:.4f} ms")
    out["K6"] = {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
                 "bound_by": by, "library_ms": None}

    # K8: bf16, bf16 -> int8 and f32 at (16, 192, 3840); equal to K7 on views
    qkv32 = randn(B, N, 3 * Kd)
    err = 0.0
    for name, x, sx in (("bf16", qkv32.bfloat16(), None), ("bf16 -> int8", qkv32.bfloat16(), sp),
                        ("f32", qkv32, None)):
        got = fused_qkv_attention(x, heads, out_scale=sx)
        torch.cuda.synchronize()
        ref = fused_qkv_attention_ref(x, heads, out_scale=sx)
        if sx is not None:
            r = im.check_against_plain(got, ref, "K8")
        elif x.dtype == torch.bfloat16:  # the limits of K2's attention, whose math this is
            r = check_against_twin(got, ref)
        else:  # f32 products and sums of 80 and 192 terms in another order, |out| <= 1
            r = {"max_abs_err": float((got - ref).abs().max())}
            if not r["max_abs_err"] <= F32_ATTN_ATOL:
                raise AssertionError(f"K8 f32 disagrees with its plain version: {r} (limit "
                                     f"{F32_ATTN_ATOL})")
        heads_view = x.reshape(B, N, 3, heads, hd)
        k7 = fused_short_attention(*(heads_view[:, :, i].transpose(1, 2) for i in range(3)),
                                   out_scale=sx)
        if not torch.equal(k7.transpose(1, 2).reshape(B, N, Kd), got):
            raise AssertionError(f"K8 {name} differs from K7 on views of the same tensor")
        err = max(err, r["max_abs_err"])
        print(f"K8 {name} {tuple(x.shape)} (equal to K7 bit for bit): " + _fmt(r))
    x = qkv32.bfloat16()
    qv, kv, vv = (x.reshape(B, N, 3, heads, hd)[:, :, i].transpose(1, 2) for i in range(3))
    ms = cuda_time_ms(lambda: fused_qkv_attention(x, heads))
    plain_ms = cuda_time_ms(lambda: fused_qkv_attention_ref(x, heads))
    sdpa_ms = cuda_time_ms(lambda: torch.nn.functional.scaled_dot_product_attention(qv, kv, vv))
    f32_ms = cuda_time_ms(lambda: fused_qkv_attention(qkv32, heads))
    bound_ms, by = bound(4 * M * Kd * 2, {"bf16": 4 * B * heads * N * N * hd})
    dev_ms = graph_time_ms(lambda: fused_qkv_attention(x, heads))
    sdpa_dev_ms = graph_time_ms(
        lambda: torch.nn.functional.scaled_dot_product_attention(qv, kv, vv))
    print(f"K8 timing at {tuple(x.shape)} bf16: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
          f"scaled_dot_product_attention {sdpa_ms:.4f} ms, bound {bound_ms:.6f} ms ({by}); K7, "
          f"which it is an option to, {k7_ms:.4f} ms; with f32 inputs {f32_ms:.4f} ms; device "
          f"time alone (CUDA graph of 20 launches) {dev_ms:.4f} ms, scaled_dot_product_attention "
          f"{sdpa_dev_ms:.4f} ms")
    out["K8"] = {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
                 "bound_by": by, "library_ms": sdpa_ms}

    # K9: the MANO head's own betas and rotations for the batch's 16 hands
    betas = pred_mano["betas"]
    rotmats = torch.cat([pred_mano["global_orient"], pred_mano["hand_pose"]], dim=1)
    S, nb = betas.shape
    mano_lbs.mano_lbs_fused(mano, betas, rotmats)  # makes the model's constants
    for _ in range(3):  # now and then the profiler records no device activity at all
        before = mano_lbs.mano_lbs_fused.launches
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
            verts, joints = mano_lbs.mano_lbs_fused(mano, betas, rotmats)
            torch.cuda.synchronize()
        device_kernels = [e.name for e in prof.events()
                          if e.device_type == torch.autograd.DeviceType.CUDA]
        if mano_lbs.mano_lbs_fused.launches != before + 1:
            raise AssertionError(f"K9's wrapper counted "
                                 f"{mano_lbs.mano_lbs_fused.launches - before} launches a call")
        if device_kernels:
            break
    if len(device_kernels) != 1:
        raise AssertionError(f"K9 made {len(device_kernels)} device launches in one call "
                             f"({device_kernels})")
    ref_v, ref_j = mano_lbs.mano_lbs_fused_ref(mano, betas, rotmats)
    r = mano_lbs.check_against_plain(verts, ref_v)
    r["joints_max_abs_err"] = mano_lbs.check_against_plain(joints, ref_j,
                                                           "K9's joints")["max_abs_err"]
    lbs_v, lbs_j = lbs(mano, betas, rotmats)
    r["vs_einsum_lbs_verts"] = float((verts - lbs_v).abs().max())
    r["vs_einsum_lbs_joints"] = float((joints - lbs_j).abs().max())
    if max(r["vs_einsum_lbs_verts"], r["vs_einsum_lbs_joints"]) > mano_lbs.MAX_ABS_ERR_M:
        raise AssertionError(f"K9 departs from the einsum LBS: {r}")
    print(f"K9 {S} hands, nb {nb}, one device launch a call ({device_kernels[0][:40]}; limit "
          f"{mano_lbs.MAX_ABS_ERR_M} m, absolute, on vertices and joints): " + _fmt(r))
    ms = cuda_time_ms(lambda: mano_lbs.mano_lbs_fused(mano, betas, rotmats))
    dev_ms = graph_time_ms(lambda: mano_lbs.mano_lbs_fused(mano, betas, rotmats))
    plain_ms = cuda_time_ms(lambda: mano_lbs.mano_lbs_fused_ref(mano, betas, rotmats))
    lbs_ms = cuda_time_ms(lambda: lbs(mano, betas, rotmats))
    V = 778
    # the model's arrays and constants, the hands' betas and rotations in,
    # vertices and joints out; two products per blendshape term, the blend,
    # the affine, the kinematics
    bound_ms, by = bound(4 * (3 * V * (nb + 135 + 1) + V * 16 + 16 * 3 * (nb + 1)
                              + S * (nb + 16 * 9) + S * V * 3 + S * 16 * 3),
                         {"f32": S * (2 * 3 * V * (nb + 135) + 2 * V * 16 * 12 + 18 * V
                                      + 16 * (2 * 3 * nb + 90))})
    print(f"K9 timing at {S} hands: one launch with its host work {ms:.4f} ms, device time "
          f"alone (CUDA graph of 20 launches) {dev_ms:.4f} ms; plain {plain_ms:.4f} ms; bound "
          f"{bound_ms:.6f} ms ({by}); no PyTorch call computes it; the einsum LBS, which it is "
          f"an option to, {lbs_ms:.4f} ms")
    out["K9"] = {"max_abs_err": max(r["max_abs_err"], r["joints_max_abs_err"]), "ms": ms,
                 "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": by, "library_ms": None}

    # K10: equal to K4 bit for bit, both GELU flavours and token dtypes, and
    # within K4's limits of its plain version
    (q1, s1, b1, sx1), (q2, s2, b2, sx2) = lin["fc1"], lin["fc2"]
    args = (q1, s1, b1, q2, s2, b2, *ln2, sx1, sx2)
    err = 0.0
    for gelu in ("gelu", "gelu_poly"):
        for tname, tok in (("block0_tokens", tok0), ("random", randn(B, N, Kd).bfloat16()),
                           ("block0_tokens_f32", tok0.float())):
            got = im.fused_int8_mlp_block1(tok, *args, gelu=gelu)
            torch.cuda.synchronize()
            if not torch.equal(got, im.fused_int8_mlp_block(tok, *args, gelu=gelu)):
                raise AssertionError(f"K10 {gelu} {tname} is not K4 bit for bit")
            r = im.check_against_plain(got, im.fused_int8_mlp_block1_ref(tok, *args, gelu=gelu),
                                       "K10")
            err = max(err, r["max_abs_err"])
            print(f"K10 {gelu} {tname} {tuple(tok.shape)} {tok.dtype} (equal to K4 bit for "
                  f"bit): " + _fmt(r))
    ms = cuda_time_ms(lambda: im.fused_int8_mlp_block1(tok0, *args, gelu="gelu_poly"))
    dev_ms = graph_time_ms(lambda: im.fused_int8_mlp_block1(tok0, *args, gelu="gelu_poly"))
    plain_ms = cuda_time_ms(lambda: im.fused_int8_mlp_block1_ref(tok0, *args, gelu="gelu_poly"),
                            iters=3)
    H = q1.shape[1]
    bound_ms, by = bound(2 * M * Kd * 2 + 2 * Kd * H + 8 * (H + Kd), {"int8": 4 * M * Kd * H})
    cluster = im.mlp1_cluster(Kd)
    print(f"K10 timing at {tuple(tok0.shape)}, H {H}, gelu_poly: kernel {ms:.4f} ms, device time "
          f"alone (CUDA graph of 20 launches) {dev_ms:.4f} ms = "
          f"{4 * M * Kd * H / (dev_ms * 1e-3) / 1e12:.0f} TOP/s, {bound_ms / dev_ms:.3f} of its "
          f"bound; plain {plain_ms:.4f} ms, bound {bound_ms:.6f} ms ({by}); no PyTorch call "
          f"computes it; K4, which it is an option to, {k4_ms:.4f} ms. Its {-(-M // 64)} "
          f"clusters of {cluster} CTAs each read both weights once")
    out["K10"] = {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
                  "bound_by": by, "library_ms": None}
    return out


def _fmt(r):
    return ", ".join(f"{k} {v:.6g}" for k, v in r.items())


def _small_config(dtype, vit=None):
    """The tiny detector, SAR (ResNet-34 at 64 x 64) and MANO head with a
    2-block ViT at 192 tokens, at one compute dtype."""
    from hamer_yolo_tpu_torch.cli.main import pipeline_config
    from hamer_yolo_tpu_torch.models.vit import ViTConfig

    tiny = pipeline_config(tiny=True, max_hands=2)
    vit = vit or ViTConfig(embed_dim=64, depth=2, num_heads=4, compute_dtype=dtype,
                           fused_attn=False)
    return dataclasses.replace(
        tiny, crop_size=256,
        yolo=dataclasses.replace(tiny.yolo, compute_dtype=dtype),
        hamer=dataclasses.replace(tiny.hamer, image_size=256, crop_margin=32, vit=vit),
        sar=dataclasses.replace(tiny.sar, compute_dtype=dtype))


def _small_inputs(rng):
    import torch

    imgs = torch.from_numpy(rng.integers(0, 256, (2, 120, 160, 3)).astype(np.float32))
    hws = torch.tensor([[120.0, 160.0]] * 2)
    Ks = torch.from_numpy(np.stack([np.float32([[200, 0, 80], [0, 200, 60], [0, 0, 1]])] * 2))
    return imgs, hws, Ks


def check_reference(dev) -> None:
    """The port on the card against the port on the CPU on a small input.

    (1) The whole path at f32 (the tiny detector, a 2-block ViT at 192
    tokens with 4 heads of 16, the tiny MANO head) with the plain attention
    on both devices: K1 runs on the card, all else is the same torch code on
    two devices, so outputs agree to f32 sum order, at the JAX package's
    composed-oracle tolerances. (2) That ViT, in f32 and in bf16, with K2 on
    the card against K2's twin on the CPU, at the JAX package's bf16
    tolerance (K2 rounds to bf16 inside at either dtype). (K2 end to end is
    not compared: the MANO head's 6d -> Gram-Schmidt step divides by
    |a2 - (b1.a2) b1|, which random weights can make small, so one bf16 ulp
    of the head output moves a rotation element by ~0.06.)
    """
    import torch

    from hamer_yolo_tpu_torch.core.checkpoint import init_pipeline_params
    from hamer_yolo_tpu_torch.core.mano_assets import synthetic_mano_model
    from hamer_yolo_tpu_torch.geometry.rotations import aa_to_rotmat
    from hamer_yolo_tpu_torch.models.mano import ManoModel
    from hamer_yolo_tpu_torch.models.vit import vit_forward
    from hamer_yolo_tpu_torch.ops.attn_block import fused_bf16_attn_block
    from hamer_yolo_tpu_torch.ops.nms import greedy_nms_keep
    from hamer_yolo_tpu_torch.pipeline.frame import infer_frames

    cfg = _small_config("float32")
    vit32 = cfg.hamer.vit
    cpu = torch.device("cpu")
    mano_np = synthetic_mano_model(SEED)
    params = init_pipeline_params(SEED, ManoModel.from_arrays(mano_np, cpu), cfg.yolo, cfg.hamer,
                                  cfg.sar, device=cpu)
    params_gpu = _to(params, dev)
    rng = np.random.default_rng(SEED + 1)
    imgs, hws, Ks = _small_inputs(rng)
    with torch.inference_mode():
        ref = infer_frames(params, ManoModel.from_arrays(mano_np, cpu), imgs, hws, Ks, cfg)
        before = greedy_nms_keep.launches
        got = infer_frames(params_gpu, ManoModel.from_arrays(mano_np, dev), imgs.to(dev),
                           hws.to(dev), Ks.to(dev), cfg)
        got = {k: v.cpu() for k, v in got.items()}
    if greedy_nms_keep.launches - before != 1:
        raise RuntimeError("the reference check did not run K1")
    n_valid = int(ref["valid"].sum())
    if n_valid == 0 or int(got["valid"].sum()) != n_valid:
        raise RuntimeError(f"valid slots: card {int(got['valid'].sum())}, cpu {n_valid}")
    worst = {}
    for b, s in zip(*np.nonzero(ref["valid"].numpy())):
        hit = np.nonzero((got["valid"][b] & (got["boxes"][b] == ref["boxes"][b, s]).all(-1))
                         .numpy())[0]
        if hit.size == 0:
            raise RuntimeError(f"reference box {ref['boxes'][b, s].tolist()} not found on the card")
        j = int(hit[0])
        for k, v in ref.items():
            if not v.is_floating_point():
                continue
            r, g = v[b, s].double(), got[k][b, j].double()
            # the JAX package's composed-oracle tolerances
            # (tests/test_composed_entrypoints.py:215-236)
            tol = 2e-3
            if k in AXIS_ANGLE_KEYS:
                # its aa tolerance, compared as rotations: axis-angle is
                # ill-conditioned near pi (axis sign, 2 pi wrap)
                r, g = (aa_to_rotmat(t.reshape(-1, 3)) for t in (r, g))
                tol = 5e-3
            torch.testing.assert_close(g, r, rtol=tol, atol=tol, msg=lambda m: f"{k}: {m}")
            worst[k] = max(worst.get(k, 0.0), float((g - r).abs().max()))
    print(f"reference check f32 (card vs CPU, small config, {n_valid} valid slots), max abs "
          "diff: " + ", ".join(f"{k} {v:.3g}" for k, v in sorted(worst.items())))

    x = torch.from_numpy(rng.normal(size=(4, 256, 192, 3)).astype(np.float32))
    for dtype in ("float32", "bfloat16"):
        vit = dataclasses.replace(vit32, compute_dtype=dtype, fused_attn=None)
        with torch.inference_mode():
            # K2's twin on the CPU
            ref = vit_forward(params["hamer"]["backbone"], x,
                              dataclasses.replace(vit, fused_attn=True)).float()
            before = fused_bf16_attn_block.launches
            got = vit_forward(params_gpu["hamer"]["backbone"], x.to(dev), vit)  # K2 by default
            got = got.float().cpu()
        if fused_bf16_attn_block.launches - before != vit.depth:
            raise RuntimeError(f"the {dtype} ViT on the card did not run K2 in every block")
        # bf16 roundings inside K2 on two devices, sums in other orders: the
        # JAX package's bf16 tolerance (tests/test_pallas_kernels.py:164-167)
        torch.testing.assert_close(got, ref, rtol=0.05, atol=0.05)
        print(f"reference check {dtype} ViT (K2 on the card vs its twin on the CPU, tokens "
              f"{tuple(got.shape)}): max abs diff {float((got - ref).abs().max()):.4g}, "
              f"max |ref| {float(ref.abs().max()):.4g}")
    check_reference_rootnet(params, params_gpu, cfg.sar, rng, dev)


def check_reference_rootnet(params, params_gpu, sar_cfg, rng, dev) -> None:
    """RootNet in bf16, cuDNN's convolutions on the card against the CPU's,
    on 16 random patches (the f32 trunk is held at 2e-3 in check_reference's
    pipeline). A conv sum rounded the other way in bf16 is amplified by the
    36 random layers as far as bf16 itself moves it from f32, so the card is
    held to the CPU's bf16 accuracy, as the CPU tests hold the port against
    JAX (tests/test_torch_sar.py): its largest distance from the CPU's f32
    trunk at most BF16_ACCURACY_FACTOR times the CPU bf16 trunk's."""
    import torch

    from hamer_yolo_tpu_torch.models.sar import estimate_root_depth

    x = torch.from_numpy(rng.normal(size=(16, sar_cfg.input_size, sar_cfg.input_size, 3))
                         .astype(np.float32))
    k = torch.from_numpy(rng.uniform(0.5, 2.0, 16).astype(np.float32))
    bf16 = dataclasses.replace(sar_cfg, compute_dtype="bfloat16")
    f32 = dataclasses.replace(sar_cfg, compute_dtype="float32")
    with torch.inference_mode():
        cpu16 = estimate_root_depth(params["sar"], x, k, bf16).double()
        cpu32 = estimate_root_depth(params["sar"], x, k, f32).double()
        card16 = estimate_root_depth(params_gpu["sar"], x.to(dev), k.to(dev), bf16).double().cpu()
    if not torch.isfinite(card16).all():
        raise RuntimeError("RootNet on the card: root depth not finite")
    acc, floor = float((card16 - cpu32).abs().max()), float((cpu16 - cpu32).abs().max())
    print(f"reference check bf16 RootNet (16 patches of {sar_cfg.input_size}^2): max |card bf16 "
          f"- CPU f32| {acc:.4g}, max |CPU bf16 - CPU f32| {floor:.4g} (limit x"
          f"{BF16_ACCURACY_FACTOR}), max |card bf16 - CPU bf16| "
          f"{float((card16 - cpu16).abs().max()):.4g}, max |depth| {float(cpu32.abs().max()):.4g}")
    if not acc <= BF16_ACCURACY_FACTOR * floor:
        raise AssertionError(f"bf16 RootNet on the card is {acc:.4g} from the f32 trunk, beyond "
                             f"{BF16_ACCURACY_FACTOR} x the CPU bf16 trunk's {floor:.4g}")


def check_reference_int8(dev) -> None:
    """The int8 slice on the card against the same slice on the CPU, at the
    small config: an f32 detector (so both devices crop the same boxes) and a
    bf16 int8 ViT (the CLI's dtype), calibrated on the CPU; the kernels on
    the card, their plain versions on the CPU (fused), with the static scales
    (K3, K4) and without (K5, K7), and each again under the switches of the
    opt-in paths (A: K6, K10 and the fused LBS K9; B: K5, K8); then the
    --tiny ViT (N = 12, heads of 16) the same way. The devices part where a sum in another order moves a
    value across an int8 rounding midpoint, and cuDNN's bf16 patch embedding
    already differs from the CPU's in the last bit. So the ViT blocks are
    compared on the same embedded tokens, with the card's polynomial GELU on
    both devices, at the JAX package's limit for int8 rounding flips
    (tests/test_int8_fused.py:330-334: 99% of elements within 0.02, all
    within 0.2 relative and 0.1 absolute), and the slice's mesh and joints at
    that limit's outer bound (random-weight MANO heads amplify the
    backbone's differences). The slice takes each device's own GELU flavour,
    as a user's run does (the polynomial on the card, the exact form on the
    CPU), whose difference stays well inside that bound."""
    import torch

    from hamer_yolo_tpu_torch.cli.main import apply_fast_path, pipeline_config
    from hamer_yolo_tpu_torch.core.checkpoint import init_pipeline_params
    from hamer_yolo_tpu_torch.core.mano_assets import synthetic_mano_model
    from hamer_yolo_tpu_torch.core.quant import attach_static_act_scales, vit_blocks_int8
    from hamer_yolo_tpu_torch.models.mano import ManoModel
    from hamer_yolo_tpu_torch.models.vit import ViTConfig, embed_tokens
    from hamer_yolo_tpu_torch.pipeline.frame import infer_frames
    from hamer_yolo_tpu_torch.tools.calibrate_int8 import calibrate_frames

    cpu = torch.device("cpu")
    rng = np.random.default_rng(SEED + 4)
    imgs, hws, Ks = _small_inputs(rng)
    mano_np = synthetic_mano_model(SEED)

    def share_close(got, ref):
        got, ref = got.float(), ref.float()
        return float(torch.isclose(got, ref, rtol=0.02, atol=0.02).float().mean())

    for name, vit in (("small, N 192", ViTConfig(embed_dim=64, depth=2, num_heads=4,
                                                 fused_attn=True)),
                      ("tiny, N 12", dataclasses.replace(pipeline_config(tiny=True).hamer.vit,
                                                         fused_attn=True))):
        cfg = _small_config("float32", vit)
        if vit.img_size != (256, 192):
            cfg = dataclasses.replace(cfg, crop_size=64, hamer=dataclasses.replace(
                cfg.hamer, image_size=64, crop_margin=8))
        params = init_pipeline_params(SEED, ManoModel.from_arrays(mano_np, cpu), cfg.yolo,
                                      cfg.hamer, cfg.sar, device=cpu)
        qparams, qcfg = apply_fast_path(params, cfg, "int8")
        frames = [f.numpy().astype(np.uint8) for f in imgs]
        stats, _ = calibrate_frames(params, frames, cfg, cpu, batch=4)
        sparams = {**qparams, "hamer": {**qparams["hamer"], "backbone": attach_static_act_scales(
            qparams["hamer"]["backbone"], stats)}}
        x = torch.from_numpy(rng.normal(size=(3, *vit.img_size, 3)).astype(np.float32))
        for scales, p, kern, env in (("static", sparams, ("K3", "K4"), {}),
                                     ("dynamic", qparams, ("K5", "K7"), {}),
                                     ("static, path A", sparams, ("K6", "K9", "K10"), PATH_A_ENV),
                                     ("dynamic, path B", qparams, ("K5", "K8"), PATH_B_ENV)):
            pg = _to(p, dev)
            c = qcfg
            if env == PATH_A_ENV:  # with the fused LBS, as the full-width path A
                c = dataclasses.replace(qcfg, hamer=dataclasses.replace(qcfg.hamer,
                                                                        fused_mano=True))
            with torch.inference_mode(), switches(env):
                ref = infer_frames(p, ManoModel.from_arrays(mano_np, cpu), imgs, hws, Ks, c)
                tok = embed_tokens(pg["hamer"]["backbone"], x.to(dev), vit)
                ref_vit = vit_blocks_int8(p["hamer"]["backbone"], tok.cpu(), vit,
                                          gelu="gelu_poly")
                (got, got_vit), n = run_counted(lambda: (
                    infer_frames(pg, ManoModel.from_arrays(mano_np, dev), imgs.to(dev),
                                 hws.to(dev), Ks.to(dev), c),
                    vit_blocks_int8(pg["hamer"]["backbone"], tok, vit)))
            if any(n[k] == 0 for k in kern) or n["K2"]:
                raise RuntimeError(f"int8 reference check {name} {scales}: launches {n}")
            got = {k: v.cpu() for k, v in got.items()}
            v = ref["valid"]
            if not v.any() or not torch.equal(got["valid"], v) or not torch.equal(
                    got["boxes"][v], ref["boxes"][v]):
                raise RuntimeError(f"int8 reference check {name} {scales}: slots differ")
            got_vit = got_vit.float().cpu()
            frac = share_close(got_vit, ref_vit)
            if frac < 0.99:
                raise AssertionError(f"int8 ViT {name} {scales}: {frac:.4f} of elements within "
                                     "0.02 (limit 0.99)")
            torch.testing.assert_close(got_vit, ref_vit.float(), rtol=0.2, atol=0.1)
            readings = [f"ViT blocks {frac:.4f} within 0.02, max abs diff "
                        f"{float((got_vit - ref_vit.float()).abs().max()):.4g}"]
            for k in ("vertices", "keypoints_3d"):
                torch.testing.assert_close(got[k][v], ref[k][v], rtol=0.2, atol=0.1,
                                           msg=lambda m: f"{name} {scales} {k}: {m}")
                readings.append(f"{k} {share_close(got[k][v], ref[k][v]):.4f} within 0.02, max "
                                f"abs diff {float((got[k][v] - ref[k][v]).abs().max()):.4g}")
            print(f"int8 reference check {name} {scales} (card vs CPU, {int(v.sum())} valid "
                  f"slots, launches {n}): " + "; ".join(readings))
            if not env:
                check_reference_tome(p["hamer"]["backbone"], pg["hamer"]["backbone"], tok, vit,
                                     f"{name} {scales}", share_close)


def _merge_fates(match, n_tokens):
    """A merge choice of tome.bipartite_matching as (B, Na): the B token
    each A token merges into, -1 where it is kept."""
    import torch

    merged_a, _, tgt = match
    fates = torch.full((merged_a.shape[0], (n_tokens + 1) // 2), -1, dtype=torch.long)
    return fates.scatter_(1, merged_a.cpu(), tgt.cpu())


def check_reference_tome(p, pg, tok, vit, what, share_close) -> None:
    """int8 + ToMe (TOME_R a block) on the card against the same on the CPU,
    from the same embedded tokens: the card's kernels (K3 + K4, or K5 + K7)
    against their plain versions with the card's polynomial GELU, the CPU
    taking each layer's merge choice from the card's run. A merge is an
    argmax over similarities: where an int8 flip moves a token, the other
    device can merge it elsewhere, and from there on the two forwards are
    different computations, so the comparison fixes the choices and counts
    the A tokens whose merge the CPU would have chosen otherwise. Held at the
    JAX package's limit for int8 rounding flips, as the unmerged ViT above.
    The CPU's forward on its own choices is printed beside it, unchecked."""
    import torch

    from hamer_yolo_tpu_torch.models import tome

    match, card, differ = tome.bipartite_matching, [], []

    def record(t, r):
        card.append(match(t, r))
        return card[-1]

    def replay(t, r):
        want = card[len(differ)]
        own = match(t, r)
        differ.append(int((_merge_fates(own, t.shape[1]) != _merge_fates(want, t.shape[1]))
                          .sum()))
        return tuple(m.to(t.device) for m in want)

    def forward(matcher, tree, on_card, **kw):
        tome.bipartite_matching = matcher
        try:
            with torch.inference_mode():
                x = tok if on_card else tok.cpu()
                return tome.vit_blocks_tome(tree, x, vit, TOME_R, **kw).float().cpu()
        finally:
            tome.bipartite_matching = match

    got, n = run_counted(lambda: forward(record, pg, True))
    ref = forward(replay, p, False, fused=True, gelu="gelu_poly")
    own = forward(match, p, False, fused=True, gelu="gelu_poly")
    if not card or n["K2"] or not (n["K3"] and n["K4"] or n["K5"] and n["K7"]):
        raise RuntimeError(f"int8-tome reference check {what}: {len(card)} merges, launches {n}")
    frac = share_close(got, ref)
    merged = sum(int(m[0].numel()) for m in card)
    print(f"int8-tome reference check {what} (card vs CPU, {got.shape[1]} tokens left): on the "
          f"card's merges {frac:.4f} within 0.02, max abs diff "
          f"{float((got - ref).abs().max()):.4g}; A tokens whose merge the CPU would have "
          f"chosen otherwise, by layer, {differ} ({merged} merged in all); on the CPU's own "
          f"merges {share_close(got, own):.4f} within 0.02")
    if frac < 0.99:
        raise AssertionError(f"int8-tome {what}: {frac:.4f} of elements within 0.02 (limit "
                             "0.99) on the card's merges")
    torch.testing.assert_close(got, ref, rtol=0.2, atol=0.1)


# -- the checkpoint, YOLO family and graph cache phases ----------------------

def checkpoint_phase(dev, cfg, depth, smi):
    """Real-weight plumbing at full width: the seeded init of the default
    pipeline (YOLOv7 deploy, ViT-H 32 x 1280 + the 6-layer MANO head, SAR's
    ResNet-34 + head + RootNet) as numpy in JAX layout, written with
    torch.save in the reference's three formats by the tests' builders
    (tests/test_torch_state_dicts.py, which imports no JAX): yolov7_best.pt a
    pickled module tree with an "ema" entry, hamer.ckpt a Lightning
    {'state_dict'}, SAR-resnet34-Root.pth {'network', 'rootnet'} with
    module. prefixes. Then core/convert.convert_pipeline_checkpoints (leaf
    for leaf the tree that went in), core/checkpoint.save_checkpoint, and
    ``infer --checkpoint x.npz`` through cli.main on 720p frames (K1, K2),
    whose npy files must equal, bit for bit, those of the same runner on the
    converted tree held in memory. Prints the seconds of each step."""
    import torch

    from hamer_yolo_tpu_torch.cli.main import load_mano
    from hamer_yolo_tpu_torch.cli.main import main as cli
    from hamer_yolo_tpu_torch.core.bridge import from_jax_params
    from hamer_yolo_tpu_torch.core.checkpoint import (init_pipeline_params, load_checkpoint,
                                                      save_checkpoint)
    from hamer_yolo_tpu_torch.core.convert import convert_pipeline_checkpoints
    from hamer_yolo_tpu_torch.io.writers import load_hand_npy
    from hamer_yolo_tpu_torch.pipeline.runner import process_image_dir

    sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), "tests"))
    from test_torch_state_dicts import assert_leaf_equal, port_tree_to_numpy, write_reference_files

    secs = {}

    def timed(name, fn):
        t0 = time.perf_counter()
        out = fn()
        secs[name] = time.perf_counter() - t0
        return out

    mano = load_mano(None, dev)  # what the CLI loads
    tree = timed("init (CPU)", lambda: port_tree_to_numpy(init_pipeline_params(
        SEED + 5, mano, cfg.yolo, cfg.hamer, cfg.sar, device="cpu")))
    frames = frames_720p(N_FRAMES, SEED + 5)
    saved = sys.modules.get("cv2")
    sys.modules["cv2"] = cv2_stand_in()
    try:
        with tempfile.TemporaryDirectory() as root:
            paths = timed("torch.save x3", lambda: write_reference_files(root, tree))
            sizes = {os.path.basename(p): os.path.getsize(p) / 2 ** 20 for p in paths}
            conv = timed("convert", lambda: convert_pipeline_checkpoints(
                *paths, template=mano.v_template.cpu().numpy()))
            assert_leaf_equal(conv, tree)
            npz = os.path.join(root, "pipeline.npz")
            timed("save_checkpoint", lambda: save_checkpoint(npz, conv))

            def load():
                p = load_checkpoint(npz, dev)
                torch.cuda.synchronize()
                return p

            timed("load_checkpoint to the card", load)
            os.makedirs(os.path.join(root, "in"))
            for i, f in enumerate(frames):
                with open(os.path.join(root, "in", f"f{i}.png"), "wb") as fh:
                    np.save(fh, f)
            out_cli, out_mem = os.path.join(root, "cli"), os.path.join(root, "mem")
            rc, n = run_counted(lambda: timed("infer --checkpoint (cli.main)", lambda: cli(
                ["infer", "--checkpoint", npz, "--input", os.path.join(root, "in"),
                 "--output", out_cli, "--no-obj"])))
            if rc:
                raise RuntimeError(f"infer --checkpoint: rc {rc}")
            expect_launches("infer --checkpoint", n, {"K2": CAPTURE_RUNS * depth})
            if n["K1"] < CAPTURE_RUNS:
                raise RuntimeError(f"infer --checkpoint: K1 launched {n['K1']} times")
            params = from_jax_params(conv, dev)
            with torch.inference_mode():
                process_image_dir(os.path.join(root, "in"), out_mem, params, mano, cfg,
                                  save_obj=False, device=dev, progress=False)
            names = sorted(f for f in os.listdir(out_mem) if f.endswith(".npy"))
            hands = 0
            if names != sorted(f for f in os.listdir(out_cli) if f.endswith(".npy")) or \
                    len(names) != N_FRAMES:
                raise RuntimeError(f"infer --checkpoint wrote {os.listdir(out_cli)}")
            for name in names:
                a = load_hand_npy(os.path.join(out_cli, name))
                b = load_hand_npy(os.path.join(out_mem, name))
                for side in ("left", "right"):
                    if (a[side] is None) != (b[side] is None):
                        raise RuntimeError(f"{name} {side}: a hand in one run only")
                    if a[side] is None:
                        continue
                    hands += 1
                    for k, v in b[side].items():
                        if not np.array_equal(np.asarray(a[side][k]), np.asarray(v)):
                            raise RuntimeError(f"{name} {side} {k}: infer --checkpoint differs "
                                               "from the tree in memory")
    finally:
        if saved is None:
            sys.modules.pop("cv2", None)
        else:
            sys.modules["cv2"] = saved
    print(f"checkpoint: {N_FRAMES} 720p frames, {hands} hands; infer --checkpoint's npy files "
          f"equal the in-memory tree's bit for bit; launches {n}; files "
          + ", ".join(f"{k} {v:.1f} MiB" for k, v in sizes.items()))
    print(f"checkpoint seconds on {smi} (host clock, this machine's disk): "
          + ", ".join(f"{k} {v:.2f}" for k, v in secs.items()))


# A spec with every deploy op and every variant, at 256-1024 channels, 3
# levels at 640 (strides 8, 16, 32); the head op is filled in per use.
FAMILY_SPEC = [
    (-1, "REORG", ()), (-1, "C", (256, 3, 2)), (-1, "GSTEM", (256,)),
    (1, "STEM", (256,)), (1, "C", (256, 3, 2)),
    (-1, "GHOSTC", (256, 3, 1)), (-1, "GHOST", (256, 3, 1)),               # 6: P3
    (-1, "GHOST", (512, 3, 2)), ((-1, 2, 3), "CAT", ()),
    (-1, "GCSPA", (512, 1)), (-1, "GCSPB", (512, 1)), (-1, "GCSPC", (512, 1)),
    (-1, "SP_", (3,)), ((-1, -2), "ADD", ()),                              # 13: P4
    (-1, "DOWNC", (512,)), (-1, "GSPP", (512,)),
    (-1, "STCSPA", (1024, 1)), (-1, "STCSPB", (512, 1)), (-1, "STCSPC", (1024, 1)),
    (-1, "SWINB", (512, 16, 2)), (-1, "SPP", (512,)),                      # 20: P5
    (-1, "C", (256, 1, 1)), (-1, "UP", ()), ((-1, 13), "CAT", ()), (-1, "MP", ()),
    (6, "REP", (256,)), (23, "REP", (512,)), (20, "REP", (512,)),
]
# the w6 family's shape at 1280: ReOrg stem, DownC downsampling, 4 levels (8 ... 64)
P6_YAML = {
    "nc": 3, "depth_multiple": 1.0, "width_multiple": 1.0,
    "anchors": [[19, 27, 44, 40, 38, 94], [96, 68, 86, 152, 180, 137],
                [140, 301, 303, 264, 238, 542], [436, 615, 739, 380, 925, 792]],
    "backbone": [[-1, 1, "ReOrg", []], [-1, 1, "Conv", [64, 3, 1]], [-1, 1, "DownC", [128]],
                 [-1, 1, "Conv", [128, 3, 1]], [-1, 1, "DownC", [256]],
                 [-1, 1, "Conv", [256, 1, 1]], [-1, 1, "DownC", [384]], [-1, 1, "DownC", [512]],
                 [-1, 1, "DownC", [512]], [-1, 1, "SPPCSPC", [256]]],
    "head": [[8, 1, "Conv", [256, 1, 1]], [[-1, 9], 1, "Shortcut", []],
             [-1, 1, "nn.Upsample", [None, 2, "nearest"]], [[-1, 7], 1, "Concat", [1]],
             [5, 1, "SP", [5]], [6, 1, "RepConv", [256, 3, 1]], [13, 1, "Conv", [256, 1, 1]],
             [11, 1, "Conv", [256, 1, 1]],
             [[14, 15, 16, 17], 1, "IDetect", ["nc", "anchors"]]],
}


def family_phase(params, mano, cfg, dev, depth, smi):
    """The rest of the YOLO family on the card: FAMILY_SPEC with each head
    (DET, BIN, KPT) at 640 and the P6 yaml dict at 1280, bf16, finite and of
    their shapes; FAMILY_SPEC's f32 forward on the card against the CPU's on
    a small input at the composed-oracle limit 2e-3; ``detect --augment``
    through cli.main on 720p frames (the whole one-frame program, as JAX's
    detect runs it: K1 and K2) and the TTA detector at B = 4; K1's keep
    sets on the TTA candidates equal to greedy_nms_keep_ref's; Merge-NMS and
    the keypoint NMS through K1 against the same functions on the CPU. Prints
    the detect stage's ms with and without TTA and K1's launches a batch."""
    import io

    import torch

    from hamer_yolo_tpu_torch.cli.main import main as cli
    from hamer_yolo_tpu_torch.models.yolov7.model import YoloConfig, init_yolov7, yolov7_forward
    from hamer_yolo_tpu_torch.models.yolov7.yaml_spec import spec_from_yaml
    from hamer_yolo_tpu_torch.ops.nms import (greedy_nms_keep_mask, greedy_nms_keep_ref,
                                              nms_candidates, non_max_suppression,
                                              non_max_suppression_kpt)
    from hamer_yolo_tpu_torch.pipeline.frame import detect_hands_batched
    from hamer_yolo_tpu_torch.pipeline.preprocess import device_letterbox

    heads = {"DET": (), "BIN": (), "KPT": (17,)}
    ycfg = YoloConfig(nc=3)
    outs = {}
    with torch.inference_mode():
        x640 = torch.rand((2, 640, 640, 3), generator=torch.Generator().manual_seed(SEED))
        for head, args in heads.items():
            spec = FAMILY_SPEC + [((25, 26, 27), head, args)]
            p = init_yolov7(torch.Generator(device=dev).manual_seed(SEED), ycfg, spec=spec)
            out, n = run_counted(lambda: yolov7_forward(p, x640.to(dev), ycfg, spec=spec))
            width = ycfg.no + (3 * 17 if head == "KPT" else 0)
            if tuple(out.shape) != (2, 3 * (80 * 80 + 40 * 40 + 20 * 20), width) or \
                    not torch.isfinite(out).all():
                raise RuntimeError(f"family spec {head}: {tuple(out.shape)}, not finite or "
                                   "not of its shape")
            outs[head] = out
        spec6, cfg6 = spec_from_yaml(P6_YAML)
        p6 = init_yolov7(torch.Generator(device=dev).manual_seed(SEED), cfg6, spec=spec6)
        x1280 = torch.rand((1, 1280, 1280, 3), generator=torch.Generator().manual_seed(SEED))
        out6 = yolov7_forward(p6, x1280.to(dev), cfg6, spec=spec6)
        if tuple(out6.shape) != (1, 3 * (160 ** 2 + 80 ** 2 + 40 ** 2 + 20 ** 2), 8) or \
                not torch.isfinite(out6).all():
            raise RuntimeError(f"P6 spec at 1280: {tuple(out6.shape)}")
        print(f"YOLO family: the every-op spec ({len(FAMILY_SPEC) + 1} layers, 256-1024 "
              f"channels) with DET, BIN and KPT heads at 640 in bf16 -> "
              + ", ".join(f"{h} {tuple(o.shape)}" for h, o in outs.items())
              + f"; the P6 yaml ({len(spec6)} layers, strides {cfg6.strides}) at 1280 -> "
              f"{tuple(out6.shape)}; all finite")
        # f32, the card against the CPU on a small input
        c32 = dataclasses.replace(ycfg, compute_dtype="float32")
        spec = FAMILY_SPEC + [((25, 26, 27), "DET", ())]
        p = init_yolov7(torch.Generator().manual_seed(SEED + 1), c32, spec=spec)
        x = torch.rand((1, 128, 128, 3), generator=torch.Generator().manual_seed(SEED + 1))
        ref = yolov7_forward(p, x, c32, spec=spec)
        got = yolov7_forward(_to(p, dev), x.to(dev), c32, spec=spec).cpu()
        torch.testing.assert_close(got, ref, rtol=2e-3, atol=2e-3)
        print(f"YOLO family f32 (card vs CPU, the every-op spec at 128): max abs diff "
              f"{float((got - ref).abs().max()):.4g}, max |ref| {float(ref.abs().max()):.4g}")

    # detect --augment through cli.main, then the TTA detector at B = 4
    frames = frames_720p(4, SEED + 6)
    saved = sys.modules.get("cv2")
    sys.modules["cv2"] = cv2_stand_in()
    try:
        with tempfile.TemporaryDirectory() as root:
            for i, f in enumerate(frames):
                with open(os.path.join(root, f"f{i}.png"), "wb") as fh:
                    np.save(fh, f)
            buf = io.StringIO()
            with contextlib.redirect_stdout(buf):
                (rc, n) = run_counted(lambda: cli(["detect", "--augment", "--input", root]))
            lines = buf.getvalue().strip().splitlines()
    finally:
        if saved is None:
            sys.modules.pop("cv2", None)
        else:
            sys.modules["cv2"] = saved
    dets = [json.loads(ln) for ln in lines]
    print(f"detect --augment (cli.main, {len(frames)} 720p frames, one captured bucket): rc {rc}, "
          f"{sum(len(d['detections']) for d in dets)} hands; launches {n}")
    if rc or len(dets) != len(frames):
        raise RuntimeError("detect --augment: unexpected output")
    expect_launches("detect --augment", n, {"K1": CAPTURE_RUNS, "K2": CAPTURE_RUNS * depth})
    tcfg = dataclasses.replace(cfg, tta=True)
    imgs = torch.from_numpy(np.stack(frames)).to(dev).to(torch.float32)
    hws = torch.tensor([[720.0, 1280.0]] * 4, device=dev)
    stage_ms = {}
    with torch.inference_mode():
        for B in (1, 4):
            for name, c in (("plain", cfg), ("tta", tcfg)):
                out, n = run_counted(lambda: detect_hands_batched(params["yolo"], imgs[:B],
                                                                  hws[:B], c))
                if n["K1"] != 1 or not torch.isfinite(out["boxes"]).all():
                    raise RuntimeError(f"detect B {B} {name}: K1 launched {n['K1']} times")
                stage_ms[(B, name)] = cuda_time_ms(
                    lambda: detect_hands_batched(params["yolo"], imgs[:B], hws[:B], c), iters=5)
        lb, _, _ = device_letterbox(imgs, hws, cfg.det_size)
        from hamer_yolo_tpu_torch.models.yolov7.tta import yolov7_forward_tta

        pred = yolov7_forward_tta(params["yolo"], lb.flip(-1) / 255.0, cfg.yolo)
        cand = nms_candidates(pred, cfg.conf_thres, cfg.classes, cfg.agnostic_nms,
                              cfg.max_nms_static)
        keep = greedy_nms_keep_mask(cand.shifted, cand.active, cfg.iou_thres)
        ref_keep = greedy_nms_keep_ref(cand.shifted, cand.active.float(), cfg.iou_thres) > 0.5
        if not torch.equal(keep, ref_keep):
            raise RuntimeError("K1 on the TTA candidates differs from greedy_nms_keep_ref")
        kw = dict(conf_thres=cfg.conf_thres, iou_thres=cfg.iou_thres, max_det=100,
                  max_nms_static=cfg.max_nms_static)
        for redundant in (True, False):
            got, n = run_counted(lambda: non_max_suppression(pred, merge=True, redundant=redundant,
                                                             **kw))
            ref = non_max_suppression(pred.cpu(), merge=True, redundant=redundant, **kw)
            _same_nms(got, ref, n, f"Merge-NMS redundant={redundant}")
        kpred = outs["KPT"].float()
        got, n = run_counted(lambda: non_max_suppression_kpt(kpred, nc=3, **kw))
        ref = non_max_suppression_kpt(kpred.cpu(), nc=3, **kw)
        _same_nms(got, ref, n, "keypoint NMS")
        if not torch.equal(got.kpts.cpu(), ref.kpts):
            raise RuntimeError("keypoint NMS: keypoints differ from the CPU's")
    print(f"TTA: K1's keep set on the {int(cand.active.sum())} active TTA candidates of "
          f"{tuple(pred.shape)} equals greedy_nms_keep_ref's")
    print(f"detect stage (detect_hands_batched: letterbox, YOLOv7, NMS) on {smi}, CUDA events, "
          "2 warm-up, 5 timed: " + ", ".join(f"B {b} {k} {v:.3f} ms" for (b, k), v in
                                             stage_ms.items()) + "; K1 launches a batch: 1")


def _same_nms(got, ref, n, what):
    """An NMS on the card (one K1 launch) against the same on the CPU: the
    same valid slots, classes and scores, boxes within f32 sum order."""
    import torch

    if n["K1"] != 1:
        raise RuntimeError(f"{what}: K1 launched {n['K1']} times")
    for k in ("valid", "classes", "scores"):
        if not torch.equal(getattr(got, k).cpu(), getattr(ref, k)):
            raise RuntimeError(f"{what}: {k} differ from the CPU's")
    torch.testing.assert_close(got.boxes.cpu(), ref.boxes, rtol=1e-5, atol=1e-5)
    print(f"{what} on the card: {int(ref.valid.sum())} kept of the batch, the CPU's keep set; "
          f"boxes max abs diff {float((got.boxes.cpu() - ref.boxes).abs().max()):.3g}; K1 1")


def graph_cache_phase(params, mano, cfg, dev, smi):
    """ROADMAP F15 on the card. Each default bucket's graph and its pool
    through one FrameProgram (B = 1, uint8); then MAX_GRAPHS + 2 sizes past
    the largest bucket through a fresh FrameProgram: it never holds more
    than MAX_GRAPHS graphs; after torch.cuda.empty_cache the memory reserved
    after the two extra keys is within one pool of that before them; the
    first size, evicted and captured again, gives outputs equal bit for bit
    to its first capture's and to eager infer_frame's."""
    import torch

    from hamer_yolo_tpu_torch.pipeline.captured import MAX_GRAPHS
    from hamer_yolo_tpu_torch.pipeline.runner import DEFAULT_BUCKETS, FrameProgram

    rng = np.random.default_rng(SEED + 7)
    K = np.float32([[1000, 0, 640], [0, 1000, 360], [0, 0, 1]])
    program = FrameProgram(params, mano, cfg, dev)
    pools = {}
    for h, w in DEFAULT_BUCKETS:
        program(rng.integers(0, 256, (h, w, 3), dtype=np.uint8), K)
        pools[f"{h}x{w}"] = list(program.program.pool_bytes.values())[-1] / 2 ** 20
    if len(program.program._graphs) != len(DEFAULT_BUCKETS):
        raise RuntimeError("the five default buckets did not fit in one program's cache")
    print(f"graph cache: MAX_GRAPHS {MAX_GRAPHS}; FrameProgram pool a bucket (B = 1, uint8) on "
          f"{smi}: " + ", ".join(f"{k} {v:.1f} MiB" for k, v in pools.items()))
    del program
    torch.cuda.synchronize()
    torch.cuda.empty_cache()

    def reserved():
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        return torch.cuda.memory_reserved(dev)

    program = FrameProgram(params, mano, cfg, dev)
    sizes = [(2160 + 64 * (i + 1), 3840) for i in range(MAX_GRAPHS + 2)]
    frames = {s: rng.integers(0, 256, s + (3,), dtype=np.uint8) for s in sizes}
    first = None
    r0 = reserved()
    levels, big = [], 0
    for i, s in enumerate(sizes):
        out = program(frames[s], K)
        if i == 0:
            first = out
        held = len(program.program._graphs)
        if held > MAX_GRAPHS:
            raise RuntimeError(f"graph cache holds {held} graphs, more than {MAX_GRAPHS}")
        big = max([big] + list(program.program.pool_bytes.values()))
        if i >= MAX_GRAPHS - 1:
            levels.append(reserved())
    before, after = levels[0], levels[-1]
    print(f"graph cache: {len(sizes)} sizes past the largest bucket "
          f"({sizes[0][0]}..{sizes[-1][0]} x 3840), at most {MAX_GRAPHS} graphs held; reserved "
          f"after empty_cache: {r0 / 2 ** 20:.0f} MiB before any, {before / 2 ** 20:.0f} MiB "
          f"with the cache full, {after / 2 ** 20:.0f} MiB after 2 more keys (2 evicted); the "
          f"largest pool {big / 2 ** 20:.1f} MiB")
    if after > before + big:
        raise RuntimeError("evicted graphs did not return their memory")
    again = program(frames[sizes[0]], K)
    eager = eager_frame(params, mano, cfg, dev, frames[sizes[0]], K)
    for k, v in first.items():
        if not (np.array_equal(again[k], v) and np.array_equal(eager[k], v)):
            raise RuntimeError(f"graph cache: {k} of the recaptured key differs")
    print(f"graph cache: {sizes[0][0]}x3840, evicted and captured again: all {len(first)} "
          "outputs equal its first capture's and eager infer_frame's bit for bit")


RGBD_BBOX = [880.0, 460.0, 160.0, 150.0]  # x, y, w, h in the 1920x1080 frame
KPF_PARAMS = 29_375_132                  # the default KPFusionConfig's parameters
KPF_RADII = (0.1, 0.2, 0.4)              # DESA's ball-query radii, 64 samples each


def rgbd_frame(seed):
    """A numpy-made 1920x1080 uint8 RGB frame and a depth frame (mm, f32)
    with a hand-like blob at 400-700 mm on a disk inside RGBD_BBOX."""
    rng = np.random.default_rng(seed)
    depth = np.zeros((1080, 1920), np.float32)
    x0, y0, w, h = (int(v) for v in RGBD_BBOX)
    yy, xx = np.mgrid[0:h, 0:w]
    blob = 550.0 + 150.0 * np.sin(xx / 9.0) * np.cos(yy / 7.0)
    blob[((xx - w / 2) ** 2 + (yy - h / 2) ** 2) > (min(h, w) / 2.2) ** 2] = 0
    depth[y0:y0 + h, x0:x0 + w] = blob
    return rng.integers(0, 256, (1080, 1920, 3), dtype=np.uint8), depth


def kaiming_heads(tree, gen):
    """Redraw the init's N(0, 0.001) weights (the UNets' finals, the
    stages' embeddings, heads and gates) Kaiming-uniform like every other
    weight, in place, so that the random model's joints move by O(1) as a
    trained model's do, not by 1e-3."""
    import torch

    if isinstance(tree, dict):
        for k, v in tree.items():
            if k == "w" and isinstance(v, torch.Tensor) and float(v.std()) < 0.01:
                fan_in = v.shape[0] if v.ndim == 2 else v[0].numel()
                bound = float(np.sqrt(6.0 / fan_in))
                v.uniform_(-bound, bound, generator=gen)
            else:
                kaiming_heads(v, gen)
    elif isinstance(tree, list):
        for v in tree:
            kaiming_heads(v, gen)


def rgbd_index_sets(out, inputs, cfg):
    """The index sets a forward chose, recomputed from its own outputs:
    img2pcl_index's 4 pixels a point (N, 4), and for each stage and radius
    DESA's ball query around its joints (J, 64), each row in index order."""
    import torch

    from hamer_yolo_tpu_torch.models.kpfusion_rgbd import geometry as G
    from hamer_yolo_tpu_torch.ops.pointnet import ball_query

    _, img, pcl, center, M, cube, cam = inputs
    img_down = G._resize_nearest_torch(img, cfg.feature_size).permute(0, 2, 3, 1)
    _, pidx = G.img2pcl_index(pcl, img_down, center, M, cube, cam, cfg.img_size)
    nodes = [G.uvd_nl2xyznl(out["joint_uvd_init"], center, M, cube, cam, cfg.img_size)]
    nodes += [out["results"][3 + 2 * s] for s in range(cfg.num_stages - 1)]
    balls = [ball_query(n, torch.cat([pcl, n], dim=1), r, 64) for n in nodes for r in KPF_RADII]
    return torch.sort(pidx[0], dim=-1).values.cpu(), [b[0].cpu() for b in balls]


def rgbd_parts(params, cfg, dev_in):
    """{part: (device ms, device kernels)} of the forward's parts: the two
    UNets, the geometry between them and the stages (initial joints, the
    pcl index), and each stage's block."""
    import torch

    from hamer_yolo_tpu_torch.models.kpfusion_rgbd import geometry as G
    from hamer_yolo_tpu_torch.models.kpfusion_rgbd.model import block_forward
    from hamer_yolo_tpu_torch.models.kpfusion_rgbd.resunet import unet_forward

    img_rgb, img, pcl, center, M, cube, cam = dev_in
    geo = (center, M, cube, cam)
    with torch.inference_mode():
        def unets():
            return (unet_forward(params["backbone_d"], img.permute(0, 2, 3, 1)),
                    unet_forward(params["backbone_rgb"], img_rgb.permute(0, 2, 3, 1)))

        (off, feat), (_, feat_rgb) = unets()
        off, feat, feat_rgb = (t.permute(0, 3, 1, 2) for t in (off, feat, feat_rgb))
        img_down = G._resize_nearest_torch(img, feat.shape[2])

        def geometry():
            uvd = G.offset2joint_weight(off, img, cfg.kernel)
            return (G.uvd_nl2xyznl(uvd, *geo, cfg.img_size),
                    *G.img2pcl_index(pcl, img_down.permute(0, 2, 3, 1), *geo, cfg.img_size))

        joint_xyz, closeness, index = geometry()

        def stage(i, joints, updated):
            return lambda: block_forward(params["blocks"][i], cfg, feat, feat_rgb, pcl, joints,
                                         closeness, index, off, updated, img_down, *geo)

        _, r2d, updated, _ = stage(0, joint_xyz, None)()
        parts = {"UNets": unets, "geometry": geometry, "stage 1": stage(0, joint_xyz, None),
                 "stage 2": stage(1, r2d, updated)}
        return {k: (graph_time_ms(fn, reps=5, iters=5), sum(kernels_by_name(fn)[1].values()))
                for k, fn in parts.items()}


def rgbd_phase(dev, smi):
    """The RGB-D branch at full width (the default KPFusionConfig: 21
    joints, dim 128, 4 heads, two stages, 128 x 128 crops, 32 x 32 features,
    1,024 points; seeded weights, the init's N(0, 0.001) heads redrawn
    Kaiming-uniform (kaiming_heads) and each BN's variance set to its input's
    mean square on this frame, as the CPU tests do) on a numpy-made
    1920x1080 RGB-D frame: RGBDRuntime on the card (its forward one captured
    CUDA graph) against the same runtime on the CPU with the same
    RandomState seed, final joints within JAX's full-forward tolerance (atol
    5e-4, rtol 1e-3); the index sets (img2pcl_index, DESA's ball queries)
    that differ between card and CPU counted; the graph bit-equal to eager;
    ``rgbd --kpf-checkpoint`` through cli.main (cv2_stand_in) on a KPFusion
    .pth written by torch.save prints the runtime's JSON line; no kernel
    launched. Times: the forward alone (graph replay and eager, CUDA
    events), the host's pre- and post-processing and a whole call."""
    import io

    import torch

    from hamer_yolo_tpu_torch.cli.main import main as cli
    from hamer_yolo_tpu_torch.models.kpfusion_rgbd.model import (KPFusionConfig, init_kpfusion,
                                                                 kpfusion_forward)
    from hamer_yolo_tpu_torch.models.kpfusion_rgbd.runtime import RGBDRuntime

    sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), "tests"))
    from test_torch_state_dicts import (calibrating_batch_norm, port_tree_to_numpy,
                                        write_kpfusion_file)

    cfg = KPFusionConfig()
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED)
    params = init_kpfusion(gen, cfg)
    kaiming_heads(params, gen)
    n_params = sum(t.numel() for t in torch.utils._pytree.tree_leaves(params))
    if n_params != KPF_PARAMS:
        raise RuntimeError(f"rgbd: {n_params} parameters, not the default config's {KPF_PARAMS}")
    rgb, depth = rgbd_frame(SEED + 9)
    rt = RGBDRuntime(params, cfg, dev)
    prep = rt.prepare(rgb, depth, RGBD_BBOX, np.random.RandomState(SEED))
    dev_in = [torch.from_numpy(a).to(dev) for a in prep["inputs"]]
    with torch.no_grad(), calibrating_batch_norm():
        kpfusion_forward(params, *dev_in, cfg)
    cpu_params = _to(params, "cpu")
    cpu_rt = RGBDRuntime(cpu_params, cfg, "cpu")
    print(f"rgbd: KPFusion at full width ({n_params:,} parameters; {cfg}); a 1920x1080 frame, "
          f"bbox {RGBD_BBOX}, center {np.round(prep['center'], 2).tolist()}, "
          f"{int((~np.isclose(prep['crop_depth'], 1)).sum())} valid crop pixels")

    # the runtime on the card (captured) against the CPU's, the same seed
    got, n = run_counted(lambda: rt.estimate_pose_rgbd(rgb, depth, RGBD_BBOX,
                                                       np.random.RandomState(SEED)))
    expect_launches("rgbd", n, dict.fromkeys(KERNELS, 0))
    ref = cpu_rt.estimate_pose_rgbd(rgb, depth, RGBD_BBOX, np.random.RandomState(SEED))
    with torch.inference_mode():
        card = rt.program(*prep["inputs"])
        eager = rt.forward(*dev_in)
        cpu_out = kpfusion_forward(cpu_params, *[torch.from_numpy(a) for a in prep["inputs"]],
                                   cfg)
        dev_out = kpfusion_forward(params, *dev_in, cfg)
    joints, ref_joints = card["joints"].cpu(), cpu_out["joints"]
    if not torch.isfinite(joints).all() or joints.shape != (1, cfg.joint_num, 3):
        raise RuntimeError(f"rgbd: joints {tuple(joints.shape)} not finite")
    err = float((joints - ref_joints).abs().max())
    print(f"rgbd card vs CPU: final joints (normalized) max abs diff {err:.3g} at |ref| <= "
          f"{float(ref_joints.abs().max()):.3g}; joint_xyz_world max abs diff "
          f"{float(np.abs(got['joint_xyz_world'] - ref['joint_xyz_world']).max()):.3g} m, "
          f"joint_uvd_full {float(np.abs(got['joint_uvd_full'] - ref['joint_uvd_full']).max()):.3g}"
          f" px; every stage's joints: " + ", ".join(
              f"{float((a.cpu() - b).abs().max()):.3g}" for a, b in
              zip(dev_out["results"][2:], cpu_out["results"][2:])))
    torch.testing.assert_close(joints, ref_joints, atol=5e-4, rtol=1e-3)
    for k in ("joint_xyz_world", "joint_uvd_full"):
        if not np.isfinite(got[k]).all():
            raise RuntimeError(f"rgbd: {k} not finite")
    dev_sets = rgbd_index_sets(dev_out, dev_in, cfg)
    cpu_sets = rgbd_index_sets(cpu_out, [torch.from_numpy(a) for a in prep["inputs"]], cfg)
    d_pcl = int((dev_sets[0] != cpu_sets[0]).any(-1).sum())
    d_ball = sum(int((a != b).any(-1).sum()) for a, b in zip(dev_sets[1], cpu_sets[1]))
    print(f"rgbd index sets that differ between card and CPU: img2pcl_index {d_pcl} of "
          f"{dev_sets[0].shape[0]} points; DESA ball query {d_ball} of "
          f"{len(dev_sets[1]) * cfg.joint_num} (stage, radius, joint) groups")
    for k in ("joints", "uvd"):
        if not torch.equal(card[k], eager[k]):
            raise RuntimeError(f"rgbd: the captured graph's {k} differ from eager")
    print("rgbd: the captured graph's joints and uvd equal eager's bit for bit "
          f"(graph pool {list(rt.program.pool_bytes.values())[0] / 2 ** 20:.1f} MiB)")

    # rgbd through cli.main: a KPFusion .pth written by torch.save
    line = json.dumps({"joint_uvd_full": got["joint_uvd_full"].tolist(),
                       "joint_xyz_world": got["joint_xyz_world"].tolist(),
                       "center": np.asarray(got["center"]).tolist()})
    saved = sys.modules.get("cv2")
    sys.modules["cv2"] = cv2_stand_in()
    try:
        with tempfile.TemporaryDirectory() as root:
            pth = os.path.join(root, "kpfusion.pth")
            write_kpfusion_file(pth, port_tree_to_numpy(params))
            png, npy = os.path.join(root, "rgb.png"), os.path.join(root, "depth.npy")
            with open(png, "wb") as fh:
                np.save(fh, rgb)
            np.save(npy, depth)
            out = io.StringIO()
            with contextlib.redirect_stdout(out):
                rc = cli(["rgbd", "--rgb", png, "--depth", npy, "--bbox",
                          ",".join(f"{v:g}" for v in RGBD_BBOX), "--kpf-checkpoint", pth,
                          "--seed", str(SEED)])
            size = os.path.getsize(pth) / 2 ** 20
    finally:
        if saved is None:
            sys.modules.pop("cv2", None)
        else:
            sys.modules["cv2"] = saved
    lines = out.getvalue().strip().splitlines()
    if rc or lines != [line]:
        raise RuntimeError(f"rgbd through cli.main: rc {rc}, {lines[:1]} is not the runtime's "
                           f"{line[:200]}")
    print(f"rgbd cli.main --kpf-checkpoint ({size:.1f} MiB .pth, torch.save): the runtime's "
          "JSON line, character for character")

    # times
    g = next(iter(rt.program._graphs.items()))[1]
    with torch.inference_mode():
        graph_ms = cuda_time_ms(g.graph.replay, iters=20)
        eager_ms = cuda_time_ms(lambda: rt.forward(*dev_in), iters=20)
    print(f"rgbd forward by part on {smi} (device ms by CUDA graph replay of each part alone on "
          "the forward's own inputs; device kernels of one eager call, torch.profiler): "
          + "; ".join(f"{k} {ms:.3f} ms, {n} kernels" for k, (ms, n) in
                      rgbd_parts(params, cfg, dev_in).items()))
    host = {"prepare": [], "finish": [], "call": []}
    for _ in range(7):
        t0 = time.perf_counter()
        pr = rt.prepare(rgb, depth, RGBD_BBOX, np.random.RandomState(SEED))
        t1 = time.perf_counter()
        rt.finish(pr, card["joints"].cpu().numpy(), card["uvd"].cpu().numpy())
        t2 = time.perf_counter()
        rt.estimate_pose_rgbd(rgb, depth, RGBD_BBOX, np.random.RandomState(SEED))
        t3 = time.perf_counter()
        host["prepare"].append((t1 - t0) * 1e3)
        host["finish"].append((t2 - t1) * 1e3)
        host["call"].append((t3 - t2) * 1e3)
    p50 = {k: float(np.median(v)) for k, v in host.items()}
    _, counts = kernels_by_name(g.graph.replay, again=g.graph.replay)
    top = sorted(counts.items(), key=lambda kv: -kv[1])[:6]
    print(f"rgbd forward alone on {smi}: p50 {graph_ms:.3f} ms by graph replay, {eager_ms:.3f} ms "
          f"eager (CUDA events, 2 warm-up, 20 timed); {sum(counts.values())} device kernels a "
          "replay (torch.profiler), the most frequent: "
          + "; ".join(f"{c} x {name[:60]}" for name, c in top))
    print(f"rgbd host on {smi}: prepare (center, crops, point cloud) p50 {p50['prepare']:.3f} ms, "
          f"finish {p50['finish']:.3f} ms; a whole estimate_pose_rgbd call p50 {p50['call']:.3f} "
          "ms (host clock, 7 timed)")


# -- int8 detector, ConvNeXt SAR, overlays ------------------------------------
CALIB_REL = 0.03  # int8 detector scales, card against CPU (tests/test_torch_int8_yolo.py)
DETECT_BATCHES = (1, 4, 16)
OVERLAY_MAX_DIFF_FRAC = 1e-4  # overlay pixels that may differ by one level, card against CPU


def _tree_leaves(tree, key=None):
    """The tensors of a parameter tree, depth first; with ``key``, only the
    leaves stored under that key."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            if key is not None and k == key:
                yield v
            else:
                yield from _tree_leaves(v, key)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _tree_leaves(v, key)
    elif tree is not None and key is None:
        yield tree


def _in_turns(fns, time_fn):
    """{name: [time, time]}: each fn timed by time_fn in the order a, b, ...,
    b, a."""
    times = {k: [] for k in fns}
    for k in list(fns) + list(fns)[::-1]:
        times[k].append(time_fn(fns[k]))
    return times


def _fmt_turns(times):
    return "; ".join(f"{k} {', '.join(f'{t:.3f}' for t in v)}" for k, v in times.items())


def int8_sar_overlay_phase(params, sparams, qcfg, mano, cfg, dev, depth, smi):
    """The phase "int8 detector, ConvNeXt SAR, overlays" at full width:
    int8_detector_phase, convnext_sar_phase and overlay_phase."""
    print(f"int8 detector, ConvNeXt SAR, overlays: on {smi}")
    int8_detector_phase(params, sparams, qcfg, mano, cfg, dev, depth)
    convnext_sar_phase(params, mano, cfg, dev)
    overlay_phase(dev)


def int8_detector_phase(params, sparams, qcfg, mano, cfg, dev, depth):
    """``--int8-yolo 1x1`` and ``all`` on the default YOLOv7 at 640: quantized
    and calibrated on two of the phase's 720p frames (the CLI's centred
    letterbox), run on the card through infer_frames with the bf16 ViT (K1,
    K2) and the int8 static ViT (K1, K3, K4), launches counted; K1's keep
    sets against its plain version on the int8 trunk's candidates; a
    BatchedPipeline graph with the int8 trunk against eager; the detect
    stage's device ms (graph replay) against the bf16 trunk at B = 1, 4, 16,
    and infer_frames at B = 4 with and without the 1x1 trunk on both ViT
    paths, in turns; then the card against the CPU at 64."""
    import torch

    from hamer_yolo_tpu_torch.core.quant import calibrate_yolo_act_scales, quantize_yolo_params
    from hamer_yolo_tpu_torch.io.images import letterbox_centered
    from hamer_yolo_tpu_torch.ops.nms import greedy_nms_keep, greedy_nms_keep_ref
    from hamer_yolo_tpu_torch.pipeline.frame import detect_hands_batched, infer_frames
    from hamer_yolo_tpu_torch.pipeline.runner import default_intrinsics
    from hamer_yolo_tpu_torch.pipeline.serving import BatchedPipeline

    frames = frames_720p(max(DETECT_BATCHES + (BATCH,)), SEED + 5)
    K = default_intrinsics(frames[0].shape)
    calib = [letterbox_centered(f, cfg.det_size)[..., ::-1].astype(np.float32) / 255.0
             for f in frames[:2]]
    yolo = {"bf16": params["yolo"]}
    for mode in ("1x1", "all"):
        t0 = time.perf_counter()
        q = quantize_yolo_params(params["yolo"], only_1x1=mode == "1x1")
        yolo[mode] = calibrate_yolo_act_scales(q, calib, cfg.yolo)
        torch.cuda.synchronize()
        sx = torch.stack(list(_tree_leaves(yolo[mode], "sx")))
        print(f"int8 detector {mode}: quantized and calibrated on 2 letterboxed 720p frames in "
              f"{time.perf_counter() - t0:.2f} s: {len(sx)} int8 convs, sx "
              f"{float(sx.min()):.4g}..{float(sx.max()):.4g}")

    def batch(B):
        return (torch.from_numpy(np.stack(frames[:B])).to(dev).to(torch.float32),
                torch.tensor([[720.0, 1280.0]] * B, device=dev),
                torch.from_numpy(np.stack([K] * B)).to(dev))

    imgs, hws, Ks = batch(BATCH)
    none = dict.fromkeys(KERNELS, 0)
    for mode in ("1x1", "all"):
        for vit, p, c, want in (("bf16", params, cfg, {"K1": 1, "K2": depth}),
                                ("int8 static", sparams, qcfg,
                                 {"K1": 1, "K3": depth, "K4": depth})):
            p = {**p, "yolo": yolo[mode]}
            with torch.inference_mode():
                out, n = run_counted(lambda: infer_frames(p, mano, imgs, hws, Ks, c))
            print(f"int8 detector {mode} + {vit} ViT: infer_frames batch {BATCH} -> "
                  f"{int(out['valid'].sum())} valid slots; launches {n}")
            expect_launches(f"int8 detector {mode} + {vit} ViT", n, {**none, **want})
            check_batch(out, cfg, f"int8 detector {mode} + {vit} ViT")
        cands = detector_candidates(yolo[mode], cfg, dev, BATCH)
        bx, act = cands.shifted.contiguous(), cands.active.to(torch.float32)
        got, ref = greedy_nms_keep(bx, act, cfg.iou_thres), greedy_nms_keep_ref(bx, act,
                                                                              cfg.iou_thres)
        if not torch.equal(got, ref):
            raise RuntimeError(f"K1 on the int8 {mode} trunk's candidates: keep sets differ")
        print(f"K1 on the int8 {mode} trunk's candidates at B {BATCH}: keep set identical to "
              f"its plain version ({int(got.sum())} kept of {int(act.sum())} active)")

    pipe = BatchedPipeline({**params, "yolo": yolo["all"]}, mano, cfg, batch_size=BATCH,
                           device=dev)
    got, n = run_counted(lambda: pipe.process_batch(frames[:BATCH], K))
    expect_launches("int8 detector all: BatchedPipeline capture", n,
                    {**none, "K1": CAPTURE_RUNS, "K2": CAPTURE_RUNS * depth})
    again, n = run_counted(lambda: pipe.process_batch(frames[:BATCH], K))
    expect_launches("int8 detector all: BatchedPipeline replay", n, none)
    hold_to_eager(again, eager_batch(pipe, frames[:BATCH], K),
                  eager_batch(pipe, frames[:BATCH], K), "int8 detector all, BatchedPipeline")
    if any(not np.array_equal(got[k], again[k]) for k in got):
        raise RuntimeError("int8 detector all: two replays of one graph differ")

    for B in DETECT_BATCHES:
        bi, bh, _ = batch(B)
        stages = {m: (lambda p=yolo[m]: detect_hands_batched(p, bi, bh, cfg))
                  for m in ("bf16", "1x1", "all")}
        with torch.inference_mode():
            times = _in_turns(stages, lambda fn: graph_time_ms(fn, reps=5, iters=5))
            tops = {m: top_kernels(fn) for m, fn in stages.items()} if B == 16 else {}
        print(f"detect stage B {B} (letterbox, YOLOv7 at {cfg.det_size}, NMS on K1), device ms "
              f"by graph replay, in turns: {_fmt_turns(times)}")
        for m, (total, n_kernels, top) in tops.items():
            print(f"detect stage B {B}, {m} trunk, one eager call under torch.profiler: "
                  f"{total:.3f} device ms in {n_kernels} kernels; the largest by name: "
                  + "; ".join(f"{name[:60]} {ms:.3f} ms x{count}" for name, ms, count in top))
    runs = {"bf16 ViT, bf16 trunk": (params, cfg),
            "bf16 ViT, int8 1x1 trunk": ({**params, "yolo": yolo["1x1"]}, cfg),
            "int8 static ViT, bf16 trunk": (sparams, qcfg),
            "int8 static ViT, int8 1x1 trunk": ({**sparams, "yolo": yolo["1x1"]}, qcfg)}
    with torch.inference_mode():
        times = _in_turns({k: (lambda p=p, c=c: infer_frames(p, mano, imgs, hws, Ks, c))
                           for k, (p, c) in runs.items()}, lambda fn: cuda_time_ms(fn, iters=5))
    print(f"e2e infer_frames b{BATCH} 720p, ms (CUDA events, 2 warm-up, 5 timed), in turns: "
          f"{_fmt_turns(times)}")
    check_reference_int8_detector(dev)


def top_kernels(fn, n=6, tries=3):
    """(device ms, kernels, [(name, ms, launches)] of the n largest by name)
    of one call of fn under torch.profiler, after one call outside it; a
    session that records no device activity is tried again."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    by_name = {}
    for _ in range(tries):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        for ev in prof.events():
            if ev.device_type == torch.autograd.DeviceType.CUDA:
                ms, count = by_name.get(ev.name, (0.0, 0))
                by_name[ev.name] = (ms + ev.time_range.elapsed_us() / 1e3, count + 1)
        if by_name:
            break
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:n]
    return (sum(ms for ms, _ in by_name.values()), sum(c for _, c in by_name.values()),
            [(name, ms, count) for name, (ms, count) in top])


def check_reference_int8_detector(dev) -> None:
    """The --tiny detector (YOLOv7's widths at 64) quantized and calibrated
    on the CPU, on the card against the CPU: every int8 conv on the CPU's
    own input bit-equal (int32 sums are exact); over the whole forward the
    int8 activations that differ (quantize flips, from the floating-point
    ops before them: cuDNN's conv sums where spatial convs stay bf16, the
    elementwise ops) counted, as ROADMAP F8 counts them; the scales
    calibrated on the card within CALIB_REL of the CPU's; the decoded
    output as accurate as the CPU's against the CPU's f32 float detector
    within a factor BF16_ACCURACY_FACTOR."""
    import torch

    from hamer_yolo_tpu_torch.cli.main import pipeline_config
    from hamer_yolo_tpu_torch.core import int8_conv
    from hamer_yolo_tpu_torch.core.quant import calibrate_yolo_act_scales, quantize_yolo_params
    from hamer_yolo_tpu_torch.models.yolov7.model import init_yolov7, yolov7_forward

    ycfg = pipeline_config(tiny=True).yolo
    params = init_yolov7(torch.Generator().manual_seed(SEED), ycfg)
    rng = np.random.default_rng(SEED + 6)
    calib = list(rng.random((2, 64, 64, 3)).astype(np.float32))
    x = torch.from_numpy(rng.random((4, 64, 64, 3)).astype(np.float32))
    ref32 = yolov7_forward(params, x, dataclasses.replace(ycfg, compute_dtype="float32"))
    conv = int8_conv.int8_conv2d

    def recorded(tree, inp):
        calls = []

        def record(p, xx, *args):
            calls.append((p, xx, args))
            return conv(p, xx, *args)

        int8_conv.int8_conv2d = record
        try:
            with torch.inference_mode():
                out = yolov7_forward(tree, inp, ycfg)
        finally:
            int8_conv.int8_conv2d = conv
        return out, calls

    for mode in ("1x1", "all"):
        q = quantize_yolo_params(params, only_1x1=mode == "1x1")
        tree = calibrate_yolo_act_scales(q, calib, ycfg)
        card_sx = torch.stack([t.cpu() for t in _tree_leaves(calibrate_yolo_act_scales(
            _to(q, dev), calib, ycfg), "sx")])
        cpu_sx = torch.stack(list(_tree_leaves(tree, "sx")))
        rel = float(((card_sx - cpu_sx).abs() / cpu_sx).max())
        ref, ref_calls = recorded(tree, x)
        got, got_calls = recorded(_to(tree, dev), x.to(dev))
        same_input = flips = total = 0
        for (p, xc, args), (_, xg, _) in zip(ref_calls, got_calls):
            with torch.inference_mode():
                on_card = conv(_to(p, dev), xc.to(dev), *args).cpu()
                if not torch.equal(on_card, conv(p, xc, *args)):
                    raise RuntimeError(f"int8 detector {mode}: an int8 conv on the card departs "
                                       "from the CPU's on the same input")
                same_input += 1
                qc = int8_conv._quantize(xc, p["sx"])
                qg = int8_conv._quantize(xg.cpu(), p["sx"])
            flips += int((qc != qg).sum())
            total += qc.numel()
        got = got.cpu()
        floor = float((ref - ref32).abs().max())
        err = float((got - ref32).abs().max())
        print(f"int8 detector {mode} at 64, card against CPU: {same_input} int8 convs bit-equal "
              f"on the CPU's own inputs; over the whole forward {flips} of {total} int8 "
              f"activations differ ({flips / total:.2e}); decoded output max diff "
              f"{float((got - ref).abs().max()):.4g}; |card - CPU f32| {err:.4g} against |CPU "
              f"int8 - CPU f32| {floor:.4g}; scales calibrated on the card within {rel:.2e} "
              "of the CPU's")
        if not torch.isfinite(got).all() or err > BF16_ACCURACY_FACTOR * floor or rel > CALIB_REL:
            raise RuntimeError(f"int8 detector {mode}: the card departs from the CPU")


def convnext_sar_phase(params, mano, cfg, dev):
    """SAR with ConvNeXt-base (1024 channels) at 256 beside ResNet-34's: the
    depth stage (estimate_depths: patches, backbone, RootNet) on 16 slots of
    four 720p frames, device ms by graph replay in turns; sar_full_mesh on
    four slots of a 720p frame with RootNet's k value and with a depth
    image, timed; no kernel launches on either; then the card against the
    CPU at 64. The layer scale gamma is redrawn to U(0.5, 1) (the init's
    1e-6 would leave the blocks out of the sum)."""
    import torch

    from hamer_yolo_tpu_torch.models.sar import init_sar
    from hamer_yolo_tpu_torch.pipeline.frame import detect_hands_batched, estimate_depths
    from hamer_yolo_tpu_torch.pipeline.runner import default_intrinsics
    from hamer_yolo_tpu_torch.pipeline.sar_mesh import sar_full_mesh

    ccfg = dataclasses.replace(cfg, sar=dataclasses.replace(cfg.sar, backbone="convnext"))
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED + 7)
    csar = convnext_gamma(init_sar(gen, mano.v_template, ccfg.sar), gen)
    n_params = sum(t.numel() for t in _tree_leaves(csar["backbone"]))
    frames = frames_720p(BATCH, SEED + 8)
    K = default_intrinsics(frames[0].shape)
    imgs = torch.from_numpy(np.stack(frames)).to(dev).to(torch.float32)
    hws = torch.tensor([[720.0, 1280.0]] * BATCH, device=dev)
    Ks = torch.from_numpy(np.stack([K] * BATCH)).to(dev)
    boxes = torch.tensor([[200.0, 150, 420, 390], [600, 100, 760, 300], [900, 380, 1180, 700],
                          [40, 500, 200, 690]], device=dev)
    with torch.inference_mode():
        dets = detect_hands_batched(params["yolo"], imgs, hws, cfg)
        dets = {**dets, "boxes": boxes.expand(BATCH, 4, 4).contiguous()}
        depths, n = run_counted(lambda: estimate_depths(csar, imgs, dets, hws, Ks, ccfg))
        expect_launches("ConvNeXt SAR depth stage", n, dict.fromkeys(KERNELS, 0))
        if depths.shape != (BATCH, 4) or not torch.isfinite(depths).all():
            raise RuntimeError(f"ConvNeXt SAR depth stage: {depths}")
        times = _in_turns({"resnet34": lambda: estimate_depths(params["sar"], imgs, dets, hws,
                                                               Ks, cfg),
                           "convnext": lambda: estimate_depths(csar, imgs, dets, hws, Ks, ccfg)},
                          lambda fn: graph_time_ms(fn, reps=3, iters=5))
    print(f"ConvNeXt SAR: ConvNeXt-base {n_params:,} backbone parameters; depth stage on "
          f"{BATCH * 4} slots at {cfg.sar.input_size} ({cfg.sar.compute_dtype}), device ms by "
          f"graph replay, in turns: {_fmt_turns(times)}; depths "
          f"{float(depths.min()):.4g}..{float(depths.max()):.4g} (random weights)")
    depth_img = torch.from_numpy(np.random.default_rng(SEED + 8).uniform(
        0.3, 1.5, (720, 1280)).astype(np.float32)).to(dev)
    hw, Kt = hws[0], Ks[0]
    for sar_p, scfg, name in ((params["sar"], cfg.sar, "resnet34"), (csar, ccfg.sar, "convnext")):
        for dimg in (None, depth_img):
            extra = () if dimg is None else (dimg,)
            flip = torch.tensor([0.0, 1.0, 0.0, 1.0], device=dev)
            with torch.inference_mode():
                out, n = run_counted(lambda: sar_full_mesh(sar_p, imgs[0], boxes, hw, Kt, scfg,
                                                           flip, *extra))
                ms = cuda_time_ms(lambda: sar_full_mesh(sar_p, imgs[0], boxes, hw, Kt, scfg,
                                                        flip, *extra), iters=5)
            expect_launches(f"sar_full_mesh {name}", n, dict.fromkeys(KERNELS, 0))
            if out["mesh_xyz"].shape != (4, 778, 3) or not all(
                    torch.isfinite(v).all() for v in out.values()):
                raise RuntimeError(f"sar_full_mesh {name}: bad outputs")
            root = "depth image" if dimg is not None else "k value"
            print(f"sar_full_mesh {name}, root depth from the {root}: 4 slots of a 720p frame, "
                  f"p50 {ms:.3f} ms (CUDA events, 2 warm-up, 5 timed); root depths "
                  f"{[round(float(v), 4) for v in out['root_depth']]}")
    check_reference_convnext_sar(dev)


def convnext_gamma(sar, gen):
    """The SAR tree with each ConvNeXt block's gamma drawn from U(0.5, 1)."""
    import torch

    for blocks in sar["backbone"]["stages"]:
        for blk in blocks:
            blk["gamma"] = torch.rand(blk["gamma"].shape, generator=gen,
                                      device=blk["gamma"].device) * 0.5 + 0.5
    return sar


def check_reference_convnext_sar(dev) -> None:
    """SAR with ConvNeXt-base at 64 (the --tiny SAR size), card against CPU:
    f32 uvd at the SAR limit (atol 1e-2, rtol 1e-3) and bf16 within
    BF16_ACCURACY_FACTOR of the CPU's bf16 against f32; sar_full_mesh in f32
    with both root depths, uvd at the SAR limit, xyz and root depth at 2e-3."""
    import torch

    from hamer_yolo_tpu_torch.core.mano_assets import synthetic_mano_model
    from hamer_yolo_tpu_torch.models.mano import ManoModel
    from hamer_yolo_tpu_torch.models.sar import SarConfig, init_sar, sar_forward
    from hamer_yolo_tpu_torch.pipeline.sar_mesh import sar_full_mesh

    small = dict(backbone="convnext", input_size=64, feature_hw=2, heatmap_size=8)
    mano = ManoModel.from_arrays(synthetic_mano_model(SEED))
    gen = torch.Generator().manual_seed(SEED)
    params = convnext_gamma(init_sar(gen, mano.v_template, SarConfig(**small)), gen)
    rng = np.random.default_rng(SEED + 10)
    x = torch.from_numpy(rng.normal(size=(4, 64, 64, 3)).astype(np.float32))
    out = {}
    for dt in ("float32", "bfloat16"):
        c = SarConfig(**small, compute_dtype=dt)
        with torch.inference_mode():
            out[dt] = (sar_forward(params, x, c).double(),
                       sar_forward(_to(params, dev), x.to(dev), c).double().cpu())
    cpu32, card32 = out["float32"]
    cpu16, card16 = out["bfloat16"]
    d32 = float((card32 - cpu32).abs().max())
    bad32 = not torch.allclose(card32, cpu32, rtol=1e-3, atol=1e-2)
    floor, err = float((cpu16 - cpu32).abs().max()), float((card16 - cpu32).abs().max())
    c = SarConfig(**small, compute_dtype="float32")
    img = torch.from_numpy(rng.uniform(0, 255, (90, 120, 3)).astype(np.float32))
    boxes = torch.tensor([[10.0, 20, 60, 70], [50, 5, 110, 80], [0, 0, 30, 30], [40, 40, 100, 88]])
    hw, flip = torch.tensor([90.0, 120.0]), torch.tensor([0.0, 1.0, 0.0, 1.0])
    K = torch.tensor([[300.0, 0, 60], [0, 310.0, 45], [0, 0, 1]])
    dimg = torch.from_numpy(rng.uniform(0.3, 1.5, (90, 120)).astype(np.float32))
    mesh_err = {}
    for extra in ((), (dimg,)):
        with torch.inference_mode():
            ref = sar_full_mesh(params, img, boxes, hw, K, c, flip, *extra)
            got = sar_full_mesh(_to(params, dev), img.to(dev), boxes.to(dev), hw.to(dev),
                                K.to(dev), c, flip.to(dev), *(t.to(dev) for t in extra))
        for k, r in ref.items():
            g = got[k].cpu()
            tol = dict(rtol=1e-3, atol=1e-2) if "uvd" in k else dict(rtol=0.0, atol=2e-3)
            mesh_err[k] = max(mesh_err.get(k, 0.0), float((g - r).abs().max()))
            bad32 |= not torch.allclose(g, r, **tol)
    print(f"ConvNeXt SAR at 64, card against CPU: f32 uvd max diff {d32:.3g}; bf16 |card - "
          f"CPU f32| {err:.4g} against |CPU bf16 - CPU f32| {floor:.4g}; sar_full_mesh (both "
          f"root depths) max diffs {', '.join(f'{k} {v:.3g}' for k, v in mesh_err.items())}")
    if bad32 or err > BF16_ACCURACY_FACTOR * floor:
        raise RuntimeError("ConvNeXt SAR: the card departs from the CPU")


def overlay_phase(dev):
    """Two MANO hands (the CLI's MANO: cli.main.load_mano; seeded poses,
    left and right, at 30 m under the
    default intrinsics of 720p, about 170 px high) composited onto a 720p
    frame by lit_mesh_overlay on the card and on the CPU: the same face at
    every supersample (alpha equal), the uint8 images equal but for at most
    OVERLAY_MAX_DIFF_FRAC of the pixels by one level (f64 shading rounds as
    each device's libm and BLAS round); times on the host clock, whole calls
    (upload, render, copy back), in turns; then ``reconstruct
    --overlay-images`` through cli.main (cv2_stand_in) writes the card's
    image. ``detect --save-img`` draws with cv2 and is not run here."""
    import io

    import torch

    from hamer_yolo_tpu_torch.cli.main import load_mano, main as cli
    from hamer_yolo_tpu_torch.io.writers import save_hand_npy
    from hamer_yolo_tpu_torch.pipeline.reconstruct import reconstruct_hand_mesh
    from hamer_yolo_tpu_torch.pipeline.runner import default_intrinsics
    from hamer_yolo_tpu_torch.utils.render import lit_mesh_overlay, rasterize_mesh

    rng = np.random.default_rng(SEED + 11)
    frame = frames_720p(1, SEED + 12)[0]
    K = default_intrinsics(frame.shape)
    hands = {side: {"theta": (0.3 * rng.normal(size=48)).astype(np.float32),
                    "betas": (0.5 * rng.normal(size=10)).astype(np.float32),
                    "pose_hand": np.zeros(45, np.float32), "pose_global": np.zeros(3, np.float32),
                    "is_right": float(side == "right"),
                    "cam_t": np.array([0.1 if side == "right" else -0.1, 0.02, 30.0], np.float32)}
             for side in ("left", "right")}
    mano = load_mano(None, dev)
    meshes = [reconstruct_hand_mesh(mano, hands[s]) for s in ("left", "right")]

    def overlay(device):
        out = frame
        for m in meshes:
            out = lit_mesh_overlay(out, m["vertices"], m["faces"], K, device=device)
        return out

    (card, n) = run_counted(lambda: overlay(dev))
    expect_launches("lit_mesh_overlay", n, dict.fromkeys(KERNELS, 0))
    cpu = overlay("cpu")
    for m in meshes:
        a_card = rasterize_mesh(m["vertices"], m["faces"], K, frame.shape[:2], device=dev)[1]
        a_cpu = rasterize_mesh(m["vertices"], m["faces"], K, frame.shape[:2])[1]
        if not torch.equal(a_card.cpu(), a_cpu):
            raise RuntimeError("lit overlay: the card's coverage departs from the CPU's")
    diff = np.abs(card.astype(int) - cpu.astype(int)).max(-1)
    covered = int((cpu != frame).any(-1).sum())
    times = interleaved_p50({"card": lambda: overlay(dev), "cpu": lambda: overlay("cpu")},
                            rounds=2)
    with torch.inference_mode():
        dev_ms = cuda_time_ms(lambda: rasterize_mesh(meshes[0]["vertices"], meshes[0]["faces"], K,
                                                     frame.shape[:2], device=dev), iters=5)
    print(f"lit_mesh_overlay, two hands on a 720p frame ({covered} pixels covered): card "
          f"{times['card']:.2f} ms, CPU {times['cpu']:.2f} ms a frame (host clock, whole calls, "
          f"in turns; 1 warm-up, 4 timed each); one hand's rasterize_mesh on the card "
          f"{dev_ms:.2f} ms (CUDA events); card against CPU: coverage equal, {int((diff > 0).sum())}"
          f" pixels differ, by at most {int(diff.max())}")
    if covered < 1000 or diff.max() > 1 or (diff > 0).sum() > OVERLAY_MAX_DIFF_FRAC * diff.size:
        raise RuntimeError("lit overlay: the card's image departs from the CPU's")
    saved = sys.modules.get("cv2")
    sys.modules["cv2"] = cv2_stand_in()
    try:
        with tempfile.TemporaryDirectory() as root:
            for d in ("npys", "imgs", "out"):
                os.makedirs(os.path.join(root, d))
            save_hand_npy(os.path.join(root, "npys", "f0.npy"), hands)
            with open(os.path.join(root, "imgs", "f0.png"), "wb") as fh:
                np.save(fh, frame)
            out = io.StringIO()
            with contextlib.redirect_stdout(out):
                rc = cli(["reconstruct", "--input", os.path.join(root, "npys"), "--output",
                          os.path.join(root, "out"), "--overlay-images",
                          os.path.join(root, "imgs")])
            written = np.load(os.path.join(root, "out", "f0_overlay.png"))
    finally:
        if saved is None:
            sys.modules.pop("cv2", None)
        else:
            sys.modules["cv2"] = saved
    print(f"cli reconstruct --overlay-images: rc {rc}; {out.getvalue().strip()}; f0_overlay.png "
          f"{'equal to' if np.array_equal(written, card) else 'DIFFERENT from'} the card's "
          "overlay. detect --save-img draws with cv2 (rectangle, text), which this machine "
          "lacks: not run here (tests/test_torch_overlays.py holds it against the JAX CLI "
          "on the CPU)")
    if rc or not np.array_equal(written, card):
        raise RuntimeError("cli reconstruct --overlay-images: not the card's overlay")

# -- training ----------------------------------------------------------------
TRAIN_TIMED = 3            # train steps timed after one warm-up step
HAMER_TRAIN_B, YOLO_TRAIN_B, KPF_TRAIN_B = 8, 8, 4


def _captured(fn, *args):
    """(fn(*args), what it printed), the print passed on as well."""
    import io

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = fn(*args)
    print(buf.getvalue(), end="")
    return rc, buf.getvalue()


def _allocated():
    import torch

    torch.cuda.synchronize()
    return torch.cuda.memory_allocated()


def _timed_steps(step, base, iters=TRAIN_TIMED):
    """(median ms, [ms of each], the peak memory in bytes above ``base``,
    last metrics): ``step()`` once to warm up, then ``iters`` times between
    CUDA events. The peak is of all of them, the warm-up's included (it
    makes the optimizer's state); ``base`` is what was allocated before the
    model's train state and batch were made (_allocated), so the peak holds
    them and not what earlier phases hold."""
    import torch

    torch.cuda.reset_peak_memory_stats()
    step()
    torch.cuda.synchronize()
    times, out = [], None
    for _ in range(iters):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        out = step()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times)), times, torch.cuda.max_memory_allocated() - base, out


def _finite(metrics, what):
    bad = {k: float(v) for k, v in metrics.items() if not np.isfinite(float(v))}
    if bad:
        raise RuntimeError(f"{what}: non-finite losses {bad}")


def _gib(nbytes):
    return nbytes / 2 ** 30


def print_train_profile(what, step):
    """One train step under torch.profiler (top_kernels): its device ms, its
    kernels and the six largest by name."""
    dev_ms, kernels, top = top_kernels(step)
    if not kernels:
        print(f"training {what}: profile not measured (the session recorded no device activity)")
        return
    print(f"training {what} step under torch.profiler: {dev_ms:.2f} device ms in {kernels} "
          f"kernels; largest: " + "; ".join(f"{name[:60]} {ms:.2f} ms ({n})"
                                           for name, ms, n in top))


def training_phase(dev, smi):
    """The phase "training" at full width. HaMeR at the default HamerConfig (ViT-H, 32 blocks of 1280,
    16 heads; the 6-layer MANO head; the discriminator):
    tools/train_hamer.main --batch 8 --steps 3 --viz-every 2 --ckpt-every 2,
    then --resume auto for a fourth step (the viz's forwards under no_grad
    run K2, 32 launches each; the train steps launch no kernel); YOLOv7 in
    training form at 640, four steps of make_yolo_train_step at B = 8;
    KPFusion at the default KPFusionConfig, tools/train_kpfusion_rgbd.main
    --batch 4 --steps 2. Each model's train step is timed after one warm-up
    (CUDA events) with its peak memory, and profiled once (the largest
    kernels by device time); then the card against the CPU
    (tests/test_torch_train_pairs.py: one f32 step from the same weights and
    batch, HaMeR at full width with 2 blocks, YOLO at 64 px and B = 8,
    KPFusion at --tiny), a train state reloaded bit-equal, and K2 refusing a
    token tensor that requires grad. The viz's K2 launches are checked and
    printed here: the kernels line counts the bf16 path's own."""
    import torch

    t0 = time.perf_counter()
    saved = sys.modules.get("cv2")
    sys.modules["cv2"] = cv2_stand_in()
    try:
        with tempfile.TemporaryDirectory() as root:
            hamer_training(dev, smi, root)
            yolo_training(dev, smi)
            kpfusion_training(dev, smi, root)
            training_card_against_cpu(dev, root)
    finally:
        if saved is None:
            del sys.modules["cv2"]
        else:
            sys.modules["cv2"] = saved
    check_f22(dev)
    torch.cuda.empty_cache()
    print(f"phase training: {time.perf_counter() - t0:.1f} s")


def hamer_training(dev, smi, root):
    import torch

    from hamer_yolo_tpu_torch.cli.main import load_mano
    from hamer_yolo_tpu_torch.models.hamer import HamerConfig
    from hamer_yolo_tpu_torch.tools import train_hamer as tool
    from hamer_yolo_tpu_torch.training import train_hamer as T

    out = os.path.join(root, "hamer")
    args = ["--batch", str(HAMER_TRAIN_B), "--viz-every", "2", "--ckpt-every", "2",
            "--device", "cuda", "--out", out]
    t0 = time.perf_counter()
    (rc, _), n = run_counted(lambda: _captured(tool.main, args + ["--steps", "3"]))
    t_run = time.perf_counter() - t0
    depth = HamerConfig().vit.depth
    expect_launches("train_hamer (3 steps, viz at steps 0 and 2)", n,
                    {k: (2 * depth if k == "K2" else 0) for k in n})
    files = sorted(os.listdir(out))
    imgs = sorted(os.listdir(os.path.join(out, "images")))
    if rc != 0 or files != ["ckpt_2.npz", "ckpt_final.npz", "images", "metrics.jsonl"] \
            or imgs != ["pred_grid_0.png", "pred_grid_2.png"]:
        raise RuntimeError(f"train_hamer: rc {rc}, files {files}, images {imgs}")
    with open(os.path.join(out, "metrics.jsonl")) as f:
        recs = [json.loads(line) for line in f]
    if [r["step"] for r in recs] != [0]:
        raise RuntimeError(f"train_hamer: metrics.jsonl steps {[r['step'] for r in recs]}")
    _finite(recs[0], "train_hamer step 0")
    ckpt_gb = os.path.getsize(os.path.join(out, "ckpt_final.npz")) / 1e9
    os.remove(os.path.join(out, "ckpt_2.npz"))  # one full-width train state on disk at a time
    t0 = time.perf_counter()
    (rc, log), n2 = run_counted(lambda: _captured(tool.main, args + ["--steps", "4",
                                                                      "--resume", "auto"]))
    t_resume = time.perf_counter() - t0
    expect_launches("train_hamer --resume auto (step 3, no viz)", n2, {k: 0 for k in n2})
    if rc != 0 or "resumed at step 3" not in log:
        raise RuntimeError(f"train_hamer --resume auto: rc {rc}, did not resume at step 3")

    cfg = HamerConfig()
    base = _allocated()
    state = T.init_train_state(torch.Generator(dev).manual_seed(0), cfg)
    batch = T.synthetic_batch(torch.Generator(dev).manual_seed(1), HAMER_TRAIN_B, cfg)
    mano = load_mano(None, dev)
    n_params = sum(t.numel() for t in _tree_leaves(state.params))
    n_disc = sum(t.numel() for t in _tree_leaves(state.disc_params))
    (ms, times, peak, metrics), n3 = run_counted(lambda: _timed_steps(
        lambda: T.train_step(state, batch, mano, cfg), base))
    expect_launches("HaMeR train steps", n3, {k: 0 for k in n3})
    _finite(metrics, "HaMeR train step")
    print(f"training HaMeR (ViT-H, {depth} blocks of {cfg.vit.embed_dim}; {n_params:,} + "
          f"{n_disc:,} discriminator parameters) B={HAMER_TRAIN_B}: train_hamer 3 steps with "
          f"the viz twice and 2 checkpoints {t_run:.1f} s (K2 {n['K2']} launches, the train "
          f"steps none), --resume auto at step 3 {t_resume:.1f} s; a checkpoint "
          f"{ckpt_gb:.2f} GB; train step p50 {ms:.2f} ms ({', '.join(f'{t:.2f}' for t in times)};"
          f" CUDA events, 1 warm-up), peak memory {_gib(peak):.2f} GiB above what the phase "
          f"held before; total "
          f"{float(metrics['total']):.4f}, disc {float(metrics['disc_loss']):.4f} on {smi}")
    print_train_profile("HaMeR", lambda: T.train_step(state, batch, mano, cfg))
    del state, batch
    torch.cuda.empty_cache()


def yolo_training(dev, smi):
    import torch

    from hamer_yolo_tpu_torch.models.yolov7.model import YoloConfig
    from hamer_yolo_tpu_torch.training import train_yolo as T

    cfg = YoloConfig()
    base = _allocated()
    state = T.init_yolo_train_state(torch.Generator(dev).manual_seed(0), cfg)
    batch = T.synthetic_yolo_batch(torch.Generator(dev).manual_seed(1), YOLO_TRAIN_B,
                                   cfg.img_size)
    step = T.make_yolo_train_step(cfg)
    mean0 = state.params["layers"][0]["bn"]["mean"].clone()
    n_params = sum(t.numel() for t in _tree_leaves(state.params))
    (ms, times, peak, metrics), n = run_counted(lambda: _timed_steps(lambda: step(state, batch),
                                                                     base))
    expect_launches("YOLO train steps", n, {k: 0 for k in n})
    _finite(metrics, "YOLO train step")
    moved = float((state.params["layers"][0]["bn"]["mean"] - mean0).abs().max())
    steps = 1 + TRAIN_TIMED
    if state.step != steps or state.ema.updates != steps or not moved > 0:
        raise RuntimeError(f"YOLO train: step {state.step}, EMA updates {state.ema.updates}, "
                           f"BN mean moved {moved}")
    print(f"training YOLOv7 (training form, {n_params:,} parameters, {cfg.compute_dtype}) at "
          f"{cfg.img_size} B={YOLO_TRAIN_B}: {steps} steps, the EMA counted "
          f"{state.ema.updates}, BN stats moved; train step p50 {ms:.2f} ms "
          f"({', '.join(f'{t:.2f}' for t in times)}; CUDA events, 1 warm-up), peak memory "
          f"{_gib(peak):.2f} GiB above what the phase held before; loss "
          f"{float(metrics['loss']):.4f} on {smi}")
    print_train_profile("YOLOv7", lambda: step(state, batch))
    del state, batch
    torch.cuda.empty_cache()


def kpfusion_training(dev, smi, root):
    import torch

    from hamer_yolo_tpu_torch.models.kpfusion_rgbd.model import KPFusionConfig
    from hamer_yolo_tpu_torch.tools import train_kpfusion_rgbd as tool
    from hamer_yolo_tpu_torch.training import train_kpfusion_rgbd as T

    out = os.path.join(root, "kpfusion")
    t0 = time.perf_counter()
    (rc, _), n = run_counted(lambda: _captured(tool.main, [
        "--batch", str(KPF_TRAIN_B), "--steps", "2", "--log-every", "1", "--device", "cuda",
        "--out", out]))
    t_run = time.perf_counter() - t0
    expect_launches("train_kpfusion_rgbd", n, {k: 0 for k in n})
    with open(os.path.join(out, "metrics.jsonl")) as f:
        recs = [json.loads(line) for line in f]
    if rc != 0 or [r["step"] for r in recs] != [0, 1]:
        raise RuntimeError(f"train_kpfusion_rgbd: rc {rc}, logged steps "
                           f"{[r['step'] for r in recs]}")
    for r in recs:
        _finite(r, "train_kpfusion_rgbd")
    cfg = KPFusionConfig()
    base = _allocated()
    state = T.init_train_state(torch.Generator(dev).manual_seed(0), cfg)
    batch = {k: torch.from_numpy(v).to(dev) for k, v in
             T.synthetic_rgbd_batch(np.random.default_rng(1), KPF_TRAIN_B, cfg).items()}
    (ms, times, peak, metrics), n2 = run_counted(lambda: _timed_steps(
        lambda: T.train_step(state, batch, cfg), base))
    expect_launches("KPFusion train steps", n2, {k: 0 for k in n2})
    _finite(metrics, "KPFusion train step")
    print(f"training KPFusion (default config) B={KPF_TRAIN_B}: train_kpfusion_rgbd 2 steps "
          f"{t_run:.1f} s; train step p50 {ms:.2f} ms ({', '.join(f'{t:.2f}' for t in times)};"
          f" CUDA events, 1 warm-up), peak memory {_gib(peak):.2f} GiB above what the phase "
          f"held before; loss "
          f"{float(metrics['loss']):.4f} on {smi}")
    print_train_profile("KPFusion", lambda: T.train_step(state, batch, cfg))
    del state, batch
    torch.cuda.empty_cache()


def training_card_against_cpu(dev, root):
    """tests/test_torch_train_pairs.py's cases, held at its limits with no kernel
    launched, and the HaMeR card state after its step saved and reloaded
    bit-equal."""
    import torch

    from hamer_yolo_tpu_torch.training import train_hamer as TH
    from hamer_yolo_tpu_torch.training.optim import named_leaves

    sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), "tests"))
    import test_torch_train_pairs as P

    res, n = run_counted(lambda: {case: P.card_against_cpu(case[0], dev, case[1], case[2])
                                  for case in P.CASES})
    expect_launches("train steps, card against CPU", n, {k: 0 for k in n})
    card = next(r["card"] for case, r in res.items() if case[0] == "hamer")
    path = os.path.join(root, "hamer_state.npz")
    TH.save_train_state(path, card)
    fresh = TH.load_train_state(path, TH.make_train_state(card.params, card.disc_params))
    for (k, a), (_, b) in zip(named_leaves(TH.state_tree(card)), named_leaves(TH.state_tree(fresh))):
        if not torch.equal(torch.as_tensor(a).cpu(), torch.as_tensor(b).cpu()):
            raise RuntimeError(f"HaMeR train state reload: {k} not bit-equal")
    if fresh.step != 1:
        raise RuntimeError(f"HaMeR train state reload: step {fresh.step}")
    parts = []
    for (model, b, img), r in res.items():
        err, leaf = r["worst"]
        part = (f"{model} B={b}{f' at {img} px' if img else ''} {err:.2e} ({leaf}; limit "
                f"{P.GRAD_REL[model]})")
        if "f64" in r:
            f64 = r["f64"]
            part += (" [f32 from f64 at that leaf: card {:.2e}, CPU {:.2e}; ".format(
                *f64["at_worst"]) + "; ".join(f"{d}'s worst {f64[d][0]:.2e} ({f64[d][1]})"
                                              for d in ("card", "cpu")) + "]")
        parts.append(part)
    print("training card against CPU (one f32 step, same weights and batch, "
          f"tests/test_torch_train_pairs.py; loss limits {P.LOSS_REL}): worst gradient "
          + "; ".join(parts) + "; the HaMeR train state reloaded bit-equal")


def check_f22(dev):
    """K2's wrapper refuses a token tensor that requires grad under grad
    mode, on the card; under no_grad the same call launches."""
    import torch

    from hamer_yolo_tpu_torch.ops.attn_block import fused_bf16_attn_block

    g = torch.Generator(dev).manual_seed(8)
    tok = torch.randn(2, 192, 1280, generator=g, device=dev, dtype=torch.bfloat16)
    w = 0.02 * torch.randn(1280, 3840, generator=g, device=dev)
    args = (w, torch.zeros(3840, device=dev), torch.ones(1280, device=dev),
            torch.zeros(1280, device=dev), 16)
    try:
        fused_bf16_attn_block(tok.clone().requires_grad_(True), *args)
    except ValueError as e:
        if "fused_bf16_attn_block" not in str(e):
            raise
    else:
        raise RuntimeError("K2 took a token tensor that requires grad under grad mode")
    with torch.no_grad():
        out = fused_bf16_attn_block(tok.clone().requires_grad_(True), *args)
    torch.cuda.synchronize()
    if not torch.isfinite(out.float()).all():
        raise RuntimeError("K2 under no_grad: non-finite output")
    print("training F22: K2 raised on a token tensor that requires grad under grad mode, "
          "and launched under no_grad")


def _to(tree, dev):
    if isinstance(tree, dict):
        return {k: _to(v, dev) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_to(v, dev) for v in tree]
    return None if tree is None else tree.to(dev)


# -- YOLO training on data ----------------------------------------------------

YOLO_DATA_FRAMES = 32   # numpy-made 720p frames in the labelled folder
YOLO_DATA_B = 16        # tools/train_yolo's default batch
YOLO_DATA_TURNS = 3     # SimOTA and neighbor steps timed in turns, each


def write_yolo_frames(root, n, seed):
    """n numpy-made 720p frames (BGR, a dim noise floor and 1-4 filled boxes
    of three colours, one a class) saved as .npy bytes under .png names (the
    cv2 stand-in reads them), and their YOLO label files in the sibling
    labels folder; the images folder's path."""
    rng = np.random.default_rng(seed)
    images, labels = os.path.join(root, "images"), os.path.join(root, "labels")
    os.makedirs(images)
    os.makedirs(labels)
    h, w = 720, 1280
    for i in range(n):
        img = (rng.integers(0, 64, (h, w, 3), dtype=np.uint8))
        rows = []
        for _ in range(int(rng.integers(1, 5))):
            bw, bh = int(rng.integers(60, 360)), int(rng.integers(60, 300))
            x0, y0 = int(rng.integers(0, w - bw)), int(rng.integers(0, h - bh))
            c = int(rng.integers(0, 3))
            img[y0:y0 + bh, x0:x0 + bw] = (70 + 80 * c, 220 - 70 * c, 130)
            rows.append(f"{c} {(x0 + bw / 2) / w:.6f} {(y0 + bh / 2) / h:.6f} {bw / w:.6f} "
                        f"{bh / h:.6f}")
        with open(os.path.join(images, f"frame{i:03d}.png"), "wb") as fh:
            np.save(fh, img)
        with open(os.path.join(labels, f"frame{i:03d}.txt"), "w") as fh:
            fh.write("\n".join(rows) + "\n")
    return images


def yolo_data_phase(dev, smi):
    """The phase "YOLO training on data": tools/train_yolo at full width (the
    built-in YOLOv7 at 640, nc 3, B = 16) on a labelled folder of 32
    numpy-made 720p frames, under the default recipe (mosaic, mixup 0.15,
    hyp.scratch.p5's HSV and perspective values; the numpy loader of
    io/datasets.py) with --assigner simota (top k 10): 4 steps with a
    checkpoint every 2, then --resume auto for a fifth; detector_map over
    the 32 frames with the resumed run's EMA (K1 once an image, shown
    under the kernels line's "launches_by_path"); --evolve 2 --steps 1
    (K1 once an image of each generation's eval). No train step may launch a kernel. It prints the
    loader's host ms a batch against the step's ms (CUDA events), the
    peak memory, SimOTA's step against the neighbor assigner's in turns on
    one loader batch, and the eval's images/s. Returns detector_map's K1
    launches."""
    import torch

    from hamer_yolo_tpu_torch.core.checkpoint import latest_checkpoint
    from hamer_yolo_tpu_torch.io.datasets import (YoloDataConfig, image_label_pairs,
                                                  yolo_batch_iterator)
    from hamer_yolo_tpu_torch.models.yolov7.model import YoloConfig
    from hamer_yolo_tpu_torch.tools import train_yolo as tool
    from hamer_yolo_tpu_torch.training import train_yolo as T
    from hamer_yolo_tpu_torch.training.evolve import META, N_RESULT_COLS
    from hamer_yolo_tpu_torch.utils.detect_eval import detector_map

    t0 = time.perf_counter()
    saved = sys.modules.get("cv2")
    sys.modules["cv2"] = cv2_stand_in()
    no_kernels = dict.fromkeys(KERNELS, 0)
    try:
        with tempfile.TemporaryDirectory() as root:
            images = write_yolo_frames(root, YOLO_DATA_FRAMES, SEED)
            out = os.path.join(root, "run")
            base = ["--data", images, "--batch", str(YOLO_DATA_B), "--assigner", "simota",
                    "--out", out, "--device", str(dev), "--log-every", "1", "--ckpt-every", "2"]
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats(dev)
            held = torch.cuda.memory_allocated(dev)
            t1 = time.perf_counter()
            (rc, times), n = run_counted(lambda: tool.run(base + ["--steps", "4"]))
            tool_s = time.perf_counter() - t1
            peak = torch.cuda.max_memory_allocated(dev) - held
            expect_launches("train_yolo --steps 4", n, no_kernels)
            files = sorted(f for f in os.listdir(out) if f.endswith(".npz"))
            if rc != 0 or files != ["ckpt_2.npz", "ckpt_final.npz"]:
                raise RuntimeError(f"train_yolo: exit {rc}, checkpoints {files}")
            t1 = time.perf_counter()
            (rc, more), n = run_counted(
                lambda: tool.run(base + ["--steps", "5", "--resume", "auto"]))
            resume_s = time.perf_counter() - t1
            expect_launches("train_yolo --resume auto", n, no_kernels)
            if rc != 0 or more["start"] != 4 or len(more["load_ms"]) != 1:
                raise RuntimeError(f"train_yolo --resume auto: exit {rc}, {more}")
            load_ms = times["load_ms"] + more["load_ms"]
            step_ms = times["step_ms"] + more["step_ms"]
            print(f"YOLO training on data: train_yolo at 640, B={YOLO_DATA_B}, simota, on "
                  f"{YOLO_DATA_FRAMES} 720p frames: 4 steps + checkpoints {files} in "
                  f"{tool_s:.1f} s, --resume auto from step 4 for a fifth in {resume_s:.1f} s; "
                  f"loader {', '.join(f'{t:.0f}' for t in load_ms)} ms a batch (host) against "
                  f"the step {', '.join(f'{t:.1f}' for t in step_ms)} ms (CUDA events; the "
                  f"first steps build cuDNN plans); peak memory {_gib(peak):.2f} GiB above what "
                  f"the phase held; no kernel launched; on {smi}", flush=True)

            cfg = YoloConfig()
            state = T.init_yolo_train_state(torch.Generator(dev).manual_seed(0), cfg, 5)
            T.load_train_state(latest_checkpoint(out), state)
            pairs = image_label_pairs(images)
            res, n = run_counted(lambda: detector_map(state.ema.params, cfg, pairs))
            expect_launches("detector_map", n, {**no_kernels, "K1": len(pairs)})
            eval_k1 = n["K1"]
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            again = detector_map(state.ema.params, cfg, pairs)
            torch.cuda.synchronize()
            eval_s = time.perf_counter() - t1
            if not all(np.isfinite(res)):
                raise RuntimeError(f"detector_map: {res}")
            print(f"YOLO training on data: detector_map of the EMA after 5 steps over "
                  f"{len(pairs)} frames (letterbox, YOLOv7 bf16, NMS on K1): P {res[0]:.4f} "
                  f"R {res[1]:.4f} mAP@.5 {res[2]:.4f} mAP@.5:.95 {res[3]:.4f} (random init, 5 "
                  f"steps; a second pass {again}); K1 launched {eval_k1} times; the second pass "
                  f"{eval_s:.2f} s = "
                  f"{len(pairs) / eval_s:.1f} images/s (host clock, letterbox included)",
                  flush=True)

            evo = os.path.join(root, "evolve")
            t1 = time.perf_counter()
            rc, n = run_counted(lambda: tool.main(
                ["--data", images, "--batch", str(YOLO_DATA_B), "--assigner", "simota",
                 "--out", evo, "--device", str(dev), "--steps", "1", "--evolve", "2"]))
            evolve_s = time.perf_counter() - t1
            expect_launches("train_yolo --evolve 2", n, {**no_kernels, "K1": 2 * len(pairs)})
            rows = np.loadtxt(os.path.join(evo, "evolve.txt"), ndmin=2)
            with open(os.path.join(evo, "hyp_evolved.yaml")) as fh:
                best = dict(line.split(": ") for line in fh.read().splitlines()
                            if line and not line.startswith("#"))
            if rc != 0 or rows.shape != (2, N_RESULT_COLS + len(META)) or list(best) != list(META):
                raise RuntimeError(f"train_yolo --evolve 2: exit {rc}, rows {rows.shape}")
            print(f"YOLO training on data: --evolve 2 --steps 1 in {evolve_s:.1f} s (K1 "
                  f"{n['K1']} launches); evolve.txt {rows.shape}, hyp_evolved.yaml "
                  f"{len(best)} hyps", flush=True)

            # SimOTA's step against the neighbor assigner's, in turns, on one batch
            batch = next(yolo_batch_iterator(images, YOLO_DATA_B, YoloDataConfig(), seed=1))
            batch = {k: torch.from_numpy(v).to(dev) for k, v in batch.items()}
            steps = {a: T.make_yolo_train_step(cfg, assigner=a) for a in ("simota", "neighbor")}
            state = T.init_yolo_train_state(torch.Generator(dev).manual_seed(0), cfg, 100)
            for step in steps.values():
                step(state, batch)
            turns = {a: [] for a in steps}
            order = ["simota", "neighbor", "neighbor", "simota"] * ((YOLO_DATA_TURNS + 1) // 2)
            for a in order[:2 * YOLO_DATA_TURNS]:
                start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(
                    enable_timing=True)
                start.record()
                metrics = steps[a](state, batch)
                end.record()
                torch.cuda.synchronize()
                _finite(metrics, f"{a} step")
                turns[a].append(start.elapsed_time(end))
            print(f"YOLO training on data: a train step at {cfg.img_size}, B={YOLO_DATA_B}, on a "
                  "loader batch, in turns "
                  + "; ".join(f"{a} p50 {float(np.median(v)):.2f} ms ({', '.join(f'{t:.2f}' for t in v)})"
                              for a, v in turns.items())
                  + f" (CUDA events, 1 warm-up each) on {smi}", flush=True)
            del state, batch
    finally:
        if saved is None:
            del sys.modules["cv2"]
        else:
            sys.modules["cv2"] = saved
    torch.cuda.empty_cache()
    print(f"phase YOLO training on data: {time.perf_counter() - t0:.1f} s")
    return eval_k1


# -- RGB-D training on data and the point-cloud zoo --------------------------

RGBD_DATA_FRAMES = 16   # numpy-made 1920x1080 RGB-D samples in the fixture layout
STB_FRAMES = 8          # numpy-made 640x480 samples in STB's layout
RGBD_DATA_STEPS = 4
ZOO_B = 8
# the zoo's cases at the published widths: (the forward, its keywords, the
# inputs' shapes (B = ZOO_B); a (B, J, 3) second input is joints at scale 0.4)
ZOO_CASES = {
    "cls_ssg": ("ref_cls_ssg_forward", {}, [(1024, 6)]),
    "part_seg": ("ref_part_seg_forward", {}, [(2048, 3), (21, 3)]),
    "sem_seg": ("ref_sem_seg_forward", {}, [(4096, 9)]),
    "dgcnn_semseg": ("ref_dgcnn_semseg_forward", {"k": 20}, [(4096, 9)]),
    "dgcnn_partseg": ("ref_dgcnn_partseg_forward", {"k": 40}, [(2048, 3)]),
    "pointnet": ("ref_pointnet_cls_forward", {}, [(1024, 3)]),
    "msg_large": ("ref_msg_large_forward", {}, [(1024, 3)]),
    "pointmlp": ("ref_pointmlp_forward", {"points": 1024}, [(1024, 3)]),
    "pointmlp_refine": ("ref_pointmlp_refine_forward", {"points": 1024}, [(1024, 3), (1024, 64)]),
}


def rgbd_sample(rng, cam, hw, center_xyz):
    """(BGR uint8 frame, u16 depth mm, (21, 3) joints mm): a depth blob at
    about 420-580 mm on a disk around the joints' projection."""
    H, W = hw
    joints = np.asarray(center_xyz, np.float32) + rng.uniform(-60, 60, (21, 3)).astype(np.float32)
    u = joints[:, 0] * cam[0] / joints[:, 2] + cam[2]
    v = joints[:, 1] * cam[1] / joints[:, 2] + cam[3]
    r = max(np.ptp(u), np.ptp(v)) / 2 + 8
    y0, y1 = int(max(v.mean() - r, 0)), int(min(v.mean() + r + 1, H))
    x0, x1 = int(max(u.mean() - r, 0)), int(min(u.mean() + r + 1, W))
    yy, xx = np.mgrid[y0:y1, x0:x1]
    blob = center_xyz[2] + 80.0 * np.sin(xx / 9.0) * np.cos(yy / 7.0)
    depth = np.zeros((H, W), np.uint16)
    depth[y0:y1, x0:x1] = np.where((xx - u.mean()) ** 2 + (yy - v.mean()) ** 2 < r ** 2, blob, 0)
    return rng.integers(0, 256, (H, W, 3), dtype=np.uint8), depth, joints


def write_rgbd_dirs(root, seed):
    """The fixture layout ({stem}.png, {stem}_d.png, {stem}.txt; the images as
    .npy data under png names, for the cv2 stand-in) and STB's layout
    (SK_color_i.png, SK_depth_i.png as R + 256 G, labels/{seq}_SK.mat by
    scipy.io.savemat). Returns their paths."""
    import scipy.io as sio

    from hamer_yolo_tpu_torch.io.rgbd_datasets import RGBDDatasetConfig, STB_CAM

    rng = np.random.default_rng(seed)
    fixture, stb = os.path.join(root, "fixture"), os.path.join(root, "stb")
    os.makedirs(fixture)
    cam = RGBDDatasetConfig().cam_para
    for i in range(RGBD_DATA_FRAMES):
        rgb, depth, joints = rgbd_sample(rng, cam, (1080, 1920),
                                         (rng.uniform(-150, 150), rng.uniform(-80, 80),
                                          rng.uniform(450, 600)))
        stem = os.path.join(fixture, f"f{i:03d}")
        for path, a in ((stem + ".png", rgb), (stem + "_d.png", depth)):
            with open(path, "wb") as fh:
                np.save(fh, a)
        np.savetxt(stem + ".txt", joints)
    seq = os.path.join(stb, "B1Counting")
    os.makedirs(seq)
    os.makedirs(os.path.join(stb, "labels"))
    hand_para = np.zeros((3, 21, STB_FRAMES))
    for i in range(STB_FRAMES):
        rgb, depth, joints = rgbd_sample(rng, STB_CAM, (480, 640),
                                         (rng.uniform(-40, 40), rng.uniform(-40, 40), 500.0))
        hand_para[:, :, i] = joints.T
        enc = np.zeros(depth.shape + (3,), np.uint8)
        enc[..., 2], enc[..., 1] = depth % 256, depth // 256
        for name, a in (("SK_color", rgb), ("SK_depth", enc)):
            with open(os.path.join(seq, f"{name}_{i}.png"), "wb") as fh:
                np.save(fh, a)
    sio.savemat(os.path.join(stb, "labels", "B1Counting_SK.mat"), {"handPara": hand_para})
    return fixture, stb


@contextlib.contextmanager
def chosen_indices(replay=None, inputs=()):
    """The index sets ops/pointnet chooses inside the block (furthest points,
    ball queries, the nearest-k sorts of kNN and three-nn), logged in order
    as (kind, indices on the host); DGCNN's kNN (models/pointnet2._knn_ref)
    on anything but a view of one of the forward's ``inputs`` (learned
    features, partseg's cloud after its learned transform) is the kind "knn
    features", every other nearest-k "knn". With ``replay`` (such a log of
    the same forward on another device) each call still makes its own
    choice, logs it, and returns the replayed one instead (a nearest-k's
    values gathered at it): a forward held on another device's choices."""
    import torch

    from hamer_yolo_tpu_torch.models import pointnet2 as P2
    from hamer_yolo_tpu_torch.ops import pointnet as pn

    log = []
    plain = {k: getattr(pn, k) for k in ("furthest_point_sampling", "ball_query", "smallest_k")}
    plain_knn_ref = P2._knn_ref
    knn_kind = ["knn"]

    def chosen(kind, idx):
        log.append((kind, idx.cpu()))
        if replay is None:
            return idx
        want_kind, want = replay[len(log) - 1]
        if want_kind != kind or want.shape != idx.shape:
            raise RuntimeError(f"replayed index sets: {want_kind} {tuple(want.shape)} where the "
                               f"forward chose {kind} {tuple(idx.shape)}")
        return want.to(idx.device)

    def fps(*a, **kw):
        return chosen("fps", plain["furthest_point_sampling"](*a, **kw))

    def ball(*a, **kw):
        return chosen("ball", plain["ball_query"](*a, **kw))

    def knn(d, k):
        idx = chosen(knn_kind[0], plain["smallest_k"](d, k)[1])
        return torch.gather(d, -1, idx), idx

    def knn_ref(x, k):
        own = {t.untyped_storage().data_ptr() for t in inputs}
        knn_kind[0] = "knn" if x.untyped_storage().data_ptr() in own else "knn features"
        try:
            return plain_knn_ref(x, k)
        finally:
            knn_kind[0] = "knn"

    pn.furthest_point_sampling, pn.ball_query, pn.smallest_k = fps, ball, knn
    P2._knn_ref = knn_ref
    try:
        yield log
    finally:
        for k, f in plain.items():
            setattr(pn, k, f)
        P2._knn_ref = plain_knn_ref


# the share of rows of each kind whose index set the CPU may choose otherwise
# than the card: furthest points, ball queries and kNN over xyz take f64
# fma-chain distances that are the same on both (F19); a kNN over learned
# features follows features that each device rounds its own way
INDEX_SET_LIMITS = {"fps": 0.0, "ball": 0.0, "knn": 0.0, "knn features": 1e-4}


def differing_sets(a, b):
    """{kind: (rows whose index set differs, rows)} of two chosen_indices
    logs of one forward; a furthest-point row is one chosen point."""
    import torch

    out = {}
    if [k for k, _ in a] != [k for k, _ in b]:
        raise RuntimeError("the card and the CPU chose index sets in another order")
    for (kind, x), (_, y) in zip(a, b):
        if kind == "fps":
            d, n = int((x != y).sum()), x.numel()
        else:
            x, y = torch.sort(x, dim=-1).values, torch.sort(y, dim=-1).values
            d, n = int((x != y).any(-1).sum()), x[..., 0].numel()
        got = out.get(kind, (0, 0))
        out[kind] = (got[0] + d, got[1] + n)
    return out


def rgbd_data_zoo_phase(dev, smi):
    """The phase "RGB-D training on data and the point-cloud zoo".

    Training on data: a fixture-layout directory of 16 numpy-made 1920x1080
    RGB-D samples and an STB-layout directory of 8 (.npy data under png
    names for the cv2 stand-in, STB's labels by scipy.io.savemat);
    tools/train_kpfusion_rgbd --data --augment at the default KPFusionConfig
    (21 joints, dim 128, 128 x 128 crops, 1,024 points), B = 4, 4 steps, and
    again with --data-format stb: the loader's host ms a batch against the
    step's ms (CUDA events), the peak memory and the tool's seconds; no
    kernel may launch. One disk batch (augmented) through the loss and its
    gradients on the card against the CPU, the same seeded weights with
    each BN's variance calibrated on that batch, at tests/
    test_torch_train_pairs.py's KPFusion limits (loss terms 1e-3, each
    gradient's relative norm error 1e-2).

    The zoo at the published widths (tests/test_torch_state_dicts.ZOO's
    state dicts, div 1, converted by core/convert on each device), B = 8:
    each of the nine forwards on the card against the CPU at its oracle
    tolerance (test_torch_state_dicts.ZOO_TOL, rtol 1e-4), the CPU held on
    the card's index sets
    (chosen_indices: a kNN over learned features is an argsort, which a
    rounding upstream can move, as the int8 ToMe check holds the CPU on
    the card's merges), the sets the CPU would have chosen otherwise
    counted and held to INDEX_SET_LIMITS (none for furthest points, ball
    queries and kNN over xyz, 1e-4 of the rows for kNN over learned
    features); the card's ms (CUDA events). Geometry: warp_affine,
    crop_resize_normalize, letterbox_image and the Euler round trips, card
    against CPU. TF32 stays off."""
    import torch

    from hamer_yolo_tpu_torch.geometry import affine as GA
    from hamer_yolo_tpu_torch.geometry import rotations as GR
    from hamer_yolo_tpu_torch.io.rgbd_datasets import RGBDDatasetConfig, RGBDDiskDataset
    from hamer_yolo_tpu_torch.models import pointnet2 as P2
    from hamer_yolo_tpu_torch.models.kpfusion_rgbd.model import KPFusionConfig
    from hamer_yolo_tpu_torch.tools import train_kpfusion_rgbd as tool
    from hamer_yolo_tpu_torch.training import train_kpfusion_rgbd as TK

    sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), "tests"))
    import test_torch_train_pairs as PAIRS
    from test_torch_state_dicts import ZOO, ZOO_TOL, calibrating_batch_norm

    t0 = time.perf_counter()
    no_kernels = dict.fromkeys(KERNELS, 0)
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    # the CPU halves of the checks on every core (test_torch_state_dicts, once
    # imported, leaves torch one thread)
    threads = torch.get_num_threads()
    torch.set_num_threads(os.cpu_count() or 1)
    saved = sys.modules.get("cv2")
    sys.modules["cv2"] = cv2_stand_in()
    try:
        with tempfile.TemporaryDirectory() as root:
            fixture, stb = write_rgbd_dirs(root, SEED + 16)
            for fmt, data in (("fixture", fixture), ("stb", stb)):
                out = os.path.join(root, f"run_{fmt}")
                torch.cuda.synchronize()
                torch.cuda.reset_peak_memory_stats(dev)
                held = torch.cuda.memory_allocated(dev)
                t1 = time.perf_counter()
                (rc, times), n = run_counted(lambda: tool.run(
                    ["--data", data, "--data-format", fmt, "--augment", "--device", str(dev),
                     "--batch", str(KPF_TRAIN_B), "--steps", str(RGBD_DATA_STEPS),
                     "--log-every", "1", "--out", out]))
                tool_s = time.perf_counter() - t1
                peak = torch.cuda.max_memory_allocated(dev) - held
                expect_launches(f"train_kpfusion_rgbd --data-format {fmt}", n, no_kernels)
                with open(os.path.join(out, "metrics.jsonl")) as fh:
                    recs = [json.loads(line) for line in fh]
                if rc or [r["step"] for r in recs] != list(range(RGBD_DATA_STEPS)) or \
                        not os.path.exists(os.path.join(out, "ckpt_final.npz")):
                    raise RuntimeError(f"train_kpfusion_rgbd --data-format {fmt}: rc {rc}, "
                                       f"steps {[r['step'] for r in recs]}")
                for r in recs:
                    _finite(r, f"train_kpfusion_rgbd --data-format {fmt}")
                what = (f"{RGBD_DATA_FRAMES} 1920x1080" if fmt == "fixture"
                        else f"{STB_FRAMES} 640x480")
                losses = ", ".join(f"{r['loss']:.4f}" for r in recs)
                print(f"RGB-D training on data ({fmt}, {what} samples, --augment): "
                      f"train_kpfusion_rgbd at the default config, "
                      f"B={KPF_TRAIN_B}, {RGBD_DATA_STEPS} steps in {tool_s:.1f} s; loader "
                      f"{', '.join(f'{t:.0f}' for t in times['load_ms'])} ms a batch (host) "
                      f"against the step {', '.join(f'{t:.1f}' for t in times['step_ms'])} ms "
                      f"(CUDA events); peak memory {_gib(peak):.2f} GiB above what the phase "
                      f"held; losses {losses}; no kernel launched; on {smi}", flush=True)

            # one disk batch: the loss and its gradients, card against CPU
            cfg = KPFusionConfig()
            ds = RGBDDiskDataset(fixture, RGBDDatasetConfig(),
                                 pcl_rng=np.random.RandomState(SEED))
            np_batch = next(ds.batches(KPF_TRAIN_B, seed=1, augment=True))
            batch = {k: torch.from_numpy(v) for k, v in np_batch.items()}
            cpu = TK.init_train_state(torch.Generator().manual_seed(6), cfg)
            with torch.no_grad(), calibrating_batch_norm():
                TK.kpfusion_rgbd_loss(cpu.params, batch, cfg)
            card = TK.make_train_state(_to(cpu.params, dev))
            dev_batch = {k: v.to(dev) for k, v in batch.items()}
            t1 = time.perf_counter()

            def card_grads():
                loss, terms = TK.kpfusion_rgbd_loss(card.params, dev_batch, cfg)
                return terms, PAIRS.gradients(loss, card)

            (terms_card, g_card), n = run_counted(card_grads)
            expect_launches("KPFusion loss and gradients on a disk batch", n, no_kernels)
            loss_cpu, terms_cpu = TK.kpfusion_rgbd_loss(cpu.params, batch, cfg)
            g_cpu = PAIRS.gradients(loss_cpu, cpu)
            hold_s = time.perf_counter() - t1
            for k, v in terms_cpu.items():
                a, b = float(terms_card[k].detach()), float(v.detach())
                if abs(a - b) > PAIRS.LOSS_REL["kpfusion"] * max(abs(b), 1e-6):
                    raise RuntimeError(f"KPFusion on a disk batch, card against CPU: {k} {a} "
                                       f"against {b}")
            skip = PAIRS.SOFTMAX_CANCELLED["kpfusion"]
            worst = max((PAIRS.rel(g_card[k], c), k) for k, c in g_cpu.items()
                        if not k.endswith(skip))
            if worst[0] > PAIRS.GRAD_REL["kpfusion"]:
                raise RuntimeError(f"KPFusion on a disk batch, card against CPU: gradient of "
                                   f"{worst[1]} off by {worst[0]}")
            print(f"RGB-D training on data: one augmented disk batch (B={KPF_TRAIN_B}) through "
                  f"the default config's loss and gradients, card against CPU: loss "
                  f"{float(terms_card['loss'].detach()):.6f} against "
                  f"{float(terms_cpu['loss'].detach()):.6f} "
                  f"(limit {PAIRS.LOSS_REL['kpfusion']} relative, every term); worst gradient "
                  f"{worst[0]:.2e} ({worst[1]}; limit {PAIRS.GRAD_REL['kpfusion']}) over "
                  f"{len(g_cpu)} leaves; {hold_s:.1f} s", flush=True)
            del card, cpu, dev_batch, g_card, g_cpu
            torch.cuda.empty_cache()
    finally:
        if saved is None:
            sys.modules.pop("cv2", None)
        else:
            sys.modules["cv2"] = saved
    t_data = time.perf_counter() - t0

    # the zoo at the published widths, card against CPU
    t1 = time.perf_counter()
    rng = np.random.default_rng(SEED + 17)
    parts = []
    for i, (name, (fwd, kw, shapes)) in enumerate(ZOO_CASES.items()):
        build, convert = ZOO[name]
        sd = build(np.random.default_rng(SEED + 100 + i))
        n_params = sum(v.size for k, v in sd.items() if not k.endswith("num_batches_tracked"))
        inputs = [(rng.normal(scale=0.4 if s == (21, 3) else 0.5, size=(ZOO_B,) + s)
                   .astype(np.float32)) for s in shapes]
        fn = getattr(P2, fwd)
        p_dev, p_cpu = convert(sd, device=dev), convert(sd)
        x_dev = [torch.from_numpy(a).to(dev) for a in inputs]
        x_cpu = [torch.from_numpy(a) for a in inputs]
        with torch.inference_mode():
            with chosen_indices(inputs=x_dev) as log_dev:
                got, n = run_counted(lambda: fn(p_dev, *x_dev, **kw))
            expect_launches(f"zoo {name}", n, no_kernels)
            t2 = time.perf_counter()
            with chosen_indices(replay=log_dev, inputs=x_cpu) as log_cpu:
                ref = fn(p_cpu, *x_cpu, **kw)
            cpu_s = time.perf_counter() - t2
            ms = cuda_time_ms(lambda: fn(p_dev, *x_dev, **kw), iters=3, warmup=1)
        got = got.cpu()
        if not torch.isfinite(got).all() or got.shape != ref.shape:
            raise RuntimeError(f"zoo {name}: {tuple(got.shape)} not finite or not "
                               f"{tuple(ref.shape)}")
        err = float((got - ref).abs().max())
        diff = differing_sets(log_dev, log_cpu)
        part = (f"{name} {tuple(ref.shape)} ({n_params:,} parameters): {ms:.2f} ms, max abs diff "
                f"{err:.2e} at |ref| <= {float(ref.abs().max()):.3g}; index sets the CPU would "
                f"have chosen otherwise " + ", ".join(f"{k} {d} of {m}" for k, (d, m) in
                                                      diff.items()) + f"; CPU {cpu_s:.1f} s")
        print(f"zoo {part}", flush=True)
        for kind, (d, m) in diff.items():
            if d > INDEX_SET_LIMITS[kind] * m:
                raise RuntimeError(f"zoo {name}: the CPU would have chosen {d} of {m} {kind} "
                                   f"index sets otherwise (limit {INDEX_SET_LIMITS[kind]} "
                                   f"of the rows)")
        torch.testing.assert_close(got, ref, atol=ZOO_TOL[name], rtol=1e-4)
        parts.append(part)
        del p_dev, x_dev, got
    torch.cuda.empty_cache()
    print(f"point-cloud zoo at the published widths, B={ZOO_B}, card against CPU on the "
          f"card's index sets (atol ZOO_TOL, rtol 1e-4; ms by CUDA events, 1 warm-up, 3 timed, "
          f"on {smi}): "
          + "; ".join(parts), flush=True)
    t_zoo = time.perf_counter() - t1

    # geometry, card against CPU
    g = torch.Generator().manual_seed(SEED + 18)
    img = torch.randint(0, 256, (720, 1280, 3), generator=g).float()
    trans = GA.gen_trans_from_patch(torch.tensor(640.0), torch.tensor(360.0), torch.tensor(300.0),
                                    torch.tensor(300.0), 256.0, 256.0)
    mean, std = torch.tensor([0.485, 0.456, 0.406]), torch.tensor([0.229, 0.224, 0.225])
    _, new_unpad, _, pads = GA.letterbox_params((720, 1280), 640)
    euler = (torch.rand(64, 3, generator=g) * 2.4 - 1.2)
    cases = {
        "warp_affine": lambda d: GA.warp_affine(img.to(d), trans.to(d), (256, 256)),
        "crop_resize_normalize": lambda d: GA.crop_resize_normalize(
            img.to(d), torch.tensor([640.0, 360.0], device=d), torch.tensor(300.0, device=d),
            (256, 192), mean.to(d), std.to(d), torch.tensor(1.0, device=d)),
        "letterbox_image": lambda d: GA.letterbox_image(img.to(d), new_unpad, pads, 640),
        "euler xyz round trip": lambda d: GR.rotmat_to_ee(GR.ee_to_rotmat(euler.to(d), "xyz"),
                                                          "xyz"),
        "euler zyx via axis-angle": lambda d: GR.aa_to_ee(GR.ee_to_aa(euler.to(d), "zyx"),
                                                          "zyx"),
    }
    tol = {"warp_affine": 1e-3, "crop_resize_normalize": 1e-4, "letterbox_image": 1e-3,
           "euler xyz round trip": 1e-5, "euler zyx via axis-angle": 1e-5}
    errs = []
    for name, f in cases.items():
        got, n = run_counted(lambda: f(dev))
        expect_launches(f"geometry {name}", n, no_kernels)
        ref = f(torch.device("cpu"))
        err = float((got.cpu() - ref).abs().max())
        if not err <= tol[name]:
            raise RuntimeError(f"geometry {name}: card against CPU {err} > {tol[name]}")
        errs.append(f"{name} {tuple(ref.shape)} {err:.2e} (limit {tol[name]})")
    print("geometry, card against CPU, max abs diff: " + "; ".join(errs))
    torch.backends.cuda.matmul.allow_tf32 = tf32
    torch.set_num_threads(threads)
    print(f"phase RGB-D training on data and the point-cloud zoo: {time.perf_counter() - t0:.1f} s "
          f"(training on data {t_data:.1f} s, zoo {t_zoo:.1f} s)", flush=True)


# ---------------------------------------------------------------------------
# The phase "library, mesh and tools": train form to deploy form, load_pipeline,
# eval_fastpaths, a 1-rank NCCL mesh, parity_check, compiled_flops and StageTimer
# ---------------------------------------------------------------------------
# The folded detector's largest f32 error from the f64 training form, at most
# this times the f32 training form's own: folding moves rounding, not math.
FOLD_F64_FACTOR = 4.0
# NMS keep sets of the two forms, matched by box (ROADMAP F3): a kept box
# matches one of the other form within this many pixels (each coordinate), and
# at most this share of the kept boxes may go unmatched (near-tied scores).
FOLD_BOX_PX = 0.05
FOLD_UNMATCHED_SHARE = 0.02
FASTPATH_ITERS = 5      # utils/profiling.benchmark iterations an eval_fastpaths arm
MESH_YOLO_B = 4         # the 1-rank mesh's YOLOv7 step at 640


def fold_yolo_tree(tree):
    """The deploy form of a training-form YOLOv7 tree, block by block:
    every conv + BN through core/nn.fold_bn_into_conv, every RepConv through
    models/yolov7/blocks.repconv_fuse (the JAX package has no tree-level
    function either)."""
    from hamer_yolo_tpu_torch.core import nn
    from hamer_yolo_tpu_torch.models.yolov7.blocks import repconv_fuse

    if isinstance(tree, dict):
        if "dense" in tree:
            return repconv_fuse(tree)
        if "conv" in tree and "bn" in tree:
            rest = {k: fold_yolo_tree(v) for k, v in tree.items() if k not in ("conv", "bn")}
            return {**rest, "conv": nn.fold_bn_into_conv(tree["conv"], tree["bn"])}
        return {k: fold_yolo_tree(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(fold_yolo_tree(v) for v in tree)
    return tree


def seed_bn_stats(tree, gen):
    """Every BN of a tree redrawn in place from ``gen``: scale U(0.5, 1.5),
    bias N(0, 0.1), running mean N(0, 0.1), running var U(0.5, 2) (the
    init's 1, 0, 0, 1 would make the folds trivial)."""
    import torch

    if isinstance(tree, dict):
        if set(tree) == {"scale", "bias", "mean", "var"}:
            for k, (a, b, normal) in {"scale": (0.5, 1.5, False), "bias": (0.0, 0.1, True),
                                      "mean": (0.0, 0.1, True), "var": (0.5, 2.0, False)}.items():
                t = tree[k]
                with torch.no_grad():
                    t.normal_(a, b, generator=gen) if normal else t.uniform_(a, b, generator=gen)
            return
        for v in tree.values():
            seed_bn_stats(v, gen)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            seed_bn_stats(v, gen)


def _keep_set_counts(a, b):
    """(kept boxes, unmatched) of two NmsOutputs matched by box, image by
    image: a kept box is unmatched where no box the other side keeps in its
    image lies within FOLD_BOX_PX."""
    kept = unmatched = 0
    for i in range(a.valid.shape[0]):
        ba = a.boxes[i][a.valid[i]].double()
        bb = b.boxes[i][b.valid[i]].double()
        kept += len(ba) + len(bb)
        for x, y in ((ba, bb), (bb, ba)):
            if len(x) and not len(y):
                unmatched += len(x)
            elif len(x):
                d = (x[:, None, :] - y[None, :, :]).abs().amax(-1).amin(1)
                unmatched += int((d > FOLD_BOX_PX).sum())
    return kept, unmatched


def _keep_sets_match(a, b, what):
    """_keep_set_counts, raising where more than FOLD_UNMATCHED_SHARE of the
    kept boxes are unmatched."""
    kept, unmatched = _keep_set_counts(a, b)
    if unmatched > FOLD_UNMATCHED_SHARE * kept:
        raise RuntimeError(f"{what}: {unmatched} of {kept} kept boxes unmatched "
                           f"(limit {FOLD_UNMATCHED_SHARE:.0%} within {FOLD_BOX_PX} px)")
    return kept, unmatched


def fold_phase(dev, frames, smi):
    """Train form -> deploy form at full width: YOLOv7 (deploy=False) with
    seeded BN stats, folded, both trees through the detector and K1 on four
    720p frames."""
    import torch

    from hamer_yolo_tpu_torch.models.yolov7.model import YoloConfig, init_yolov7, yolov7_forward
    from hamer_yolo_tpu_torch.ops.nms import non_max_suppression
    from hamer_yolo_tpu_torch.pipeline.frame import PipelineConfig, detect_hands_batched
    from hamer_yolo_tpu_torch.pipeline.preprocess import device_letterbox

    gen = torch.Generator(dev).manual_seed(SEED)
    train = init_yolov7(gen, YoloConfig(), deploy=False)
    seed_bn_stats(train, gen)
    t0 = time.perf_counter()
    with torch.inference_mode():
        deploy = fold_yolo_tree(train)
    torch.cuda.synchronize()
    t_fold = time.perf_counter() - t0
    n_rep = sum(1 for _ in _tree_leaves(deploy, "reparam"))
    imgs = torch.from_numpy(np.stack(frames[:BATCH])).to(dev).to(torch.float32)
    hws = torch.tensor([[720.0, 1280.0]] * BATCH, device=dev)
    with torch.inference_mode():
        lb, _, _ = device_letterbox(imgs, hws, 640)
        x = lb.flip(-1) / 255.0
        ref = yolov7_forward(train, x.double(), YoloConfig(compute_dtype="float64"))
        cfg32 = YoloConfig(compute_dtype="float32")
        t32, d32 = yolov7_forward(train, x, cfg32), yolov7_forward(deploy, x, cfg32)
    e_train = float((t32.double() - ref).abs().max())
    e_fold = float((d32.double() - ref).abs().max())
    if not (torch.isfinite(d32).all() and e_fold <= FOLD_F64_FACTOR * e_train):
        raise RuntimeError(f"folded YOLOv7: max |f32 deploy - f64 train| {e_fold:.3g} against "
                           f"{e_train:.3g} for the f32 train form (limit x{FOLD_F64_FACTOR})")
    with torch.inference_mode():
        (nt, nd), n = run_counted(lambda: (
            non_max_suppression(t32, 0.001, 0.65, max_det=300),
            non_max_suppression(d32, 0.001, 0.65, max_det=300)))
    expect_launches("the two forms' NMS", n, {"K1": 2})
    kept, unmatched = _keep_sets_match(nt, nd, "folded YOLOv7 NMS (f32)")
    pcfg = PipelineConfig()
    with torch.inference_mode():
        (bt, bd), n2 = run_counted(lambda: (detect_hands_batched(train, imgs, hws, pcfg),
                                            detect_hands_batched(deploy, imgs, hws, pcfg)))
    expect_launches("the two forms through detect_hands_batched (bf16)", n2, {"K1": 2})
    same = int((bt["valid"] == bd["valid"]).all(-1).sum())
    print(f"fold: a training-form YOLOv7 at 640 with seeded BN stats folded block by block in "
          f"{t_fold:.2f} s ({n_rep} RepConvs -> reparam); decoded outputs (B={BATCH}, 720p "
          f"letterboxed) in f32 against the f64 training form: deploy max |d| {e_fold:.3g}, "
          f"training form {e_train:.3g} (limit x{FOLD_F64_FACTOR}); NMS keep sets (conf 0.001, "
          f"iou 0.65, 300 a frame, K1): {kept} kept, {unmatched} unmatched within "
          f"{FOLD_BOX_PX} px; bf16 detect_hands_batched: the same valid slots in {same} of "
          f"{BATCH} frames, {int(bd['valid'].sum())} valid; K1 {n['K1'] + n2['K1']} launches "
          f"on {smi}")
    return n["K1"] + n2["K1"]


def load_pipeline_phase(dev, frames, K, depth):
    import torch

    import hamer_yolo_tpu_torch

    t0 = time.perf_counter()
    program, params, mano, cfg = hamer_yolo_tpu_torch.load_pipeline(device="cuda")
    torch.cuda.synchronize()
    t_load = time.perf_counter() - t0
    got, n = run_counted(lambda: program(frames[0], K))
    expect_launches("load_pipeline's program, first call (warm-up and capture)", n,
                    {"K1": CAPTURE_RUNS, "K2": CAPTURE_RUNS * depth,
                     **dict.fromkeys(INT8_KERNELS + ("K9",), 0)})
    eager = eager_frame(params, mano, cfg, dev, frames[0], K)
    hold_to_eager(got, eager, eager_frame(params, mano, cfg, dev, frames[0], K),
                  "load_pipeline's FrameProgram")
    print(f"load_pipeline(device=\"cuda\"): {t_load:.1f} s (no checkpoint: the seeded init), "
          f"one 720p frame through its captured program: {int(got['valid'].sum())} valid "
          f"slots; launches {n}")
    del program, params
    return {"K1": n["K1"] // CAPTURE_RUNS, "K2": n["K2"] // CAPTURE_RUNS}


def eval_fastpaths_phase(dev, smi, depth):
    """tools/eval_fastpaths at full width (ViT-H, 8 crops of 256): every
    arm finite and on its kernels; the deltas and each arm's p50."""
    import torch

    from hamer_yolo_tpu_torch.cli.main import load_mano
    from hamer_yolo_tpu_torch.models.hamer import HamerConfig, init_hamer
    from hamer_yolo_tpu_torch.ops.int8_matmul import gelu_prologue
    from hamer_yolo_tpu_torch.tools import eval_fastpaths as E
    from hamer_yolo_tpu_torch.utils.profiling import benchmark

    cfg = HamerConfig()
    mano = load_mano(None, dev)
    params = init_hamer(torch.Generator(dev).manual_seed(SEED), cfg)
    crops, calib = E.inputs(dev)
    trees = E.arm_weights(params, cfg, calib)
    base, n = run_counted(lambda: E.run_arm(None, trees, mano, cfg, crops))
    expect_launches("eval_fastpaths baseline (plain bf16)", n, {k: 0 for k in n})
    per_forward = {"K2": depth, "K3": depth, "K4": depth, "K5": 4 * depth, "K6": depth,
                   "K7": depth, "K10": depth}
    results, p50, launches = {}, {}, {}
    for arm, (label, _, _, _, kernels) in E.ARMS.items():
        out, n = run_counted(lambda: E.run_arm(arm, trees, mano, cfg, crops))
        if not all(np.isfinite(v).all() for v in out.values()):
            raise RuntimeError(f"eval_fastpaths {arm}: outputs not finite")
        expect_launches(f"eval_fastpaths {arm}", n,
                        {k: per_forward[k] if k in kernels else 0 for k in n})
        launches[arm] = {k: n[k] for k in kernels}
        results[arm] = E.delta(base, out)
        fn, env = E.arm_forward(arm, trees, mano, cfg)
        with E.switches(env):
            p50[arm] = round(benchmark(fn, crops, iters=FASTPATH_ITERS)["p50_ms"], 3)
        print(f"eval_fastpaths {label:<14s} {results[arm]}, p50 {p50[arm]} ms, launches "
              f"{launches[arm]}")
    print(f"eval_fastpaths (ViT-H, 8 crops of 256, seed 0; the int8 MLP's GELU "
          f"{gelu_prologue(dev)}; p50 by utils/profiling.benchmark, {FASTPATH_ITERS} calls, host "
          f"clock, on {smi}):")
    print(json.dumps({"eval_fastpaths": results, "p50_ms": p50}))
    del params, trees
    return launches


def _state_leaves(tree):
    return [t.detach() for t in _tree_leaves(tree)]


# Where two plain steps differ (KPFusion's backward accumulates with atomics on
# the card), the mesh step is held to this times their largest difference over
# all parameters: a maximum over millions of run-to-run differences, which
# moves little from one pair of runs to the next.
NONDETERMINISTIC_SPREAD_FACTOR = 4.0


def _hold_bitwise(what, got, plain, again):
    """``got`` equal to ``plain`` bit for bit where two plain steps are; where
    they are not, within NONDETERMINISTIC_SPREAD_FACTOR x their largest
    difference. Returns (largest difference from plain, the plain spread)."""
    def maxdiff(a, b):
        return max((float((x.double() - y.double()).abs().max()) for x, y in
                    zip(a, b, strict=True) if x.numel()), default=0.0)

    d, spread = maxdiff(got, plain), maxdiff(again, plain)
    if d > NONDETERMINISTIC_SPREAD_FACTOR * spread:
        raise RuntimeError(f"{what}: departs from the plain step by {d:.3g} (two plain steps "
                           f"differ by {spread:.3g})")
    return d, spread


def mesh_phase(dev, params, mano, cfg, frames, K, depth):
    """A 1-rank NCCL mesh (localhost rendezvous): one step of each train step
    through the data-parallel path against the plain step from the same
    seed, and BatchedPipeline(mesh=) against the pipeline without one."""
    import torch

    from hamer_yolo_tpu_torch.models.hamer import HamerConfig
    from hamer_yolo_tpu_torch.models.kpfusion_rgbd.model import KPFusionConfig
    from hamer_yolo_tpu_torch.models.yolov7.model import YoloConfig
    from hamer_yolo_tpu_torch.parallel import mesh as M
    from hamer_yolo_tpu_torch.pipeline.serving import BatchedPipeline
    from hamer_yolo_tpu_torch.training import train_hamer as TH
    from hamer_yolo_tpu_torch.training import train_kpfusion_rgbd as TK
    from hamer_yolo_tpu_torch.training import train_yolo as TY

    M.init_distributed("cuda")
    import torch.distributed as dist

    if dist.get_backend() != "nccl":
        raise RuntimeError(f"the mesh's backend is {dist.get_backend()}, not NCCL")
    mesh = M.make_mesh(1, 1, devices="cuda")
    report = []
    try:
        hcfg = HamerConfig()
        batch = TH.synthetic_batch(torch.Generator(dev).manual_seed(1), HAMER_TRAIN_B, hcfg)
        states = [TH.init_train_state(torch.Generator(dev).manual_seed(0), hcfg)
                  for _ in range(3)]
        metrics = [TH.train_step(s, batch, mano, hcfg, mesh=m)
                   for s, m in zip(states, (mesh, None, None))]
        d, spread = _hold_bitwise("HaMeR step on the mesh",
                                  *[_state_leaves((s.params, s.disc_params)) for s in states])
        report.append(f"HaMeR (ViT-H, B={HAMER_TRAIN_B}) total "
                      f"{float(metrics[0]['total']):.6f} / {float(metrics[1]['total']):.6f}, "
                      f"max |d| {d:.3g} (two plain steps {spread:.3g})")
        del states
        ycfg = YoloConfig()
        ybatch = TY.synthetic_yolo_batch(torch.Generator(dev).manual_seed(1), MESH_YOLO_B,
                                         ycfg.img_size)
        ys = [TY.init_yolo_train_state(torch.Generator(dev).manual_seed(0), ycfg)
              for _ in range(3)]
        ym = [TY.make_yolo_train_step(ycfg, mesh=m)(s, ybatch)
              for s, m in zip(ys, (mesh, None, None))]
        d, spread = _hold_bitwise("YOLOv7 step on the mesh (BN stats and EMA included)",
                                  *[_state_leaves((s.params, s.ema.params)) for s in ys])
        report.append(f"YOLOv7 (640, B={MESH_YOLO_B}) loss {float(ym[0]['loss']):.6f} / "
                      f"{float(ym[1]['loss']):.6f}, max |d| {d:.3g} (plain {spread:.3g})")
        del ys
        kcfg = KPFusionConfig()
        kb = {k: torch.from_numpy(v).to(dev) for k, v in
              TK.synthetic_rgbd_batch(np.random.default_rng(1), KPF_TRAIN_B, kcfg).items()}
        ks = [TK.init_train_state(torch.Generator(dev).manual_seed(0), kcfg) for _ in range(3)]
        km = [TK.train_step(s, kb, kcfg, mesh=m) for s, m in zip(ks, (mesh, None, None))]
        d, spread = _hold_bitwise("KPFusion step on the mesh",
                                  *[_state_leaves(s.params) for s in ks])
        report.append(f"KPFusion (B={KPF_TRAIN_B}) loss {float(km[0]['loss']):.6f} / "
                      f"{float(km[1]['loss']):.6f}, max |d| {d:.3g} (plain {spread:.3g})")
        del ks
        torch.cuda.empty_cache()
        with torch.inference_mode():
            plain = BatchedPipeline(params, mano, cfg, batch_size=BATCH, device=dev)
            ref = plain.process_batch(frames[:BATCH], K)
            meshed = BatchedPipeline(params, mano, cfg, batch_size=BATCH, device=dev, mesh=mesh)
            got, n = run_counted(lambda: meshed.process_batch(frames[:BATCH], K))
            again = meshed.process_batch(frames[:BATCH], K)
        expect_launches("BatchedPipeline(mesh=) first batch (warm-up and capture)", n,
                        {"K1": CAPTURE_RUNS, "K2": CAPTURE_RUNS * depth})
        bad = [k for k in ref if not (np.array_equal(got[k], ref[k])
                                      and np.array_equal(again[k], ref[k]))]
        if bad or len(meshed.programs["detect"].pool_bytes) != 1:
            raise RuntimeError(f"BatchedPipeline(mesh=): outputs {bad} differ from the pipeline "
                               f"without a mesh, or it did not capture one graph")
        report.append(f"BatchedPipeline(mesh=) batch {BATCH}: captured, replayed, every output "
                      "equal to the pipeline without a mesh")
    finally:
        M.leave_distributed()
    print("1-rank NCCL mesh (make_mesh(1, 1), localhost rendezvous): each train step through "
          "the data-parallel path (local rows, BN moments and gradients all-reduced over the "
          "data axis) bit-equal to the plain step where two plain steps are (else within "
          f"{NONDETERMINISTIC_SPREAD_FACTOR}x their spread): " + "; ".join(report))


def parity_phase():
    from hamer_yolo_tpu_torch.tools import parity_check

    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "tiny.npz")
        rc = parity_check.main(["capture", path, "--tiny", "--device", "cpu", "--batch", "2"])
        rc2 = parity_check.main(["compare", path, "--tiny", "--device", "cuda"])
    if rc or rc2:
        raise RuntimeError(f"parity_check: capture rc {rc}, compare on the card rc {rc2}")
    print("parity_check: capture --tiny --device cpu, compare --device cuda: every output "
          "within atol / rtol 1e-3")


def flops_phase(dev, smi):
    """utils/profiling's compiled_flops and StageTimer on the full-width
    HaMeR forward (8 crops of 256): flops and bytes of the plain bf16 path
    (the kernels' twins: a kernel's own library is not seen), then the
    stages' times on the card's path (K2)."""
    import torch

    from hamer_yolo_tpu_torch.cli.main import load_mano
    from hamer_yolo_tpu_torch.models.hamer import HamerConfig, hamer_forward, init_hamer
    from hamer_yolo_tpu_torch.models.mano import mano_forward_rotmat
    from hamer_yolo_tpu_torch.models.mano_head import mano_head_forward
    from hamer_yolo_tpu_torch.models.vit import vit_forward
    from hamer_yolo_tpu_torch.tools.eval_fastpaths import base_config, inputs
    from hamer_yolo_tpu_torch.utils.profiling import StageTimer, compiled_flops

    cfg = HamerConfig()
    mano = load_mano(None, dev)
    params = init_hamer(torch.Generator(dev).manual_seed(SEED), cfg)
    crops, _ = inputs(dev)
    t0 = time.perf_counter()
    cost = compiled_flops(lambda x: hamer_forward(params, mano, x, base_config(cfg)), crops)
    t_count = time.perf_counter() - t0
    m = cfg.crop_margin
    timer = StageTimer()
    with torch.inference_mode():
        for _ in range(2):  # the first pass builds the weight caches
            timer = StageTimer()
            timer.start("ViT-H (K2)")
            ctx = vit_forward(params["backbone"], crops[:, :, m:-m, :], cfg.vit)
            timer.stop(ctx)
            timer.start("MANO head")
            pm, _ = mano_head_forward(params["mano_head"], ctx, cfg.head)
            timer.stop(pm["betas"])
            timer.start("MANO")
            out = mano_forward_rotmat(mano, pm["global_orient"], pm["hand_pose"], pm["betas"])
            timer.stop(out.vertices)
    print(f"compiled_flops of the full-width HaMeR forward (plain bf16, 8 crops of 256): "
          f"{cost['flops']:.6g} flops, {cost['bytes_accessed']:.6g} bytes (counted in "
          f"{t_count:.1f} s); StageTimer on the card's path, on {smi}:\n{timer.report()}")
    return cost


def library_phase(dev, smi, params, mano, cfg, frames, K, depth):
    """The phase "library, mesh and tools" (train-to-deploy fusion,
    load_pipeline, eval_fastpaths, the 1-rank NCCL mesh, parity_check,
    compiled_flops and StageTimer); returns the kernels' launches on its
    paths. Alone: ``chip_smoke.library_phase(...)`` after main's set-up."""
    import torch

    t0 = time.perf_counter()
    fold_k1 = fold_phase(dev, frames, smi)
    lp = load_pipeline_phase(dev, frames, K, depth)
    arms = eval_fastpaths_phase(dev, smi, depth)
    torch.cuda.empty_cache()
    mesh_phase(dev, params, mano, cfg, frames, K, depth)
    torch.cuda.empty_cache()
    parity_phase()
    flops_phase(dev, smi)
    torch.cuda.empty_cache()
    by_path = {"K1": {"load_pipeline (a forward)": lp["K1"], "folded detector": fold_k1},
               "K2": {"load_pipeline (a forward)": lp["K2"]}}
    for arm, counts in arms.items():
        for k, v in counts.items():
            by_path.setdefault(k, {})[f"eval_fastpaths {arm}"] = v
    print(f"phase library, mesh and tools: {time.perf_counter() - t0:.1f} s", flush=True)
    return by_path


# -- deploy: AOTInductor packages, the operators, the C++ runner ---------------

DEPLOY_ROUNDS = 10      # interleaved_p50 rounds: 20 timed runs of each program
DEPLOY_FRAMES = 3       # frames through the runner's --serve loop
RUNNER_TIMEOUT_S = 300
# A package against eager on the card: check_reference's card-against-CPU
# limits (the JAX package's composed-oracle tolerances), axis-angle fields
# compared as rotations.
DEPLOY_TOL = 2e-3
DEPLOY_AA_TOL = 5e-3


# The field hold's control, a run it must report as wrong: eager with every
# weight of the ViT's blocks rounded to fp8 e4m3's 4 significant bits (the
# exponent kept), as a package stored at too low a precision would run.
CONTROL_BITS = 4


def coarse_blocks(params, bits=CONTROL_BITS):
    """``params`` with every floating leaf of the ViT's blocks rounded to
    ``bits`` significant bits, the exponent kept; the other leaves shared."""
    import torch

    def rnd(tree):
        if isinstance(tree, dict):
            return {k: rnd(v) for k, v in tree.items()}
        if isinstance(tree, (list, tuple)):
            return type(tree)(rnd(v) for v in tree)
        if torch.is_tensor(tree) and tree.is_floating_point():
            m, e = torch.frexp(tree)
            return torch.ldexp(torch.round(m * 2 ** bits) / 2 ** bits, e).to(tree.dtype)
        return tree

    vit = params["hamer"]["backbone"]
    return {**params, "hamer": {**params["hamer"],
                                "backbone": {**vit, "blocks": rnd(vit["blocks"])}}}


def write_ppm(path, frame_bgr):
    """A binary P6 PPM (RGB) of a BGR uint8 frame."""
    h, w = frame_bgr.shape[:2]
    with open(path, "wb") as f:
        f.write(f"P6\n{w} {h}\n255\n".encode())
        f.write(np.ascontiguousarray(frame_bgr[..., ::-1]).tobytes())


def deploy_profile_child(root):
    """Run in a process of its own (chip_smoke's profiles come late in a long
    process): load the operator library and both packages under ``root``,
    run each once warm and once under torch.profiler, and print one JSON
    line: the device kernels by name a run, and the ctypes kernel libraries
    this process loaded (none: the packages reach the kernels through the
    operators only)."""
    import torch

    from hamer_yolo_tpu_torch.ops import cuda_build, torch_ops

    torch_ops.register()
    inputs = torch.load(os.path.join(root, "inputs.pt"))
    out = {}
    for model in ("frame", "yolo"):
        pkg = torch._inductor.aoti_load_package(os.path.join(root, f"{model}.pt2"))
        args = [t.cuda() for t in inputs[model]]
        with torch.inference_mode():
            pkg(*args)
            torch.cuda.synchronize()
            out[model] = kernels_by_name(lambda: pkg(*args), again=lambda: pkg(*args))[1]
    out["ctypes_libraries"] = sorted(cuda_build._LOADED)
    out["nms_wrapper_imported"] = "hamer_yolo_tpu_torch.ops.nms" in sys.modules
    print(json.dumps(out))


def _match_slots(got, ref, what):
    """Each eager slot of a frame paired one to one with the package's
    nearest kept slot within FOLD_BOX_PX, for the field hold (F3: near-tied
    scores may put the same boxes in other slots). Returns (pairs, faults):
    a fault where the numbers kept differ or eager keeps none."""
    gv, rv = got["valid"].bool().cpu().numpy(), ref["valid"].bool().cpu().numpy()
    if gv.sum() != rv.sum() or not rv.any():
        return [], [f"{what}: {int(gv.sum())} kept, eager {int(rv.sum())}"]
    gb, rb = got["boxes"].double().cpu().numpy(), ref["boxes"].double().cpu().numpy()
    pairs, used = [], set()
    for s in np.flatnonzero(rv):
        d = np.abs(gb - rb[s]).max(-1)
        hit = [j for j in np.argsort(d, kind="stable") if gv[j] and j not in used
               and d[j] <= FOLD_BOX_PX]
        if hit:
            used.add(hit[0])
            pairs.append((s, hit[0]))
    return pairs, []


def torch_allclose(a, b, tol):
    import torch

    return bool(torch.allclose(a, b, rtol=tol, atol=tol))


def _hold_fields(matched, keys, what):
    """Each field over the ``matched`` slots, [(package, eager, eager with an
    f32 ViT or None)] each a dict of one slot's fields: within DEPLOY_TOL of
    eager (theta as rotations within DEPLOY_AA_TOL), or, where the f32
    reference is given, as accurate as eager bf16: the RMS of package - f32
    at most BF16_ACCURACY_FACTOR x the RMS of eager - f32 (F12: a bf16 form
    of the program is held to bf16's own noise; the RMS, because random
    weights make the MANO head's Gram-Schmidt step ill-conditioned, so one
    bf16 flip moves a single element of a slot by far more than the rest).
    cam_t's error is taken relative to the f32 cam_t, slot by slot: its
    depth is 2 f / (s size), so the same error of the head's s moves a far
    slot's cam_t by the square of its depth more. Returns (faults, readings
    by field)."""
    import torch

    from hamer_yolo_tpu_torch.geometry.rotations import aa_to_rotmat

    faults, readings = [], {}
    for k in keys:
        def stack(i):
            v = torch.stack([m[i][k] for m in matched]).double()
            return aa_to_rotmat(v.reshape(-1, 3)) if k == "theta" else v

        g, r = stack(0), stack(1)
        tol = DEPLOY_AA_TOL if k == "theta" else DEPLOY_TOL
        ok = bool(torch.allclose(g, r, rtol=tol, atol=tol))
        reading = {"max_diff": float((g - r).abs().max())}
        if matched[0][2] is not None:
            r32 = stack(2)

            def err(x):
                if k == "cam_t":  # its depth is 2 f / (s size): an error of s is relative
                    return (x - r32).norm(dim=-1) / r32.norm(dim=-1)
                return x - r32

            acc, floor = (float(err(x).square().mean().sqrt()) for x in (g, r))
            reading.update(package_rms_vs_f32=acc, eager_rms_vs_f32=floor,
                           ratio=acc / floor if floor else float("inf"))
            ok = ok or acc <= BF16_ACCURACY_FACTOR * floor
        readings[k] = reading
        if not ok:
            faults.append(f"{what}: {k} {reading} beyond the limits")
    return faults, readings


def _hold_package(model, runs, what):
    """The package's outputs against eager's over ``runs``, [(package,
    eager, eager with an f32 ViT or None)] a frame: in each frame the same
    number kept, the keep sets over all frames matched by box as the folded
    detector's are (_keep_sets_match: at most FOLD_UNMATCHED_SHARE of the
    kept boxes further than FOLD_BOX_PX from all the other side's; the yolo
    program's classes equal on the pairs), then the fields over the pairs
    (_match_slots, _hold_fields)."""
    import torch

    if model == "yolo":
        runs = [tuple(None if t is None else {k: v[0] for k, v in t.items()} for t in run)
                for run in runs]
    faults, matched, exact = [], [], 0
    for got, ref, ref32 in runs:
        pairs, f = _match_slots(got, ref, what)
        faults += f
        if model == "yolo" and any(int(got["classes"][j]) != int(ref["classes"][i])
                                   for i, j in pairs):
            faults.append(f"{what}: a kept detection's class departs from eager")
        exact += sum(bool((got["boxes"][j] == ref["boxes"][i]).all()) for i, j in pairs)
        matched += [({k: v[j] for k, v in got.items()}, {k: v[i] for k, v in ref.items()},
                     None if ref32 is None else {k: v[i] for k, v in ref32.items()})
                    for i, j in pairs]
    kept, unmatched = _keep_set_counts(*(SimpleNamespace(
        boxes=torch.stack([run[i]["boxes"] for run in runs]).cpu(),
        valid=torch.stack([run[i]["valid"] for run in runs]).bool().cpu()) for i in (0, 1)))
    if unmatched > FOLD_UNMATCHED_SHARE * kept:
        faults.append(f"{what}: {unmatched} of {kept} kept boxes unmatched (limit "
                      f"{FOLD_UNMATCHED_SHARE:.0%} within {FOLD_BOX_PX} px)")
    summary = (f"{len(runs)} frame(s): keep sets {kept} kept boxes (both sides), {unmatched} "
               f"unmatched within {FOLD_BOX_PX} px (limit {FOLD_UNMATCHED_SHARE:.0%}); "
               f"{len(matched)} slot pairs, {exact} the same box")
    if not matched:
        return faults + [f"{what}: no slot pair to hold the fields on"], {}, summary
    keys = ("boxes", "scores") if model == "yolo" else (
        "boxes", "scores", "theta", "betas", "cam_t", "vertices")
    f, readings = _hold_fields(matched, keys, what)
    return faults + f, readings, summary


def routes_bitwise(params, cfg, tok, heads):
    """K1 and K2 through their operators against the ctypes wrappers on the
    deploy path's own inputs (the detector's candidates on one 720p frame
    and on the main path's four; block 0's tokens of four crops, bf16 and
    f32): equal bit for bit."""
    import torch

    from hamer_yolo_tpu_torch.ops import torch_ops
    from hamer_yolo_tpu_torch.ops.attn_block import fused_bf16_attn_block
    from hamer_yolo_tpu_torch.ops.nms import greedy_nms_keep_mask

    blk = params["hamer"]["backbone"]["blocks"][0]
    args = (blk["attn"]["qkv"]["w"], blk["attn"]["qkv"]["b"], blk["norm1"]["scale"],
            blk["norm1"]["bias"], heads)
    faults = []
    with torch.inference_mode():
        for B in (1, BATCH):
            c = detector_candidates(params["yolo"], cfg, tok.device, B)
            a = greedy_nms_keep_mask(c.shifted, c.active, cfg.iou_thres)
            b = torch_ops.greedy_nms_keep_mask(c.shifted, c.active, cfg.iou_thres)
            if not torch.equal(a, b):
                faults.append(f"K1 at B = {B}: the operator's keep set departs from the wrapper's")
        for t in (tok, tok.float()):
            a = fused_bf16_attn_block(t, *args)
            b = torch_ops.fused_bf16_attn_block(t, *args)
            if not torch.equal(a, b):
                faults.append(f"K2 on {t.dtype} tokens {tuple(t.shape)}: the operator departs "
                              f"from the wrapper by {float((a.float() - b.float()).abs().max())}")
    print(f"deploy: operators against the ctypes wrappers: K1 at B = 1 and {BATCH}, K2 on "
          f"{tuple(tok.shape)} bf16 and f32 tokens: "
          f"{'bit for bit' if not faults else faults}", flush=True)
    return faults


def run_runner(runner, root, smi):
    """The C++ runner: one-shot on the yolo package with a 720p PPM
    (detections JSON), then --serve on the frame package over DEPLOY_FRAMES
    PPMs and ``quit``; every JSON line parsed. Returns (faults, the serve
    loop's JSON lines)."""
    faults = []
    ppms = []
    for i, f in enumerate(frames_720p(DEPLOY_FRAMES, SEED + 9)):
        ppms.append(os.path.join(root, f"frame{i}.ppm"))
        write_ppm(ppms[-1], f)
    t0 = time.perf_counter()
    one = subprocess.run([str(runner), os.path.join(root, "yolo.pt2"),
                          os.path.join(root, "yolo.meta"), ppms[0]], capture_output=True,
                         text=True, timeout=RUNNER_TIMEOUT_S)
    t_one = time.perf_counter() - t0
    lines = one.stdout.splitlines()
    dets = [json.loads(ln) for ln in lines if ln.startswith("{")]
    if one.returncode != 0 or not lines or lines[-1] != "OK" or len(dets) != 1:
        faults.append(f"runner one-shot: rc {one.returncode}, stdout {one.stdout[-2000:]!r}, "
                      f"stderr {one.stderr[-2000:]!r}")
    else:
        iters = [ln for ln in lines if ln.startswith("iter ")]
        print(f"deploy: runner one-shot on the yolo package and a 720p PPM in {t_one:.1f} s "
              f"(process start, package load, 3 runs): {'; '.join(iters)}; "
              f"{len(dets[0]['detections'])} detections, first "
              f"{dets[0]['detections'][:2]}", flush=True)
    t0 = time.perf_counter()
    serve = subprocess.run([str(runner), os.path.join(root, "frame.pt2"),
                            os.path.join(root, "frame.meta"), "--serve"],
                           input="\n".join(ppms + ["quit"]) + "\n", capture_output=True,
                           text=True, timeout=RUNNER_TIMEOUT_S)
    t_serve = time.perf_counter() - t0
    lines = serve.stdout.splitlines()
    rows = []
    try:
        rows = [json.loads(ln) for ln in lines[1:]]
    except json.JSONDecodeError as e:
        faults.append(f"runner --serve: a line is not JSON ({e}): {serve.stdout[-2000:]!r}")
    if (serve.returncode != 0 or not lines or lines[0] != "ready" or len(rows) != DEPLOY_FRAMES
            or any("outputs" not in r or not all(np.isfinite(r["outputs"])) for r in rows)):
        faults.append(f"runner --serve: rc {serve.returncode}, stdout {serve.stdout[-2000:]!r}, "
                      f"stderr {serve.stderr[-2000:]!r}")
    else:
        print(f"deploy: runner --serve on the frame package over {DEPLOY_FRAMES} 720p PPMs in "
              f"{t_serve:.1f} s (process start, package load, a warm-up run): ms a frame "
              f"{[r['ms'] for r in rows]}, p50 {np.median([r['ms'] for r in rows]):.2f} ms "
              f"(host clock, upload to copy back) on {smi}", flush=True)
    return faults, rows


def deploy_inputs(dev, cfg):
    """The deploy phase's first 720p frame, its intrinsics, and each
    program's inputs on it: the frame program's (image, (h, w), K) and the
    detector's letterboxed RGB input in [0, 1]."""
    import torch

    from hamer_yolo_tpu_torch.pipeline.preprocess import device_letterbox
    from hamer_yolo_tpu_torch.pipeline.runner import default_intrinsics

    frame = frames_720p(1, SEED + 9)[0]
    K = default_intrinsics(frame.shape)
    hw = torch.tensor([720.0, 1280.0], device=dev)
    img = torch.from_numpy(frame).to(dev).to(torch.float32)
    with torch.inference_mode():
        lb, _, _ = device_letterbox(img[None], hw[None], cfg.det_size)
    return frame, K, {"frame": (img, hw, torch.from_numpy(K).to(dev)),
                      "yolo": ((lb.flip(-1) / 255.0).contiguous(),)}


def _weights_sum(tree):
    return sum(float(t.double().sum()) for t in _tree_leaves(tree))


def build_package(model, cfg, tree, mano, args, root, dev):
    """Export ``model`` over the weights ``tree``, hold the exported graph,
    run op by op on the card (K1 and K2 through the operators), to eager
    through the wrappers on ``args`` bit for bit, and compile it into
    ``root``/<model>.pt2 beside its .meta. Returns (seconds by step, the
    constants' bytes, faults)."""
    import torch

    from hamer_yolo_tpu_torch.tools import export_executable as ee

    prog = ee.program(model, cfg, (720, 1280), dev)
    t0 = time.perf_counter()
    ep, module = ee.export_program(prog, tree, mano)
    t_export = time.perf_counter() - t0
    nbytes = ee.constant_bytes(module)
    del module
    with torch.inference_mode():
        traced = ep.module()(*args)
        eager = prog.fn(tree, mano, *args)
    differ = [n for n, a, b in zip(prog.outputs, traced, eager) if not torch.equal(a, b)]
    print(f"deploy {model}: the exported graph run on the card against eager: "
          f"{'bit for bit' if not differ else f'{differ} differ'}", flush=True)
    faults = [f"deploy {model}: the exported graph departs from eager in {differ}"] if differ \
        else []
    del traced, eager
    t0 = time.perf_counter()
    ee.compile_package(ep, os.path.join(root, f"{model}.pt2"))
    t_compile = time.perf_counter() - t0
    with open(os.path.join(root, f"{model}.meta"), "w") as f:
        f.write("\n".join(ee.meta_lines(prog.inputs)) + "\n")
    del ep
    torch.cuda.empty_cache()
    return {"export": t_export, "AOTInductor compile": t_compile}, nbytes, faults


def deploy_build_child(root):
    """The yolo package built by ``build_package`` in a process of its own,
    beside the frame's in the deploy phase: main's seeded detector weights
    (init_pipeline_params draws the detector first from the seed), the
    phase's first frame. Prints one JSON line."""
    import torch

    from hamer_yolo_tpu_torch.cli.main import pipeline_config
    from hamer_yolo_tpu_torch.core.mano_assets import synthetic_mano_model
    from hamer_yolo_tpu_torch.models.mano import ManoModel
    from hamer_yolo_tpu_torch.models.yolov7.model import init_yolov7
    from hamer_yolo_tpu_torch.ops import torch_ops

    torch_ops.register()
    dev = torch.device("cuda:0")
    cfg = pipeline_config()
    mano = ManoModel.from_arrays(synthetic_mano_model(SEED), dev)
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED)
    tree = {"yolo": init_yolov7(gen, cfg.yolo)}
    secs, nbytes, faults = build_package("yolo", cfg, tree, mano, deploy_inputs(dev, cfg)[2]["yolo"],
                                         root, dev)
    print(json.dumps({"secs": secs, "constant_bytes": nbytes, "faults": faults,
                      "weights_sum": _weights_sum(tree)}))


def deploy_phase(dev, smi, params, mano, cfg, program, tok, depth):
    """The phase "deploy" (the module's docstring says what it holds).
    Returns the kernels' launches a run of each package. Alone:
    ``chip_smoke.deploy_phase(dev, smi, params, mano, cfg, program, tok0[:4],
    depth)`` after main's set-up."""
    import torch

    from hamer_yolo_tpu_torch import cpp
    from hamer_yolo_tpu_torch.ops import torch_ops
    from hamer_yolo_tpu_torch.tools import export_executable as ee

    t_phase = time.perf_counter()
    torch_ops.register()
    pool = ThreadPoolExecutor(1)  # the runner's g++ beside the exports and compiles
    runner_job = pool.submit(lambda t0: (cpp.build_runner(), time.perf_counter() - t0),
                                time.perf_counter())
    frame, K, inputs = deploy_inputs(dev, cfg)
    hw = inputs["frame"][1]
    trees = {"frame": params, "yolo": {"yolo": params["yolo"]}}
    faults = routes_bitwise(params, cfg, tok, cfg.hamer.vit.num_heads)
    print(f"deploy: the packages' C++ compiler {ee.openmp_compiler()}", flush=True)
    by_path = {"K1": {}, "K2": {}}
    with tempfile.TemporaryDirectory() as root:
        # the yolo package is built in a process of its own beside the frame's
        here = os.path.dirname(os.path.abspath(__file__))
        yolo_child = subprocess.Popen(
            [sys.executable, "-c", "import sys; sys.path.insert(0, sys.argv[1]); import "
             "chip_smoke; chip_smoke.deploy_build_child(sys.argv[2])", here, root],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        secs, nbytes, f = build_package("frame", cfg, params, mano, inputs["frame"], root, dev)
        faults += f
        out, err = yolo_child.communicate(timeout=900)
        if yolo_child.returncode != 0:
            raise RuntimeError(f"deploy: building the yolo package: {err[-3000:]}")
        child = json.loads(out.strip().splitlines()[-1])
        faults += child["faults"]
        if child["weights_sum"] != _weights_sum(trees["yolo"]):
            faults.append("deploy yolo: the child's detector weights are not main's")
        secs, nbytes = {"frame": secs, "yolo": child["secs"]}, {"frame": nbytes,
                                                                "yolo": child["constant_bytes"]}
        progs, pkgs = {}, {}
        for model in ("frame", "yolo"):
            progs[model] = ee.program(model, cfg, (720, 1280), dev)
            path = os.path.join(root, f"{model}.pt2")
            t0 = time.perf_counter()
            pkgs[model] = torch._inductor.aoti_load_package(path)
            secs[model]["package load"] = time.perf_counter() - t0
            print(f"deploy {model}: package {os.path.getsize(path)} bytes ({nbytes[model]} bytes "
                  "of constants); " + ", ".join(f"{k} {v:.1f} s" for k, v in secs[model].items())
                  + (" (in a process of its own, beside the frame's)" if model == "yolo" else ""),
                  flush=True)

        # the packages against eager (the frame on DEPLOY_FRAMES frames), and no
        # wrapper launch on their runs; the frame's fields also against eager
        # with an f32 ViT (plain layers), and eager's other bf16 form (the
        # plain layers for K2) against eager, printed beside; the hold's
        # control (coarse_blocks) must be reported as wrong
        vit32 = dataclasses.replace(cfg.hamer.vit, compute_dtype="float32", fused_attn=False)
        cfg32 = dataclasses.replace(cfg, hamer=dataclasses.replace(cfg.hamer, vit=vit32))
        cfg_plain = dataclasses.replace(cfg, hamer=dataclasses.replace(
            cfg.hamer, vit=dataclasses.replace(cfg.hamer.vit, fused_attn=False)))
        runs = {"frame": [(torch.from_numpy(f).to(dev).to(torch.float32), hw, inputs["frame"][2])
                          for f in frames_720p(DEPLOY_FRAMES, SEED + 9)],
                "yolo": [inputs["yolo"]]}
        with torch.inference_mode():
            coarse = coarse_blocks(params)
            for model in ("frame", "yolo"):
                names, held, spread, controls = progs[model].outputs, [], [], []
                for args in runs[model]:
                    got, n = run_counted(lambda: pkgs[model](*args))
                    if any(n.values()):
                        faults.append(f"deploy {model}: the package ran a wrapper: launches {n}")
                    ref = dict(zip(names, progs[model].fn(trees[model], mano, *args)))
                    ref32 = None
                    if model == "frame":
                        ref32 = dict(zip(names, ee.program(model, cfg32, (720, 1280), dev).fn(
                            params, mano, *args)))
                        plain = dict(zip(names, ee.program(model, cfg_plain, (720, 1280),
                                                           dev).fn(params, mano, *args)))
                        spread.append((plain, ref, ref32))
                        controls.append((dict(zip(names, progs[model].fn(coarse, mano, *args))),
                                         ref, ref32))
                        if not held:
                            frame_sums = [float(v.double().sum()) for v in got]
                    held.append((dict(zip(names, got)), ref, ref32))
                f, readings, slots = _hold_package(model, held, f"deploy {model} package "
                                                                "against eager")
                faults += f
                print(f"deploy {model}: the package against eager on the same weights and "
                      f"720p frames: {slots}; {readings} (limits {DEPLOY_TOL}, rotations "
                      f"{DEPLOY_AA_TOL}, or an RMS from the f32 ViT's at most "
                      f"{BF16_ACCURACY_FACTOR} x eager bf16's); {'held' if not f else f}",
                      flush=True)
                if spread:
                    print(f"deploy {model}: eager with the plain layers for K2 against eager "
                          f"with K2, the same measures: {_hold_package(model, spread, '')[1]}",
                          flush=True)
                    f, readings, _ = _hold_package(model, controls, "control")
                    print(f"deploy {model}: the hold's control, eager with the ViT blocks' "
                          f"weights at {CONTROL_BITS} significant bits, in its place: "
                          f"{'reported wrong' if f else 'passed'}: {readings}", flush=True)
                    if not f:
                        faults.append(f"deploy {model}: the field hold passed its control")
            del coarse, controls

        # the device kernels of a run, by name, in a process of its own
        torch.save({k: [t.cpu() for t in v] for k, v in inputs.items()},
                   os.path.join(root, "inputs.pt"))
        child = subprocess.run([sys.executable, "-c", "import sys; sys.path.insert(0, sys.argv[1]);"
                                " import chip_smoke; chip_smoke.deploy_profile_child(sys.argv[2])",
                                here, root], capture_output=True, text=True, timeout=600)
        if child.returncode != 0:
            raise RuntimeError(f"deploy profile: {child.stderr[-3000:]}")
        prof = json.loads(child.stdout.strip().splitlines()[-1])
        for model, k2 in (("frame", depth), ("yolo", 0)):
            counts = prof[model]
            try:
                expect_replay(f"deploy {model} package", counts, 1, k2)
            except RuntimeError as e:
                faults.append(str(e))
            by_path["K1"][f"deploy {model}"] = named(counts, K1_KERNEL)
            if k2:
                by_path["K2"][f"deploy {model}"] = named(counts, K2_KERNELS[1])
        if prof["ctypes_libraries"] or prof["nms_wrapper_imported"]:
            faults.append(f"deploy: the packages' process reached a ctypes path: {prof}")
        print(f"deploy: the packages' process loaded no ctypes kernel library "
              f"({prof['ctypes_libraries']}); kernels a run {by_path}", flush=True)

        # p50 of 20 runs each, numpy frame in and numpy out, in turns
        def package_frame():
            with torch.inference_mode():
                out = pkgs["frame"](torch.from_numpy(frame).to(dev).to(torch.float32), hw,
                                    inputs["frame"][2])
                return [o.cpu() for o in out]

        def yolo_run(fn):
            with torch.inference_mode():
                return [o.cpu() for o in fn()]

        p50 = interleaved_p50({
            "package": package_frame,
            "eager": lambda: eager_frame(params, mano, cfg, dev, frame, K),
            "graph": lambda: program(frame, K)}, rounds=DEPLOY_ROUNDS)
        y50 = interleaved_p50({
            "package": lambda: yolo_run(lambda: pkgs["yolo"](*inputs["yolo"])),
            "eager": lambda: yolo_run(lambda: progs["yolo"].fn(trees["yolo"], mano,
                                                               *inputs["yolo"]))},
            rounds=DEPLOY_ROUNDS)
        print(f"deploy frame 720p, upload to copy back: p50 {p50['package']:.2f} ms the "
              f"package, {p50['eager']:.2f} ms eager infer_frame, {p50['graph']:.2f} ms "
              f"FrameProgram's captured graph; deploy yolo at 640 (letterboxed input on the "
              f"card to outputs on the host): p50 {y50['package']:.2f} ms the package, "
              f"{y50['eager']:.2f} ms eager yolov7_forward + NMS (host clock, 20 runs each "
              f"in turns) on {smi}", flush=True)
        del pkgs
        torch.cuda.empty_cache()

        # the C++ runner
        runner, t_runner = runner_job.result()
        pool.shutdown()
        print(f"deploy: runner built in {t_runner:.1f} s beside the compiles -> {runner.name}",
              flush=True)
        f, rows = run_runner(runner, root, smi)
        faults += f
        if rows:
            d = max(abs(a - b) / max(1.0, abs(b)) for a, b in zip(rows[0]["outputs"], frame_sums))
            print(f"deploy: the runner's checksums of frame 0 against the package run from "
                  f"Python on the same frame: largest relative difference {d:.3g}", flush=True)
            if d > 1e-4:
                faults.append(f"runner checksums {rows[0]['outputs']} against Python's "
                              f"{frame_sums}")
    if faults:
        raise RuntimeError("phase deploy: " + "; ".join(faults))
    print(f"phase deploy: {time.perf_counter() - t_phase:.1f} s", flush=True)
    return by_path


if __name__ == "__main__":
    sys.exit(main())
