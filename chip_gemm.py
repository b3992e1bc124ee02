#!/usr/bin/env python3
"""Device time of a checkout's int8 GEMM launch at ViT-H's four GEMM shapes,
or, with --k2, of its kernel K2, with --k10, of its kernel K10, or, with
--k1, of its kernel K1.

    python3 chip_gemm.py [--k1 | --k2 | --k10] [--root DIR | --variant VARIANT] [--ptxas]

Imports hamer_yolo_tpu_torch from DIR (default: this script's checkout) and
times its ``ops/int8_matmul.int8_gemm`` with chip_smoke.int8_gemm_alone
(each GEMM with the static int8 path's epilogue and with K5's, by CUDA graph
replay, beside torch._int_mm's bare GEMM), without the check against the
plain version, which another commit's package may not have; then the host
time a call of its ``quantize_rows`` and ``int8_gemm`` wrappers
(chip_smoke.wrapper_host_us). Two commits compare in one chip call, in
turns on one card:

    python3 chip_gemm.py --root OLD; python3 chip_gemm.py
    python3 chip_gemm.py; python3 chip_gemm.py --root OLD

with OLD a directory that .gitignore lists, holding the other commit
(``git archive <commit> | tar -x -C OLD``).

``--variant`` times this checkout's kernel with one part of its work taken
out, to see what holds it back (its outputs are then wrong, and unchecked):
``noepi``, the epilogue warpgroups skip their arithmetic and stores (the
products and loads alone); ``noload``, the producer issues no TMA copies
(the products and the epilogue on whatever the ring holds). It builds
csrc/int8_gemm.cu with the macro HYT_GEMM_DIAG set, through
``cuda_build.set_flags``. ``--ptxas`` adds ``-Xptxas -v`` to that build of
this checkout's int8_gemm.cu, alone, and prints its seconds and each
kernel's registers and spills.

``--k2`` does the same for K2 (csrc/attn_block.cu, macro HYT_K2_DIAG):
chip_smoke.k2_alone times its LN + QKV GEMM launches (where the package has
``attn_block.ln_qkv``) and all of K2 at the bf16 path's rows, beside the
library composition, without the check; ``noepi`` leaves out the GEMM's
epilogue (the staging and TMA stores of qkv), ``noload`` its TMA copies.

``--k10`` times K10 beside K4 (chip_smoke.k10_alone: ViT-H's MLP, K 1280
and H 5120, at the rows of 1, 4 and 16 frames, M = 768, 3072, 12288), by
CUDA graph replay, and K10's single launch with its host work, without the
check against K4; its variants (csrc/int8_gemm.cu, macro HYT_K10_DIAG):
``noepi`` leaves out the GELU epilogue and the final one, ``noload`` the TMA
copies of both weight rings, ``noexchange`` the stores of each GELU slice
to the other CTAs of the cluster, ``noln`` the LN and quantize of the rows,
``nofc1`` and ``nofc2`` the products of fc1 and fc2, ``nofinal`` the final
dequant + residual; ``trace`` prints, instead of times, the SM clock at each
step of the first CTA of one launch at each M, and every CTA's span
(k10_trace).

``--k1`` times K1 (chip_smoke.k1_alone) at (4, 512) and (16, 512) on the
detector's candidates (YOLOv7 at full width, chip_smoke's seed and frames)
and on its worst case, by CUDA graph replay, with the launch floor where the
package has it and one call with host work, without the check; its
variants (csrc/nms.cu, macro HYT_NMS_DIAG): ``tail``, the design that
lost (no cluster, the rows through a workspace in device memory, the scan
in the CTA that completes a per-image count); ``noscan`` leaves out the
scan, ``nobuild`` the rows and the scan, ``norows`` the stores of the rows
(not the diagonal words), ``noiou`` the IoU arithmetic; ``trace`` prints,
instead of times, the SM clock at each step of the first CTA of one launch
(k1_trace).

The last line of stdout is a JSON object: {"root", "variant", "device",
"ms": {"<gemm> M <rows>": {...}}, "host_us": {...}} (with --k2 or --k10:
"ms": {"<what> M <rows>": ms}; with --k1: "ms": {"<what> B <frames>": ms}).
"""
import argparse
import json
import os
import subprocess
import sys

import chip_smoke  # this checkout's phase; the package comes from --root

# the value of the source's diagnostic macro
VARIANTS = {"noepi": 1, "noload": 2, "noexchange": 3, "noln": 4, "trace": 5, "nofc1": 6, "nofc2": 7,
            "nofinal": 8, "tail": 1, "noscan": 2, "nobuild": 3, "norows": 6,
            "noiou": 7}
VARIANTS_OF = {"gemm": ("noepi", "noload"), "k2": ("noepi", "noload"),
               "k1": ("tail", "noscan", "nobuild", "trace", "norows", "noiou"),
               "k10": ("noepi", "noload", "noexchange", "noln", "trace", "nofc1", "nofc2",
                       "nofinal")}
SOURCES = {"gemm": ("int8_gemm.cu", "HYT_GEMM_DIAG"), "k2": ("attn_block.cu", "HYT_K2_DIAG"),
           "k10": ("int8_gemm.cu", "HYT_K10_DIAG"), "k1": ("nms.cu", "HYT_NMS_DIAG")}


def build_source(source, flags, ptxas: bool) -> None:
    """Build and load csrc/<source> alone with ``flags`` added; with
    ``ptxas``, print the build's seconds and each kernel's registers and
    spills."""
    from hamer_yolo_tpu_torch.ops import cuda_build

    cuda_build.set_flags(source, flags + (["-Xptxas", "-v"] if ptxas else []))
    cuda_build.load(source)
    if not ptxas:
        return
    if source not in cuda_build.BUILD_LOG:
        raise RuntimeError(f"--ptxas: {source} was built before, so nvcc printed nothing")
    print(f"nvcc {source} alone {' '.join(flags)}, -Xptxas -v: "
          f"{cuda_build.BUILD_SECONDS[source]:.1f} s")
    kernel = None
    for line in cuda_build.BUILD_LOG[source].splitlines():
        if "Compiling entry function" in line:
            kernel = line.split("'")[1]
        elif kernel and ("registers" in line or "spill" in line):
            print(f"  {kernel[:90]}: {line.split('info    :')[-1].strip()}")


def k10_trace(dev, M=3072, K=1280, H=5120) -> None:
    """One K10 launch of the HYT_K10_DIAG=5 build: its first CTA writes the
    SM clock at each step into the first 128 int64 slots of its tokens (slot
    0 the start; 1, 2 the LN done and the cluster barrier passed; 3 + 4c ..
    6 + 4c chunk c's fc1 done, buffer free, GELU slice stored, slice sent;
    64 + 3c, 65 + 3c chunk c's slices arrived and fc2 done; 126 the last
    fc2, 124 and 125 the final epilogue's residual tile in and its sums
    done, 127 the end), and every CTA its start and end on the global timer
    and its SM from slot 128 on; printed as cycles from the start, and the
    CTAs' spans (ns) as waves: the CTAs that started within 2 us of each
    other."""
    import numpy as np
    import torch

    from hamer_yolo_tpu_torch.ops import int8_matmul as im

    rng = np.random.default_rng(0)

    def put(a):
        return torch.from_numpy(a).to(dev)

    tok = put(rng.normal(size=(M, K)).astype(np.float32)).bfloat16()
    args = (put(rng.integers(-127, 128, (K, H)).astype(np.int8)),
            put((1e-3 * rng.random(H)).astype(np.float32)),
            put((0.1 * rng.random(H)).astype(np.float32)),
            put(rng.integers(-127, 128, (H, K)).astype(np.int8)),
            put((1e-3 * rng.random(K)).astype(np.float32)),
            put((0.1 * rng.random(K)).astype(np.float32)), torch.ones(K, device=dev),
            torch.zeros(K, device=dev), torch.tensor(0.034, device=dev),
            torch.tensor(0.021, device=dev))
    for _ in range(3):  # the last of three launches, warm
        im.fused_int8_mlp_block1(tok, *args, gelu="gelu_poly")
    torch.cuda.synchronize()
    t = tok.reshape(-1).view(torch.int64)[:128].cpu().numpy()
    t = [int(v - t[0]) for v in t]
    chunks = -(-H // (im.MLP1_FC1_COLS * im.mlp1_cluster(K)))
    print(f"K10 trace M {M} K {K} H {H}, first CTA, SM cycles from its start: LN done {t[1]}, "
          f"cluster barrier {t[2]}, last fc2 {t[126]}, residual tile in {t[124]}, sums done "
          f"{t[125]}, end {t[127]}")
    for c in range(chunks):
        print(f"  chunk {c}: fc1 done {t[3 + 4 * c]}, buffer free {t[4 + 4 * c]}, GELU stored "
              f"{t[5 + 4 * c]}, sent {t[6 + 4 * c]} | arrived {t[64 + 3 * c]}, fc2 done "
              f"{t[65 + 3 * c]}")
    ctas = -(-M // 64) * im.mlp1_cluster(K)
    span = tok.reshape(-1).view(torch.int64)[128:128 + 3 * ctas].cpu().numpy().reshape(-1, 3)
    span[:, :2] -= span[:, 0].min()
    order = np.argsort(span[:, 0])
    waves, first = [], None
    for i in order:
        if first is None or span[i, 0] - first > 2000:
            waves.append([])
            first = span[i, 0]
        waves[-1].append(i)
    print(f"  {ctas} CTAs on {len(set(span[:, 2]))} SMs, launch {int(span[:, 1].max())} ns: "
          + "; ".join(f"wave {k}: {len(w)} CTAs start {int(span[w, 0].min())}-"
                      f"{int(span[w, 0].max())}, end {int(span[w, 1].min())}-"
                      f"{int(span[w, 1].max())}" for k, w in enumerate(waves)))


def k1_candidates(dev):
    """The detector's K1 input at B = 4 and 16 (chip_smoke.detector_candidates):
    YOLOv7 at full width with chip_smoke's seed (the detector's weights are
    drawn first, as init_pipeline_params draws them); and the threshold."""
    import torch

    from hamer_yolo_tpu_torch.cli.main import pipeline_config
    from hamer_yolo_tpu_torch.models.yolov7.model import init_yolov7

    cfg = pipeline_config(tiny=False)
    gen = torch.Generator(device=dev)
    gen.manual_seed(chip_smoke.SEED)
    yolo = init_yolov7(gen, cfg.yolo)
    return {B: chip_smoke.detector_candidates(yolo, cfg, dev, B)
            for B in chip_smoke.K1_BATCHES}, cfg.iou_thres


def k1_trace(dev) -> None:
    """One launch of the HYT_NMS_DIAG=5 build at (4, 512) on the detector's
    candidates and on the worst case: the first CTA of the first image
    writes the SM clock at each step into its keep mask's first words
    (cycles from its start: 1 boxes and active bits staged, 2 the first
    cluster barrier passed, every CTA running, 3 and 4 the last and the
    first warp done with its rows, 5 the CTA's rows done, 6 the second
    cluster barrier passed, 7 the scan done, 8 the keep mask written), then
    the words the scan took, the rounds of its fixed points and the SM of
    each CTA of the cluster."""
    import torch

    from hamer_yolo_tpu_torch.ops.nms import greedy_nms_keep

    cands, thr = k1_candidates(dev)
    c = cands[4]
    cases = {"detector": (c.shifted.contiguous(), c.active.to(torch.float32)),
             "worst_case": chip_smoke.disjoint_boxes(4, c.shifted.shape[1], dev)}
    names = ["staged", "first barrier", "rows, last warp", "rows, first warp", "rows",
             "barrier", "scan", "written"]
    for what, (bx, act) in cases.items():
        for _ in range(3):  # the last of three launches, warm
            keep = greedy_nms_keep(bx, act, thr)
        t = keep[0, :27].contiguous().view(torch.int32).cpu().tolist()
        print(f"K1 trace {what} (4, {bx.shape[1]}), first CTA, SM cycles from its start: "
              + ", ".join(f"{n} {v}" for n, v in zip(names, t[1:9]))
              + f"; scan: {t[9]} words, {t[10]} rounds; the cluster's SMs {t[11:27]}")


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=os.path.dirname(os.path.abspath(__file__)))
    ap.add_argument("--variant", choices=sorted(VARIANTS))
    ap.add_argument("--ptxas", action="store_true")
    which = ap.add_mutually_exclusive_group()
    which.add_argument("--k2", action="store_true", help="time K2 (csrc/attn_block.cu)")
    which.add_argument("--k10", action="store_true", help="time K10 beside K4")
    which.add_argument("--k1", action="store_true", help="time K1 (csrc/nms.cu)")
    args = ap.parse_args()
    kind = "k1" if args.k1 else "k2" if args.k2 else "k10" if args.k10 else "gemm"
    if args.variant and args.variant not in VARIANTS_OF[kind]:
        raise ValueError(f"--variant {args.variant} does not apply to {kind}")
    import torch

    if not torch.cuda.is_available():
        print("chip_gemm: no CUDA device", file=sys.stderr)
        return 1
    root = os.path.abspath(args.root)
    if (args.variant or args.ptxas) and root != os.path.dirname(os.path.abspath(__file__)):
        raise ValueError("--variant and --ptxas apply to this checkout's kernel only")
    sys.path.insert(0, root)
    import hamer_yolo_tpu_torch

    if os.path.dirname(os.path.dirname(os.path.abspath(hamer_yolo_tpu_torch.__file__))) != root:
        raise RuntimeError(f"imported {hamer_yolo_tpu_torch.__file__}, not the package in {root}")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader",
                          "--id=0"], capture_output=True, text=True, check=True).stdout.strip())
    source, macro = SOURCES[kind]
    if args.variant or args.ptxas:
        flags = [f"-D{macro}={VARIANTS[args.variant]}"] if args.variant else []
        build_source(source, flags, args.ptxas)
    print(f"package {root}, {source}, variant {args.variant}", flush=True)
    dev = torch.device("cuda:0")
    if args.variant == "trace" and kind == "k10":
        for M in chip_smoke.K10_ROWS:
            k10_trace(dev, M)
        return 0
    if kind == "k1" and args.variant == "trace":
        k1_trace(dev)
        return 0
    if kind == "k1":
        times = chip_smoke.k1_alone(*k1_candidates(dev))
        print(json.dumps({"root": root, "variant": args.variant,
                          "device": torch.cuda.get_device_name(0),
                          "ms": {f"{what} B {b}": t for (what, b), t in times.items()}}))
        return 0
    if kind != "gemm":
        times = (chip_smoke.k2_alone if args.k2 else chip_smoke.k10_alone)(dev, check=False)
        print(json.dumps({"root": root, "variant": args.variant,
                          "device": torch.cuda.get_device_name(0),
                          "ms": {f"{name} M {m}": r for (name, m), r in times.items()}}))
        return 0
    times = chip_smoke.int8_gemm_alone(dev, check=False)
    host = chip_smoke.wrapper_host_us(dev)
    print(json.dumps({"root": root, "variant": args.variant,
                      "device": torch.cuda.get_device_name(0),
                      "ms": {f"{name} M {m}": r for (name, m), r in times.items()},
                      "host_us": host}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
