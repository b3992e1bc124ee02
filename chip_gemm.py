#!/usr/bin/env python3
"""Device time of a checkout's int8 GEMM launch at ViT-H's four GEMM shapes,
or, with --k2, of its kernel K2.

    python3 chip_gemm.py [--k2] [--root DIR | --variant noepi|noload] [--ptxas]

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

The last line of stdout is a JSON object: {"root", "variant", "device",
"ms": {"<gemm> M <rows>": {...}}, "host_us": {...}} (with --k2: "ms":
{"<what> M <rows>": ms}).
"""
import argparse
import json
import os
import subprocess
import sys

import chip_smoke  # this checkout's phase; the package comes from --root

VARIANTS = {"noepi": 1, "noload": 2}  # the value of the source's diagnostic macro
SOURCES = {False: ("int8_gemm.cu", "HYT_GEMM_DIAG"), True: ("attn_block.cu", "HYT_K2_DIAG")}


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


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=os.path.dirname(os.path.abspath(__file__)))
    ap.add_argument("--variant", choices=sorted(VARIANTS))
    ap.add_argument("--ptxas", action="store_true")
    ap.add_argument("--k2", action="store_true", help="time K2 (csrc/attn_block.cu)")
    args = ap.parse_args()
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
    source, macro = SOURCES[args.k2]
    if args.variant or args.ptxas:
        flags = [f"-D{macro}={VARIANTS[args.variant]}"] if args.variant else []
        build_source(source, flags, args.ptxas)
    print(f"package {root}, {source}, variant {args.variant}", flush=True)
    dev = torch.device("cuda:0")
    if args.k2:
        times = chip_smoke.k2_alone(dev, check=False)
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
