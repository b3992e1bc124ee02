#!/usr/bin/env python3
"""Device time of a checkout's int8 GEMM launch at ViT-H's four GEMM shapes.

    python3 chip_gemm.py [--root DIR | --variant noepi|noload] [--ptxas]

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

The last line of stdout is a JSON object: {"root", "variant", "device",
"ms": {"<gemm> M <rows>": {...}}, "host_us": {...}}.
"""
import argparse
import json
import os
import subprocess
import sys

import chip_smoke  # this checkout's phase; the package comes from --root

VARIANTS = {"noepi": ["-DHYT_GEMM_DIAG=1"], "noload": ["-DHYT_GEMM_DIAG=2"]}


def build_int8_gemm(flags, ptxas: bool) -> None:
    """Build and load csrc/int8_gemm.cu alone with ``flags`` added; with
    ``ptxas``, print the build's seconds and each kernel's registers and
    spills."""
    from hamer_yolo_tpu_torch.ops import cuda_build

    cuda_build.set_flags("int8_gemm.cu", flags + (["-Xptxas", "-v"] if ptxas else []))
    cuda_build.load("int8_gemm.cu")
    if not ptxas:
        return
    if "int8_gemm.cu" not in cuda_build.BUILD_LOG:
        raise RuntimeError("--ptxas: int8_gemm.cu was built before, so nvcc printed nothing")
    print(f"nvcc int8_gemm.cu alone {' '.join(flags)}, -Xptxas -v: "
          f"{cuda_build.BUILD_SECONDS['int8_gemm.cu']:.1f} s")
    kernel = None
    for line in cuda_build.BUILD_LOG["int8_gemm.cu"].splitlines():
        if "Compiling entry function" in line:
            kernel = line.split("'")[1]
        elif kernel and ("registers" in line or "spill" in line):
            print(f"  {kernel[:90]}: {line.split('info    :')[-1].strip()}")


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=os.path.dirname(os.path.abspath(__file__)))
    ap.add_argument("--variant", choices=sorted(VARIANTS))
    ap.add_argument("--ptxas", action="store_true")
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
    if args.variant or args.ptxas:
        build_int8_gemm(VARIANTS.get(args.variant, []), args.ptxas)
    print(f"package {root}, variant {args.variant}", flush=True)
    dev = torch.device("cuda:0")
    times = chip_smoke.int8_gemm_alone(dev, check=False)
    host = chip_smoke.wrapper_host_us(dev)
    print(json.dumps({"root": root, "variant": args.variant,
                      "device": torch.cuda.get_device_name(0),
                      "ms": {f"{name} M {m}": r for (name, m), r in times.items()},
                      "host_us": host}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
