#!/usr/bin/env python3
"""K3's attention step under the int8 products (HYT_ATTN_MATH=int8) on the
card: the quantize pre-pass and the attention launch of
csrc/attention_flavours.cu.

Unless --time-only: builds the source with ``-Xptxas -v`` and prints each
int8 kernel's registers and spills; then, at the attention shapes of
tests/test_torch_cuda.py and a few more (N = 1 to 2048, hd 8 to 128), holds
the pre-pass's scales and tiles to quantize_heads_ref bit for bit and the
step to flavoured_attention_ref within attn_proj_block's step limit, under
both softmaxes. Always: the device ms of the step (a CUDA graph of 20
launches), of the pre-pass alone and of K7's bf16 kernel with the int8
epilogue on the same heads at ViT-H's (16, 16, 192, 80) and at 432 tokens,
beside the step's bytes bound, with the card's name and power limit.

    python3 chip_int8_attention.py [--time-only] [--root DIR]

--root DIR imports the port from DIR (another checkout's tree), to time two
versions in turns within one machine. Needs a CUDA card. Seeded inputs.
"""
import os
import re
import subprocess
import sys
import time

import numpy as np
import torch

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = sys.argv[sys.argv.index("--root") + 1] if "--root" in sys.argv else HERE
TIME_ONLY = "--time-only" in sys.argv
sys.path.insert(0, HERE)
import chip_smoke as cs  # noqa: E402  (its timing and bound helpers)
sys.path.insert(0, os.path.abspath(ROOT))
from hamer_yolo_tpu_torch.ops import attn_proj_block as apb  # noqa: E402
from hamer_yolo_tpu_torch.ops import cuda_build  # noqa: E402
from hamer_yolo_tpu_torch.ops import short_attention as sa  # noqa: E402

# (B, h, N, hd, mult): q and k scaled by mult so that the max decides
SHAPES = {"vith": (16, 16, 192, 80, 1), "tiny": (3, 4, 12, 16, 1), "ragged": (2, 3, 70, 24, 1),
          "n1": (2, 2, 1, 64, 1), "n64": (2, 2, 64, 64, 1), "n65": (2, 2, 65, 64, 1),
          "n255_hd16": (2, 2, 255, 16, 1), "n256_hd128": (2, 2, 256, 128, 1),
          "vith_x8": (16, 16, 192, 80, 8), "n257": (2, 2, 257, 64, 1),
          "n320_hd80": (2, 2, 320, 80, 1), "n432": (16, 16, 432, 80, 1),
          "n577_hd128": (2, 2, 577, 128, 1), "n1024_hd16": (2, 2, 1024, 16, 1),
          "n577_hd80_x8": (3, 2, 577, 80, 8), "n2048_hd128": (1, 2, 2048, 128, 1),
          "hd8": (2, 2, 100, 8, 1), "hd40": (2, 2, 300, 40, 1)}
SX = 0.011  # the static proj scale of the checks


def heads(B, h, N, hd, mult, seed, dev):
    rng = np.random.default_rng(seed)
    qkv = rng.normal(size=(B, N, 3, h, hd)).astype(np.float32)
    qkv[:, :, :2] *= mult
    qkv = torch.from_numpy(qkv).to(dev).to(torch.bfloat16)
    return qkv, [qkv[:, :, i].transpose(1, 2) for i in range(3)]


def check(dev) -> int:
    """The pre-pass and the step at SHAPES; returns the failures."""
    fails = 0
    sx = torch.tensor(SX, device=dev)
    for name, (B, h, N, hd, mult) in SHAPES.items():
        qkv, (q, k, v) = heads(B, h, N, hd, mult, N, dev)
        got, ref = sa.quantize_heads(q, k, v), sa.quantize_heads_ref(q, k, v)
        equal = [bool(torch.equal(a, b)) for a, b in zip(got, ref)]
        steps = apb.int8_products_steps(qkv.reshape(B * N, -1), B, h, sx)
        for softmax in ("exp", "exp2"):
            before = sa.int8_products_attention.launches
            out = sa.int8_products_attention(q, k, v, sx, softmax)
            torch.cuda.synchronize()
            d = (out.int() - sa.flavoured_attention_ref(q, k, v, sx, softmax, "int8").int()).abs()
            ok = (all(equal) and float(d.max()) <= steps and float((d > 0).float().mean()) <= 0.01
                  and sa.int8_products_attention.launches == before + 1)
            fails += not ok
            print(f"{name} {softmax}: pre-pass bit-equal {equal}; step max {int(d.max())} int8 "
                  f"steps on {float((d > 0).float().mean()):.2e} of elements (limit {steps}) "
                  f"{'OK' if ok else 'FAIL'}", flush=True)
    return fails


def timing(dev, smi) -> None:
    lib = cuda_build.load("attention_flavours.cu")
    sx = torch.tensor(SX, device=dev)
    for N in (192, 432):
        B, h, hd = 16, 16, 80
        _, (q, k, v) = heads(B, h, N, hd, 1, N, dev)
        tiles, scales = sa._int8_scratch(B, h, N, hd, dev)
        st = q.stride()

        def prepass():
            lib.hyt_quantize_heads(q.data_ptr(), k.data_ptr(), v.data_ptr(), st[0], st[1], st[2],
                                   B, h, N, hd, tiles.data_ptr(), scales.data_ptr(),
                                   torch.cuda.current_stream().cuda_stream)
        step = cs.graph_time_ms(lambda: sa.int8_products_attention(q, k, v, sx))
        pre = cs.graph_time_ms(prepass)
        k7 = cs.graph_time_ms(lambda: sa.fused_short_attention(q, k, v, out_scale=sx))
        bound_ms = cs.bound(4 * B * N * h * hd * 2 - B * N * h * hd, {})[0]
        print(f"[{ROOT}] ({B}, {h}, {N}, {hd}): step {step:.4f} ms (pre-pass {pre:.4f}), K7 with "
              f"the int8 epilogue {k7:.4f}, bytes bound {bound_ms:.4f} ms on {smi}", flush=True)


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_int8_attention: no CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    print(smi, flush=True)
    fails = 0
    if not TIME_ONLY:
        cuda_build.set_flags("attention_flavours.cu", ["-Xptxas", "-v"])
        t0 = time.perf_counter()
        cuda_build.load("attention_flavours.cu")
        print(f"build {time.perf_counter() - t0:.1f} s", flush=True)
        lines = cuda_build.BUILD_LOG.get("attention_flavours.cu", "").splitlines()
        for i, line in enumerate(lines):
            name = re.search(r"(attention_int8\w*kernel|quantize_heads_kernel)\w*", line)
            if name and "Compiling entry" in line:
                info = " ".join(lines[i + 1:i + 5])
                regs = re.search(r"Used (\d+) registers", info)
                spill = re.search(r"(\d+) bytes spill stores", info)
                print(f"{name.group(0)}: {regs and regs.group(1)} registers, "
                      f"{spill and spill.group(1)} bytes spilled")
        fails = check(dev)
    timing(dev, smi)
    print(f"chip_int8_attention: {fails} failed")
    return 1 if fails else 0


if __name__ == "__main__":
    sys.exit(main())
