"""K1 and K2 as operators of PyTorch's dispatcher: ``hyt_port::greedy_nms_keep_mask``
and ``hyt_port::fused_bf16_attn_block``.

The eager wrappers (ops/nms.greedy_nms_keep_mask, ops/attn_block.
fused_bf16_attn_block) launch their kernels through ctypes on data pointers.
``torch.export`` traces with tensors that have no data, and a C++ process has
no Python to make a ctypes call, so a traced program reaches the kernels
through these operators instead: the wrappers call them whenever
``torch.compiler.is_compiling()``. Where a card is present, ``register``
builds ``csrc/torch_ops.cpp`` with g++ against torch and the kernel libraries
of ops/cuda_build.py and loads it: it defines the schemas and the CUDA
implementations, which launch the same C entry points as the wrappers. With
no card the schemas are defined from here. Either way the fakes (shapes and
dtypes) and the CPU implementations (the plain versions) are registered from
here. ``SCHEMAS`` is the one place in Python that holds the schema strings;
a test holds them to the ``.cpp``. Launch counters count on the eager path
only: a traced program's launches are counted by kernel name.
"""
from __future__ import annotations

from pathlib import Path
from typing import List, Optional

import torch

from hamer_yolo_tpu_torch.ops import cuda_build

NAMESPACE = "hyt_port"
SCHEMAS = {
    "greedy_nms_keep_mask": "greedy_nms_keep_mask(Tensor boxes, Tensor active, float iou_thres) "
                            "-> Tensor",
    "fused_bf16_attn_block": "fused_bf16_attn_block(Tensor tok, Tensor w, Tensor? bias, "
                             "Tensor ln_scale, Tensor ln_bias, int num_heads) -> Tensor",
}
SOURCE = cuda_build.CSRC_DIR / "torch_ops.cpp"
KERNEL_SOURCES = ("nms.cu", "attn_block.cu", "short_attention.cu")  # the entry points it calls

_LIBRARIES: List[torch.library.Library] = []  # kept alive: dropping one unregisters it
ROUTE: Optional[str] = None  # "library" (the .cpp loaded) or "python" (schemas from here)


def torch_args() -> List[str]:
    """g++ arguments that compile and link against the installed torch."""
    from torch.utils import cpp_extension

    args = ["-std=c++20", "-O2", "-fPIC",
            f"-D_GLIBCXX_USE_CXX11_ABI={int(torch._C._GLIBCXX_USE_CXX11_ABI)}"]
    args += [f"-I{p}" for p in cpp_extension.include_paths()]
    for p in cpp_extension.library_paths():
        args += [f"-L{p}", f"-Wl,-rpath,{p}"]
    return args


def _build_args(build: bool = False) -> List[str]:
    path = cuda_build.ensure_built if build else cuda_build.library_path
    return ["-shared", *torch_args(), str(SOURCE), "-lc10", "-ltorch_cpu", "-ltorch",
            f"-L{cuda_build.BUILD_DIR}", *[f"-l:{path(s).name}" for s in KERNEL_SOURCES],
            "-Wl,-rpath,$ORIGIN"]


def library_path() -> Path:
    """The operator library's path (built or not): keyed by its source, the
    kernel libraries it links and the installed torch."""
    return cuda_build.gxx_path("torch_ops", _build_args(), [SOURCE], extra=torch.__version__)


def build() -> Path:
    """Build (or find) the operator library, the kernel libraries it links
    first; a failed build raises with the compiler's stderr."""
    return cuda_build.gxx_build("torch_ops", _build_args(build=True), [SOURCE],
                                extra=torch.__version__)


def register() -> str:
    """Make ``torch.ops.hyt_port.*`` callable in this process, once; returns
    the route taken ("library" or "python")."""
    global ROUTE
    if ROUTE is not None:
        return ROUTE
    if torch.cuda.is_available():
        torch.ops.load_library(str(build()))
        lib = torch.library.Library(NAMESPACE, "IMPL")
        route = "library"
    else:
        lib = torch.library.Library(NAMESPACE, "DEF")
        for schema in SCHEMAS.values():
            lib.define(schema)
        route = "python"
    _LIBRARIES.append(lib)
    lib.impl("greedy_nms_keep_mask", _nms_cpu, "CPU")
    lib.impl("fused_bf16_attn_block", _attn_cpu, "CPU")
    torch.library.register_fake(f"{NAMESPACE}::greedy_nms_keep_mask", _nms_fake, lib=lib)
    torch.library.register_fake(f"{NAMESPACE}::fused_bf16_attn_block", _attn_fake, lib=lib)
    ROUTE = route
    return route


def _nms_cpu(boxes, active, iou_thres):
    from hamer_yolo_tpu_torch.ops.nms import greedy_nms_keep_ref

    return greedy_nms_keep_ref(boxes, active, iou_thres) > 0.5


def _nms_fake(boxes, active, iou_thres):
    return torch.empty(active.shape, dtype=torch.bool, device=active.device)


def _attn_cpu(tok, w, bias, ln_scale, ln_bias, num_heads):
    from hamer_yolo_tpu_torch.ops.attn_block import fused_bf16_attn_block_ref

    return fused_bf16_attn_block_ref(tok, w, bias, ln_scale, ln_bias, num_heads)


def _attn_fake(tok, w, bias, ln_scale, ln_bias, num_heads):
    B, N, _ = tok.shape
    return torch.empty((B, N, w.shape[1] // 3), dtype=tok.dtype, device=tok.device)


def greedy_nms_keep_mask(boxes: torch.Tensor, active: torch.Tensor,
                         iou_thres: float) -> torch.Tensor:
    """K1's operator: keep (B, K) bool of score-sorted boxes (B, K, 4) f32,
    active (B, K) bool."""
    register()
    return torch.ops.hyt_port.greedy_nms_keep_mask(boxes, active, float(iou_thres))


def fused_bf16_attn_block(tok: torch.Tensor, w: torch.Tensor, bias: Optional[torch.Tensor],
                          ln_scale: torch.Tensor, ln_bias: torch.Tensor,
                          num_heads: int) -> torch.Tensor:
    """K2's operator: tok (B, N, K), w (K, 3D), bias (3D,), LN scale and
    bias (K,) -> (B, N, D) in tok's dtype."""
    register()
    return torch.ops.hyt_port.fused_bf16_attn_block(tok, w, bias, ln_scale, ln_bias,
                                                    int(num_heads))
