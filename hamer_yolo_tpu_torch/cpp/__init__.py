"""ctypes bindings for the native host library, and the C++ runner's build.

Port of hamer_yolo_tpu/cpp/__init__.py. The host library is built from the
repository's shared, backend-free sources cpp/src/image_ops.cpp and
cpp/src/nms.cpp (C API in cpp/include/hyt.h) by ``g++`` into
``hamer_yolo_tpu_torch/_build/`` (listed in .gitignore), with a file lock
and a hash of the sources, as ops/cuda_build.py builds the kernels; cmake and
ninja are not needed and cpp/build/ is not written. A failed build raises
with the compiler's stderr. ``build_runner`` builds the C++ runner of the
port's AOTInductor packages, csrc/deploy/aoti_runner.cpp, against the
installed torch; it links this library and loads the operator library of
ops/torch_ops.py at start.
"""
from __future__ import annotations

import ctypes
from pathlib import Path
from typing import Optional, Tuple

import numpy as np

from hamer_yolo_tpu_torch.ops import cuda_build

CPP_DIR = Path(__file__).resolve().parents[2] / "cpp"
HOST_SOURCES = (CPP_DIR / "src" / "image_ops.cpp", CPP_DIR / "src" / "nms.cpp")
HEADER = CPP_DIR / "include" / "hyt.h"
RUNNER_SOURCE = cuda_build.CSRC_DIR / "deploy" / "aoti_runner.cpp"
# cpp/CMakeLists.txt's build of the same sources: C++17 with GNU extensions,
# its Release flags, position-independent code
HOST_FLAGS = ["-std=gnu++17", "-O3", "-DNDEBUG", "-fPIC", "-shared"]

_lib: Optional[ctypes.CDLL] = None


def build_library() -> Path:
    """Build (or find) libhyt_host and return its path."""
    args = [*HOST_FLAGS, f"-I{HEADER.parent}", *map(str, HOST_SOURCES)]
    return cuda_build.gxx_build("libhyt_host", args, [*HOST_SOURCES, HEADER])


def load_library() -> ctypes.CDLL:
    global _lib
    if _lib is not None:
        return _lib
    lib = ctypes.CDLL(str(build_library()))
    f32p = ctypes.POINTER(ctypes.c_float)
    u8p = ctypes.POINTER(ctypes.c_uint8)
    lib.hyt_letterbox.argtypes = [u8p, ctypes.c_int, ctypes.c_int, ctypes.c_int, f32p, f32p,
                                  f32p, f32p]
    lib.hyt_letterbox.restype = None
    lib.hyt_crop_bilinear.argtypes = [f32p, ctypes.c_int, ctypes.c_int, ctypes.c_float,
                                      ctypes.c_float, ctypes.c_float, ctypes.c_int, f32p]
    lib.hyt_crop_bilinear.restype = None
    lib.hyt_normalize.argtypes = [f32p, ctypes.c_int, ctypes.c_int, f32p, f32p]
    lib.hyt_normalize.restype = None
    lib.hyt_nms.argtypes = [f32p, ctypes.c_int, ctypes.c_int, ctypes.c_float, ctypes.c_float,
                            ctypes.c_int, ctypes.c_int, f32p]
    lib.hyt_nms.restype = ctypes.c_int
    _lib = lib
    return lib


def available() -> bool:
    """True once the library is built and loaded (a failed build raises)."""
    return load_library() is not None


def _fp(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_float))


def letterbox(img_u8: np.ndarray, out_size: int = 640
              ) -> Tuple[np.ndarray, float, Tuple[float, float]]:
    """HWC uint8 -> (out_size, out_size, 3) f32 letterbox (pad 114), the
    gain r and the half-pads (dw, dh)."""
    lib = load_library()
    h, w = img_u8.shape[:2]
    img_u8 = np.ascontiguousarray(img_u8, np.uint8)
    out = np.empty((out_size, out_size, 3), np.float32)
    r, dw, dh = ctypes.c_float(), ctypes.c_float(), ctypes.c_float()
    lib.hyt_letterbox(img_u8.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), h, w, out_size,
                      _fp(out), ctypes.byref(r), ctypes.byref(dw), ctypes.byref(dh))
    return out, float(r.value), (float(dw.value), float(dh.value))


def crop_bilinear(img_f32: np.ndarray, cx: float, cy: float, size: float,
                  out_size: int) -> np.ndarray:
    """Square bilinear crop of side ``size`` centred at (cx, cy), zero border."""
    lib = load_library()
    h, w = img_f32.shape[:2]
    img_f32 = np.ascontiguousarray(img_f32, np.float32)
    out = np.empty((out_size, out_size, 3), np.float32)
    lib.hyt_crop_bilinear(_fp(img_f32), h, w, cx, cy, size, out_size, _fp(out))
    return out


def normalize(img_f32: np.ndarray, mean, std) -> np.ndarray:
    """Per-channel (x - 255 mean) / (255 std) over HWC f32, in place where
    ``img_f32`` is contiguous f32."""
    lib = load_library()
    img = np.ascontiguousarray(img_f32, np.float32)
    mean = np.asarray(mean, np.float32)
    std = np.asarray(std, np.float32)
    lib.hyt_normalize(_fp(img), img.shape[0], img.shape[1], _fp(mean), _fp(std))
    return img


def nms(pred: np.ndarray, conf_thres: float = 0.25, iou_thres: float = 0.45,
        agnostic: bool = False, max_det: int = 300) -> np.ndarray:
    """pred: (N, 5+nc) decoded rows -> (kept, 6) [x1 y1 x2 y2 score cls]."""
    lib = load_library()
    pred = np.ascontiguousarray(pred, np.float32)
    n, no = pred.shape
    out = np.empty((max_det, 6), np.float32)
    kept = lib.hyt_nms(_fp(pred), n, no - 5, conf_thres, iou_thres, int(agnostic), max_det,
                       _fp(out))
    return out[:kept]


def build_runner() -> Path:
    """Build (or find) the C++ runner of AOTInductor packages
    (csrc/deploy/aoti_runner.cpp) with g++ against the installed torch and
    libhyt_host; returns its path. It loads the operator library at
    ``ops/torch_ops.library_path()`` when it starts (built there by
    ``torch_ops.build()``, which the export tool runs)."""
    import torch
    from torch.utils import cpp_extension

    from hamer_yolo_tpu_torch.ops import torch_ops

    host = build_library()
    libs = ["-ltorch", "-ltorch_cpu", "-lc10"]
    if any((Path(p) / "libtorch_cuda.so").exists() for p in cpp_extension.library_paths()):
        # the CUDA runner of packages registers itself when libtorch_cuda loads
        libs = ["-Wl,--no-as-needed", "-ltorch_cuda", "-lc10_cuda", "-Wl,--as-needed", *libs]
    args = [*torch_ops.torch_args(), f"-I{HEADER.parent}",
            f'-DHYT_OPS_LIBRARY="{torch_ops.library_path()}"', str(RUNNER_SOURCE),
            f"-L{host.parent}", f"-l:{host.name}", "-Wl,-rpath,$ORIGIN", *libs, "-ldl"]
    return cuda_build.gxx_build("aoti_runner", args, [RUNNER_SOURCE, HEADER], suffix="",
                                extra=torch.__version__)
