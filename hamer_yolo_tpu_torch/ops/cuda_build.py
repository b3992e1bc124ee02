"""Build and load the port's hand-written CUDA kernels (csrc/*.cu).

Each source is compiled by ``nvcc`` into its own shared library with a plain
C interface and loaded with ``ctypes``. Nothing is built at import: the first
call that launches a kernel builds it, into ``_build/`` beside this package
(listed in ``.gitignore``), under a name keyed by a hash of the source, the
shared headers ``csrc/*.cuh`` and the flags. A file lock keeps
concurrent processes from building the same library twice. ``set_flags``
adds nvcc flags to one source for the rest of the process (the diagnostic
builds of chip_gemm.py: ``-D`` macros, ``-Xptxas -v``). ``gxx_build`` builds
host code the same way with ``g++`` (the operator library of
ops/torch_ops.py, the host library and the runner of cpp/).
"""
from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import shutil
import subprocess
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import Dict, List

import torch

_PKG = Path(__file__).resolve().parent.parent
CSRC_DIR = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
MAX_SMEM = 232448  # bytes of shared memory one H100 block may use

_COMMON_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
                 "-shared", "-Xcompiler", "-fPIC"]
# nms.cu must not contract its IoU arithmetic into FMAs (bit-exact keep sets),
# nor int8_gemm.cu its prologue and dequant arithmetic (the int8 roundings).
_EXTRA_FLAGS: Dict[str, List[str]] = {"nms.cu": ["--fmad=false"], "attn_block.cu": [],
                                      "int8_gemm.cu": ["--fmad=false"],
                                      "short_attention.cu": [], "mano_lbs.cu": [],
                                      "attention_flavours.cu": []}

_P, _I, _F, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_float, ctypes.c_longlong
# C signatures of every exported function, per source.
_SIGNATURES = {
    "nms.cu": {"hyt_nms_keep": [_P, _P, _F, _P, _I, _I, _I, _P],
               "hyt_nms_floor": [_I, _I, _I, _P]},
    "attn_block.cu": {
        "hyt_k2_weight_map": [_P, _I, _I, _P],
        "hyt_ln_qkv": [_P, _I, _P, _P, _P, _P, _P, _P, _I, _I, _I, _P],
    },
    "int8_gemm.cu": {
        "hyt_quantize_rows": [_P, _I, _P, _P, _I, _I, _I, _I, _P, _I, _P, _P, _P],
        "hyt_weight_map": [_P, _I, _I, _P],
        "hyt_int8_gemm": [_P, _P, _I, _I, _I, _I, _I, _P, _P, _P, _P, _P, _P, _I, _P, _P],
        "hyt_mlp_block1": [_P, _I] + [_P] * 10 + [_I] * 5 + [_P, _P],
    },
    "mano_lbs.cu": {"hyt_mano_lbs": [_P] * 11 + [_I, _I, _I, _P]},
    "short_attention.cu": {
        "hyt_short_attention": [_P, _P, _P, _I, _L, _L, _L, _P, _I, _P, _L, _L, _L, _I, _I,
                                _I, _I, _F, _P],
        "hyt_fused_qkv_attention": [_P, _I, _P, _I, _P, _I, _I, _I, _I, _F, _P],
        "hyt_short_attn_smem_bytes": [_I, _I, _I],
        "hyt_short_attn_occupancy": [_I, _I, _I, _P, _P],
    },
    "attention_flavours.cu": {
        "hyt_attention_flavour": [_P, _P, _P, _L, _L, _L, _P, _P, _L, _L, _L, _I, _I, _I, _I,
                                  _F, _I, _P],
        "hyt_attention_int8": [_P, _P, _P, _L, _L, _L, _P, _P, _L, _L, _L, _I, _I, _I, _I,
                               _F, _I, _P, _P, _P],
        "hyt_quantize_heads": [_P, _P, _P, _L, _L, _L, _I, _I, _I, _I, _P, _P, _P],
    },
}

_LOADED: Dict[str, ctypes.CDLL] = {}
_ADDED_FLAGS: Dict[str, List[str]] = {}  # set_flags
BUILD_SECONDS: Dict[str, float] = {}  # wall time of each nvcc or g++ this process ran
BUILD_LOG: Dict[str, str] = {}  # and its stderr


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels build only where the "
                           "CUDA toolkit is installed")
    return path


def _flags(source: str) -> List[str]:
    return [*_COMMON_FLAGS, *_EXTRA_FLAGS[source], *_ADDED_FLAGS.get(source, [])]


def set_flags(source: str, flags: List[str]) -> None:
    """Build and load ``csrc/<source>`` with the nvcc ``flags`` added, from
    the next ``load`` on, for the rest of this process."""
    _ADDED_FLAGS[source] = list(flags)
    _LOADED.pop(source, None)


def library_path(source: str) -> Path:
    flags = _flags(source)
    text = (CSRC_DIR / source).read_bytes() + b"".join(
        h.read_bytes() for h in sorted(CSRC_DIR.glob("*.cuh")))
    digest = hashlib.sha256(text + " ".join(flags).encode()).hexdigest()[:16]
    return BUILD_DIR / f"{Path(source).stem}-{digest}.so"


def _build(source: str, out: Path) -> None:
    _locked_build(source, Path(source).stem, out,
                  lambda tmp: [_nvcc(), *_flags(source), "-o", tmp, str(CSRC_DIR / source)])


def _locked_build(name: str, stem: str, out: Path, command) -> None:
    """Run ``command(tmp)`` under the file lock of ``stem`` unless ``out``
    exists (another process built it meanwhile), then move tmp to ``out``;
    raise with the compiler's stderr if it fails."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with open(BUILD_DIR / f".{stem}.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        try:
            if out.exists():
                return
            tmp = out.with_name(f"{out.stem}.tmp{os.getpid()}{out.suffix}")
            cmd = command(str(tmp))
            t0 = time.perf_counter()
            res = subprocess.run(cmd, capture_output=True, text=True)
            BUILD_SECONDS[name], BUILD_LOG[name] = time.perf_counter() - t0, res.stderr
            if res.returncode != 0:
                raise RuntimeError(f"{Path(cmd[0]).name} failed for {name}:\n{res.stderr}")
            os.replace(tmp, out)
        finally:
            fcntl.flock(lock, fcntl.LOCK_UN)


def gxx_path(stem: str, args: List[str], inputs: List[Path], suffix: str = ".so",
             extra: str = "") -> Path:
    """Where ``gxx_build`` puts what it builds from these arguments."""
    text = b"".join(Path(p).read_bytes() for p in inputs)
    digest = hashlib.sha256(text + " ".join([*args, extra]).encode()).hexdigest()[:16]
    return BUILD_DIR / f"{stem}-{digest}{suffix}"


def gxx_build(stem: str, args: List[str], inputs: List[Path], suffix: str = ".so",
              extra: str = "") -> Path:
    """``g++ <args> -o BUILD_DIR/<stem>-<hash><suffix>``, unless built
    already: the hash covers the bytes of ``inputs`` (sources and headers),
    the arguments and ``extra``, and a file lock keeps concurrent processes
    from building it twice. A failed build raises with g++'s stderr."""
    out = gxx_path(stem, args, inputs, suffix, extra)
    if not out.exists():
        _locked_build(stem, stem, out, lambda tmp: ["g++", *args, "-o", tmp])
    return out


def ensure_built(source: str) -> Path:
    """The path of ``csrc/<source>``'s library, built first if needed (not
    loaded: the operator library of ops/torch_ops.py links it)."""
    path = library_path(source)
    if not path.exists():
        _build(source, path)
    return path


def load(source: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<source>``, built first if needed."""
    lib = _LOADED.get(source)
    if lib is not None:
        return lib
    lib = ctypes.CDLL(str(ensure_built(source)))
    for name, argtypes in _SIGNATURES[source].items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    _LOADED[source] = lib
    return lib


def build_all() -> List[Path]:
    """Build (or find) and load every kernel library, one nvcc per source,
    all started together; returns their paths."""
    with ThreadPoolExecutor(len(_SIGNATURES)) as pool:
        list(pool.map(load, _SIGNATURES))
    return [library_path(s) for s in _SIGNATURES]


def aligned16(t):
    """``t`` contiguous and 16-byte aligned: the kernels read 16-byte vectors,
    and a view into another tensor may start at any element."""
    t = t.contiguous()
    return t.clone() if t.data_ptr() % 16 else t


def refuse_grad(what: str, *tensors) -> None:
    """Raise a ``ValueError`` naming the kernel ``what`` where autograd would
    track the call: grad mode on and an input that requires grad. A kernel
    writes its output through a raw pointer and has no backward, so its
    result would carry no gradient and a train step would drop every one
    behind it without a word. Checked on every device, the CPU included, and
    nothing falls back to a plain version: train steps run the plain layers
    by their configuration (training/)."""
    if torch.is_grad_enabled() and any(isinstance(t, torch.Tensor) and t.requires_grad
                                       for t in tensors):
        raise ValueError(f"{what}: an input requires grad, and the kernel has no backward; "
                         "call it under torch.no_grad() or run the plain layers")


def check(rc: int, what: str) -> None:
    """Raise on a non-zero cudaError_t returned by a launch."""
    if rc != 0:
        raise RuntimeError(f"{what}: CUDA error {rc}")
