"""Export the pipeline's programs as AOTInductor packages for the C++ runner.

Port of the root tools/export_executable.py (JAX: an AOT-compiled PJRT
executable for cpp/build/hyt_run). Each program is traced by
``torch.export`` (K1 and K2 are the operators of ops/torch_ops.py in the
graph) and compiled by AOTInductor into one package, with the weights baked
in as constants:

- <out>/<model>.pt2   the package (``torch._inductor.aoti_load_package``, or
                      the C++ runner csrc/deploy/aoti_runner.cpp, built by
                      ``hamer_yolo_tpu_torch.cpp.build_runner``)
- <out>/<model>.meta  one line per input, dtype and shape: ``f32 1,640,640,3``

The programs are JAX's three: ``yolo`` (YOLOv7, nc 3, at 640 -> NMS; boxes,
scores, classes, valid), ``hamer`` (HaMeR at 256; vertices, keypoints_3d,
cam_t) and ``frame`` (infer_frame at --hw with --max-hands slots and RootNet;
boxes, scores, valid, theta, betas, cam_t, vertices). The weights are the
seeded random init (seed 0) and the MANO model the real one where its files
are found, else the synthetic one, as in JAX's tool. The module that is
exported holds each weight as a buffer in the dtype the program reads it in
(``deploy_tree``), so that the graph casts no weight per call.

    python -m hamer_yolo_tpu_torch.tools.export_executable --out exports --model frame
"""
from __future__ import annotations

import argparse
import dataclasses
import os
import shutil
import subprocess
import sys
import tempfile
import time
from collections import defaultdict
from typing import Any, Callable, Dict, List, NamedTuple, Optional, Tuple

import torch
from torch.utils import _pytree as pytree
from torch.utils._python_dispatch import TorchDispatchMode

from hamer_yolo_tpu_torch.models.mano import ManoModel

MODELS = ("yolo", "hamer", "frame")
MANO_TENSORS = ("v_template", "shapedirs", "posedirs", "J_regressor", "weights",
                "hands_components", "hands_mean")
META_DTYPES = {torch.float32: "f32", torch.int32: "i32", torch.bfloat16: "bf16"}
# Inductor keeps the port's per-op bf16 roundings (ROADMAP F6, F8, F20) and
# its layouts: with layout optimization on, Inductor moves the convolutions
# to channels-last, where cuDNN sums in other orders (on an H100 the
# detector's boxes moved by up to 0.58 px; without it 0.0037).
INDUCTOR_CONFIGS = {"emulate_precision_casts": True, "layout_optimization": False}


class Program(NamedTuple):
    fn: Callable       # fn(params, mano, *inputs) -> tuple of tensors
    inputs: Tuple      # example inputs (zeros), in order
    outputs: Tuple     # the outputs' names, in order


def program(model: str, cfg, hw: Tuple[int, int] = (720, 1280), device="cuda") -> Program:
    """The ``model`` program of JAX's tool under the pipeline config ``cfg``
    (its detector, HaMeR and SAR configs and ``max_hands``)."""
    from hamer_yolo_tpu_torch.models.hamer import hamer_forward
    from hamer_yolo_tpu_torch.models.yolov7.model import yolov7_forward
    from hamer_yolo_tpu_torch.ops.nms import non_max_suppression
    from hamer_yolo_tpu_torch.pipeline.frame import infer_frame

    def zeros(*shape):
        return torch.zeros(shape, dtype=torch.float32, device=device)

    if model == "yolo":
        # the detector + NMS engine, NMS baked into the graph (K1)
        def fn(params, mano, img):
            pred = yolov7_forward(params["yolo"], img, cfg.yolo)
            nms = non_max_suppression(pred, 0.25, 0.35, classes=(0, 1, 2), agnostic=True,
                                      max_det=32)
            return nms.boxes, nms.scores, nms.classes, nms.valid

        return Program(fn, (zeros(1, cfg.det_size, cfg.det_size, 3),),
                       ("boxes", "scores", "classes", "valid"))
    if model == "hamer":
        def fn(params, mano, img):
            out = hamer_forward(params["hamer"], mano, img, cfg.hamer)
            return out["pred_vertices"], out["pred_keypoints_3d"], out["pred_cam_t"]

        size = cfg.hamer.image_size
        return Program(fn, (zeros(1, size, size, 3),),
                       ("pred_vertices", "pred_keypoints_3d", "pred_cam_t"))
    if model == "frame":
        names = ("boxes", "scores", "valid", "theta", "betas", "cam_t", "vertices")

        def fn(params, mano, image, orig_hw, K):
            out = infer_frame(params, mano, image, orig_hw, K, cfg)
            return tuple(out[k] for k in names)

        H, W = hw
        return Program(fn, (zeros(H, W, 3), zeros(2), zeros(3, 3)), names)
    raise ValueError(f"model {model!r}: one of {MODELS}")


def meta_lines(inputs) -> List[str]:
    """The runner's input lines: ``<dtype> <d0,d1,...>`` per input."""
    return [f"{META_DTYPES[t.dtype]} {','.join(str(d) for d in t.shape)}" for t in inputs]


def _mano_tensors(mano: ManoModel) -> Dict[str, torch.Tensor]:
    return {k: getattr(mano, k) for k in MANO_TENSORS if getattr(mano, k) is not None}


class _CastUses(TorchDispatchMode):
    """The dtypes each of ``leaves`` is read in by the ops that run: the
    target of a cast of the whole tensor, else its own dtype (None)."""

    def __init__(self, leaves: List[torch.Tensor]):
        super().__init__()
        self.leaves = leaves
        self.by_storage = {t.untyped_storage().data_ptr(): i for i, t in enumerate(leaves)
                           if t.numel()}
        self.uses: Dict[int, set] = defaultdict(set)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        for j, a in enumerate(pytree.tree_leaves((args, kwargs))):
            if not isinstance(a, torch.Tensor) or a.device.type == "meta":
                continue
            i = self.by_storage.get(a.untyped_storage().data_ptr())
            if i is None:
                continue
            leaf = self.leaves[i]
            whole = (a.shape == leaf.shape and a.stride() == leaf.stride()
                     and a.storage_offset() == leaf.storage_offset())
            cast = func is torch.ops.aten._to_copy.default and j == 0 and "dtype" in kwargs
            self.uses[i].add(kwargs["dtype"] if cast and whole else None)
        return func(*args, **kwargs)


def deploy_tree(fn: Callable, params: Any, mano: ManoModel, inputs: Tuple) -> Tuple[Any, Any]:
    """(params, MANO tensors) copied, each tensor in the one dtype that
    ``fn(params, mano, *inputs)`` reads it in, where it reads it only through
    casts to that dtype (the ViT's weights in bf16, K2's among them); any other
    tensor as it is. ``fn`` runs once, eagerly, on copies (the weight caches
    of core/nn are keyed by the tensor, so a copy casts afresh), which also
    makes core/nn's constants before the trace."""
    tree = (params, _mano_tensors(mano))
    leaves, spec = pytree.tree_flatten(tree)
    copies = [t.detach().clone() if isinstance(t, torch.Tensor) else t for t in leaves]
    tensors = [t for t in copies if isinstance(t, torch.Tensor)]
    copy_params, copy_mano = pytree.tree_unflatten(copies, spec)
    rec = _CastUses(tensors)
    with torch.no_grad(), rec:
        fn(copy_params, dataclasses.replace(mano, **copy_mano), *inputs)
    index = {id(t): i for i, t in enumerate(tensors)}
    out = []
    for t in copies:
        if isinstance(t, torch.Tensor):
            uses = rec.uses.get(index[id(t)], set())
            if len(uses) == 1 and None not in uses:
                t = t.to(next(iter(uses)))
        out.append(t)
    return pytree.tree_unflatten(out, spec)


_BUFFER = object()  # DeployModule: the place of a buffer among the tree's leaves


class DeployModule(torch.nn.Module):
    """``fn(params, mano, *inputs)`` with the tensors of ``params`` and the
    MANO model's ``mano_tensors`` held as buffers (named by their path in the
    tree)."""

    def __init__(self, fn: Callable, params: Any, mano: ManoModel,
                 mano_tensors: Dict[str, torch.Tensor]):
        super().__init__()
        self.fn, self.mano = fn, mano
        tree = (params, mano_tensors)
        leaves, self.spec = pytree.tree_flatten_with_path(tree)
        self.leaves, self.names = [], []
        for path, leaf in leaves:
            if isinstance(leaf, torch.Tensor):
                name = "_".join(str(getattr(k, "key", getattr(k, "idx", k))) for k in path)
                name = f"{len(self.names)}_{name}".replace(".", "_")
                self.register_buffer(name, leaf)
                self.names.append(name)
                leaf = _BUFFER
            self.leaves.append(leaf)

    def forward(self, *inputs):
        it = iter(getattr(self, n) for n in self.names)
        leaves = [next(it) if leaf is _BUFFER else leaf for leaf in self.leaves]
        params, mano = pytree.tree_unflatten(leaves, self.spec)
        return self.fn(params, dataclasses.replace(self.mano, **mano), *inputs)


def constant_bytes(module: torch.nn.Module) -> int:
    return sum(b.numel() * b.element_size() for b in module.buffers())


def export_program(prog: Program, params: Any, mano: ManoModel
                   ) -> Tuple[torch.export.ExportedProgram, DeployModule]:
    """``torch.export`` of ``prog`` over the weights ``params`` (K1 and K2 as
    the operators of ops/torch_ops.py), and the module it traced."""
    from hamer_yolo_tpu_torch.ops import torch_ops

    torch_ops.register()
    dparams, dmano = deploy_tree(prog.fn, params, mano, prog.inputs)
    module = DeployModule(prog.fn, dparams, mano, dmano)
    with torch.no_grad():
        ep = torch.export.export(module, prog.inputs, strict=False)
    return ep, module


def openmp_compiler() -> Optional[str]:
    """The first C++ compiler (``$CXX``, ``g++`` on the path, /usr/bin/g++)
    that links a shared object with -fopenmp, which AOTInductor passes to
    every link on Linux; None where none does (a g++ installed away from
    its GCC tree finds no libgomp.spec)."""
    with tempfile.TemporaryDirectory() as tmp:
        for cxx in dict.fromkeys(filter(None, (os.environ.get("CXX"), shutil.which("g++"),
                                               "/usr/bin/g++"))):
            res = subprocess.run([cxx, "-fopenmp", "-shared", "-fPIC", "-x", "c++", "-", "-o",
                                  os.path.join(tmp, "omp.so")], input="int f() { return 0; }\n",
                                 capture_output=True, text=True)
            if res.returncode == 0:
                return cxx
    return None


def compile_package(ep: torch.export.ExportedProgram, path: str) -> str:
    """AOTInductor compile of ``ep`` into the package ``path``, the constants
    inside its shared library (the frame program's 1.49 GB are below the 2 GB
    a shared library's data may hold), linked by a C++ compiler that links
    with -fopenmp (``openmp_compiler``); raises where none does."""
    cxx = openmp_compiler()
    if cxx is None:
        raise RuntimeError("no C++ compiler here links a shared object with -fopenmp, which "
                           "every AOTInductor link passes")
    return torch._inductor.aoti_compile_and_package(
        ep, package_path=path, inductor_configs={**INDUCTOR_CONFIGS, "cpp.cxx": (cxx,)})


def build_weights(model: str, cfg, mano: ManoModel, device, seed: int = 0) -> Dict[str, Any]:
    """The seeded random weights of ``model``: the detector, HaMeR, or the
    whole pipeline with SAR (core/checkpoint.init_pipeline_params)."""
    from hamer_yolo_tpu_torch.core.checkpoint import init_pipeline_params
    from hamer_yolo_tpu_torch.models.hamer import init_hamer
    from hamer_yolo_tpu_torch.models.yolov7.model import init_yolov7

    if model == "frame":
        return init_pipeline_params(seed, mano, cfg.yolo, cfg.hamer, cfg.sar, device=device)
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    if model == "yolo":
        return {"yolo": init_yolov7(gen, cfg.yolo)}
    return {"hamer": init_hamer(gen, cfg.hamer)}


def export(out_dir: str, model: str = "hamer", hw: str = "720x1280", max_hands: int = 4,
           device: str = "cuda") -> Dict[str, Any]:
    """Export ``model`` into ``out_dir``; returns the package's path, its
    bytes and the seconds of each step."""
    from hamer_yolo_tpu_torch.cli.main import load_mano, pipeline_config

    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("--device cuda: no CUDA device (pass --device cpu for the CPU)")
    H, W = (int(x) for x in hw.split("x"))
    cfg = pipeline_config(max_hands=max_hands)
    mano = load_mano(None, dev)
    params = build_weights(model, cfg, mano, dev)
    prog = program(model, cfg, (H, W), dev)
    os.makedirs(out_dir, exist_ok=True)
    t0 = time.perf_counter()
    ep, module = export_program(prog, params, mano)
    t_export = time.perf_counter() - t0
    nbytes = constant_bytes(module)
    del params, module
    path = os.path.join(out_dir, f"{model}.pt2")
    t0 = time.perf_counter()
    compile_package(ep, path)
    t_compile = time.perf_counter() - t0
    with open(os.path.join(out_dir, f"{model}.meta"), "w") as f:
        f.write("\n".join(meta_lines(prog.inputs)) + "\n")
    size = os.path.getsize(path)
    print(f"exported {model}: {size} bytes ({nbytes} bytes of constants) -> {out_dir}/; "
          f"export {t_export:.1f} s, AOTInductor compile {t_compile:.1f} s")
    print(f"run: $(python -c 'from hamer_yolo_tpu_torch import cpp; print(cpp.build_runner())') "
          f"{out_dir}/{model}.pt2 {out_dir}/{model}.meta")
    return {"path": path, "bytes": size, "constant_bytes": nbytes, "export_s": t_export,
            "compile_s": t_compile}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--out", default="exports")
    p.add_argument("--model", default="hamer", choices=MODELS)
    p.add_argument("--hw", default="720x1280")
    p.add_argument("--max-hands", type=int, default=4)
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    a = p.parse_args(argv)
    export(a.out, a.model, a.hw, a.max_hands, a.device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
