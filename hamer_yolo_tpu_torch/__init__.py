"""hamer_yolo_tpu_torch: the PyTorch + CUDA port of hamer_yolo_tpu.

YOLOv7 hand detection -> HaMeR ViT-H MANO regression -> MANO mesh export,
written for an NVIDIA H100. The layout mirrors hamer_yolo_tpu (core,
geometry, ops, models, pipeline, io, cli); every TPU kernel on the ported
path has a hand-written CUDA counterpart under csrc/, with a plain PyTorch
twin beside its wrapper. This package imports torch and never jax.
"""
import torch as _torch

# Geometry and the banded-matmul warps are f32 and must stay f32: no TF32
# in matmuls or cuDNN convolutions.
_torch.backends.cuda.matmul.allow_tf32 = False
_torch.backends.cudnn.allow_tf32 = False

__version__ = "0.1.0"
