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


def load_pipeline(checkpoint: str | None = None, mano_dir: str | None = None,
                  max_hands: int = 4, device="cuda", **config_overrides):
    """One-call pipeline constructor (the torch.hub / hubconf equivalent).

    Returns (program, params, mano_model, cfg): ``program(image_bgr, K)``
    runs one frame (numpy in, a dict of per-slot numpy outputs out,
    pipeline/frame.infer_frame), as a captured CUDA graph per bucket on the
    card (pipeline/runner.FrameProgram, what ``infer`` runs). The weights are
    the port's ``.npz`` checkpoint where ``checkpoint`` names a file, else
    the seeded init (seed 0); MANO is the synthetic model where its assets
    are missing. ``config_overrides``: PipelineConfig fields, a nested
    config as a mapping (core/config.apply_overrides). ``device``: the card unless the caller
    names another.

        import hamer_yolo_tpu_torch, numpy as np
        program, *_ = hamer_yolo_tpu_torch.load_pipeline()
        out = program(frame_bgr.astype(np.float32), K)
    """
    import os

    from hamer_yolo_tpu_torch.core.checkpoint import init_pipeline_params, load_checkpoint
    from hamer_yolo_tpu_torch.core.config import apply_overrides
    from hamer_yolo_tpu_torch.core.mano_assets import load_mano_model, synthetic_mano_model
    from hamer_yolo_tpu_torch.models.mano import ManoModel
    from hamer_yolo_tpu_torch.pipeline.frame import PipelineConfig
    from hamer_yolo_tpu_torch.pipeline.runner import FrameProgram

    try:
        mano = ManoModel.from_arrays(load_mano_model("right", mano_dir), device)
    except Exception:
        mano = ManoModel.from_arrays(synthetic_mano_model(), device)
    cfg = PipelineConfig(max_hands=max_hands)
    if config_overrides:
        cfg = apply_overrides(cfg, config_overrides)
    if checkpoint and os.path.exists(checkpoint):
        params = load_checkpoint(checkpoint, device)
    else:
        params = init_pipeline_params(0, mano, cfg.yolo, cfg.hamer, cfg.sar, device=device)
    return FrameProgram(params, mano, cfg, device), params, mano, cfg
