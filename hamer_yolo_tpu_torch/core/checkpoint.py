"""Parameter bootstrapping (port of hamer_yolo_tpu/core/checkpoint.py's
``init_pipeline_params`` without the RootNet branch). Orbax checkpoints are
not read by the port; weights come from a seeded random init or, in the
tests, from JAX parameters through core/bridge.py."""
from __future__ import annotations

from typing import Any, Dict, Optional

import torch

from hamer_yolo_tpu_torch.models.hamer import HamerConfig, init_hamer
from hamer_yolo_tpu_torch.models.yolov7.model import YoloConfig, init_yolov7


def init_pipeline_params(seed: int = 0, yolo_cfg: Optional[YoloConfig] = None,
                         hamer_cfg: Optional[HamerConfig] = None,
                         device="cuda") -> Dict[str, Any]:
    """Random-init detector and HaMeR parameters, drawn on ``device`` (the
    card unless the caller names another) from a generator seeded with
    ``seed``."""
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    return {"yolo": init_yolov7(gen, yolo_cfg or YoloConfig()),
            "hamer": init_hamer(gen, hamer_cfg or HamerConfig())}
