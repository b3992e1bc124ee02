"""Parameter bootstrapping (port of hamer_yolo_tpu/core/checkpoint.py's
``init_pipeline_params``). Orbax checkpoints are not read by the port;
weights come from a seeded random init or, in the tests, from JAX
parameters through core/bridge.py."""
from __future__ import annotations

from typing import Any, Dict, Optional

import torch

from hamer_yolo_tpu_torch.models.hamer import HamerConfig, init_hamer
from hamer_yolo_tpu_torch.models.mano import ManoModel
from hamer_yolo_tpu_torch.models.sar import SarConfig, init_sar
from hamer_yolo_tpu_torch.models.yolov7.model import YoloConfig, init_yolov7


def init_pipeline_params(seed: int, mano_model: ManoModel,
                         yolo_cfg: Optional[YoloConfig] = None,
                         hamer_cfg: Optional[HamerConfig] = None,
                         sar_cfg: Optional[SarConfig] = None, with_sar: bool = True,
                         device="cuda") -> Dict[str, Any]:
    """Random-init detector, HaMeR and (``with_sar``, as JAX's default) SAR /
    RootNet parameters, drawn in that order on ``device`` (the card unless
    the caller names another) from a generator seeded with ``seed``. SAR's
    head keeps the MANO template of ``mano_model``."""
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    params = {"yolo": init_yolov7(gen, yolo_cfg or YoloConfig()),
              "hamer": init_hamer(gen, hamer_cfg or HamerConfig())}
    if with_sar:
        params["sar"] = init_sar(gen, mano_model.v_template, sar_cfg or SarConfig())
    return params
