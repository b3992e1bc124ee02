"""Parameters: a seeded random init (port of hamer_yolo_tpu/core/checkpoint.py's
``init_pipeline_params``) and the port's checkpoint file.

The JAX package keeps orbax checkpoint directories; the port keeps one
``.npz`` file of numpy leaves in JAX layout (HWIO convs, (in, out)
linears), each keyed by its path in the tree ("yolo/layers/0/conv/w"), and
the tree's skeleton as JSON under ``__tree__``, so None layers, list
positions and dict keys come back as they were. Loading maps the leaves
through ``core/bridge.from_jax_params`` onto the requested device.

``save_checkpoint`` takes any tree whose leaves ``np.asarray`` accepts:
numpy arrays, CPU tensors, or jax arrays, which it reads without importing
jax. An orbax checkpoint so becomes a port checkpoint on a host with jax and
orbax: ``save_checkpoint("params.npz", load_checkpoint("ckpt_dir"))`` with
the JAX package's own ``load_checkpoint`` (hamer_yolo_tpu/core/checkpoint.py;
README.md gives the two lines). The reference's torch files become one
through ``core/convert``.
"""
from __future__ import annotations

import json
import os
import re
from typing import Any, Dict, Optional

import numpy as np
import torch

from hamer_yolo_tpu_torch.core.bridge import from_jax_params
from hamer_yolo_tpu_torch.models.hamer import HamerConfig, init_hamer
from hamer_yolo_tpu_torch.models.mano import ManoModel
from hamer_yolo_tpu_torch.models.sar import SarConfig, init_sar
from hamer_yolo_tpu_torch.models.yolov7.model import YoloConfig, init_yolov7

TREE_KEY = "__tree__"


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


def save_checkpoint(path: str, tree: Any) -> None:
    """Write ``tree`` (nested dicts and lists, None for parameter-free
    layers, leaves anything ``np.asarray`` takes) to the ``.npz`` file
    ``path``, uncompressed."""
    leaves: Dict[str, np.ndarray] = {}

    def skeleton(node, path):
        if node is None:
            return None
        if isinstance(node, dict):
            return {str(k): skeleton(v, path + (str(k),)) for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            return [skeleton(v, path + (str(i),)) for i, v in enumerate(node)]
        key = "/".join(path)
        leaves[key] = np.asarray(node)
        return key

    tree_json = json.dumps(skeleton(tree, ()))
    with open(path, "wb") as f:
        np.savez(f, **{TREE_KEY: np.array(tree_json)}, **leaves)


def read_checkpoint(path: str) -> Any:
    """The tree of numpy leaves a ``save_checkpoint`` file holds."""
    with np.load(path, allow_pickle=False) as data:
        def fill(node):
            if node is None:
                return None
            if isinstance(node, dict):
                return {k: fill(v) for k, v in node.items()}
            if isinstance(node, list):
                return [fill(v) for v in node]
            return data[node]

        return fill(json.loads(str(data[TREE_KEY])))


def load_checkpoint(path: str, device="cuda") -> Any:
    """The port's parameters from a ``save_checkpoint`` file, on ``device``
    (the card unless the caller names another). A leaf the bridge has no
    rule for raises ``KeyError``."""
    return from_jax_params(read_checkpoint(path), device)


def latest_checkpoint(run_dir: str) -> Optional[str]:
    """The checkpoint a run resumes from (JAX's rule over the port's files):
    ``ckpt_final.npz`` in ``run_dir`` wins, else the ``ckpt_<step>.npz`` of
    the highest step; None where there is none."""
    if not os.path.isdir(run_dir):
        return None
    final = os.path.join(run_dir, "ckpt_final.npz")
    if os.path.isfile(final):
        return final
    steps = [(int(m.group(1)), name) for name in os.listdir(run_dir)
             if (m := re.fullmatch(r"ckpt_(\d+)\.npz", name))]
    return os.path.join(run_dir, max(steps)[1]) if steps else None
