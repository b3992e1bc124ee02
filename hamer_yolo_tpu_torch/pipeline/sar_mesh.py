"""The mask-driven box of hamer_yolo_tpu/pipeline/sar_mesh.py. Only
``bbox_from_mask`` is ported; the SAR mesh recovery around it waits in
ROADMAP.md, Queue 1 item 9."""
from __future__ import annotations

from typing import List, Optional

import numpy as np


def bbox_from_mask(mask, target_val: int = 3) -> Optional[List[float]]:
    """The reference's get_bbox_from_npy: (H, W) mask -> [x1, y1, x2, y2] of
    the pixels equal to ``target_val`` (inclusive pixel bounds), or None."""
    rows, cols = np.where(np.asarray(mask) == target_val)
    if len(rows) == 0:
        return None
    return [float(cols.min()), float(rows.min()), float(cols.max()), float(rows.max())]
