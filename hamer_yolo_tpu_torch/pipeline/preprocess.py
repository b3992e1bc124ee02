"""On-device preprocessing: letterbox, HaMeR crops and SAR patches (port of
hamer_yolo_tpu/pipeline/preprocess.py). The raw frame is uploaded once,
padded to a bucket shape; every view the models need is produced from it
on the device by the banded-matmul warps of ops/warp_matmul.py."""
from __future__ import annotations

from typing import Tuple

import torch

from hamer_yolo_tpu_torch.core import nn
from hamer_yolo_tpu_torch.ops import warp_matmul

IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)


def device_letterbox(img: torch.Tensor, orig_hw: torch.Tensor, out_size: int = 640
                     ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """img (B, Hb, Wb, 3) bucket-padded raw frames, orig_hw (B, 2) actual
    (h, w) -> (letterboxed (B, S, S, 3), gain (B,), pad (B, 2))."""
    return warp_matmul.letterbox_matmul(img, orig_hw, out_size)


def normalize_imagenet(patch_rgb01: torch.Tensor) -> torch.Tensor:
    dtype, dev = patch_rgb01.dtype, patch_rgb01.device
    return (patch_rgb01 - nn.constant(IMAGENET_MEAN, dtype, dev)) / nn.constant(IMAGENET_STD,
                                                                                dtype, dev)


def crop_square_patch(img: torch.Tensor, center: torch.Tensor, size_wh: torch.Tensor,
                      out_hw: Tuple[int, int]) -> torch.Tensor:
    """One frame's crop of a (w, h) box centred at ``center``: img (H, W, 3),
    center (2,), size_wh (2,) -> (out_h, out_w, 3), gen_trans_from_patch +
    warpAffine's geometry (scale 1, no rotation) and uint8 rounding, through
    the banded-matmul warp as JAX's default ``WARP_IMPL = "matmul"``."""
    return warp_matmul.crop_square_matmul(img[None], center[None, None], size_wh[None, None],
                                          out_hw)[0, 0]


def hamer_crop(img_bgr: torch.Tensor, center: torch.Tensor, size: torch.Tensor,
               do_flip: torch.Tensor, out_size: int = 256) -> torch.Tensor:
    """HaMeR inputs for every slot of every frame: img_bgr (B, H, W, 3),
    center (B, S, 2), size (B, S), do_flip (B, S) -> (B, S, o, o, 3):
    square crop -> BGR->RGB -> lr-flip left hands -> ImageNet normalise."""
    patch = warp_matmul.crop_square_matmul(img_bgr, center, torch.stack([size, size], dim=-1),
                                           (out_size, out_size))
    patch = patch.flip(-1)  # BGR -> RGB
    patch = torch.where(do_flip[..., None, None, None] > 0.5, patch.flip(-2), patch)
    return normalize_imagenet(patch / 255.0)


def sar_patch(img_bgr: torch.Tensor, bbox_xywh: torch.Tensor, out_size: int = 256
              ) -> torch.Tensor:
    """SAR / RootNet inputs for every slot of every frame: img_bgr (B, H, W,
    3), processed boxes bbox_xywh (B, S, 4) -> (B, S, o, o, 3): crop of the
    (w, h) box -> BGR->RGB -> ImageNet normalise (no flip in the depth path)."""
    center = bbox_xywh[..., 0:2] + 0.5 * bbox_xywh[..., 2:4]
    patch = warp_matmul.crop_square_matmul(img_bgr, center, bbox_xywh[..., 2:4],
                                           (out_size, out_size))
    return normalize_imagenet(patch.flip(-1) / 255.0)
