"""The exact-bf16 frame pipeline on tensors (port of
hamer_yolo_tpu/pipeline/frame.py):

  raw frames (bucket-padded) -> device letterbox -> YOLOv7 -> NMS (K1)
    -> S fixed, masked hand slots -> RootNet depth (SAR patches, ResNet-34)
    -> HaMeR crops -> ViT-H (K2 on CUDA) -> MANO head -> MANO LBS -> flip
    corrections -> camera lift with the real intrinsics (tz forced to the
    RootNet depth under ``use_depth_refine``) -> full-image projection ->
    npy-schema fields.

Every stage runs over a batch dimension: the detector over frames, the
RootNet and HaMeR stages over all B*S slots at once (the flat formulation
the JAX tests pin equal to the per-frame vmap), the epilogue over crops.
RootNet runs whenever ``"sar"`` is in the params (or ``use_depth_refine``
asks for it), as in JAX. JAX's ``HYT_STAGE_BATCH_HAMER=1`` (all B*S crops
through one hamer_forward instead of a per-frame vmap) is therefore what
this module always computes: the switch is accepted and changes nothing.
``infer_frames_tracked`` is the detector-skip form: boxes from the previous
tick's keypoints, the same outputs after them.
"""
from __future__ import annotations

import functools
import os
from dataclasses import dataclass, field
from typing import Dict, Optional, Tuple

import torch

from hamer_yolo_tpu_torch.core import nn
from hamer_yolo_tpu_torch.geometry.boxes import (hamer_box_params, process_bbox, scale_coords,
                                                 track_boxes_from_keypoints)
from hamer_yolo_tpu_torch.geometry.camera import (calculate_k_value, custom_cam_crop_to_full,
                                                  project_with_intrinsics)
from hamer_yolo_tpu_torch.geometry.flip import correct_pred_cam, flip_keypoints3d
from hamer_yolo_tpu_torch.geometry.rotations import rotmat_to_aa
from hamer_yolo_tpu_torch.models.hamer import HamerConfig, hamer_forward
from hamer_yolo_tpu_torch.models.mano import ManoModel
from hamer_yolo_tpu_torch.models.sar import SarConfig, estimate_root_depth
from hamer_yolo_tpu_torch.models.vit import bf16_kernel_default
from hamer_yolo_tpu_torch.models.yolov7.model import YoloConfig, yolov7_forward
from hamer_yolo_tpu_torch.models.yolov7.tta import yolov7_forward_tta
from hamer_yolo_tpu_torch.ops.nms import non_max_suppression
from hamer_yolo_tpu_torch.ops.short_attention import fast_mha_self_attention
from hamer_yolo_tpu_torch.pipeline.preprocess import device_letterbox, hamer_crop, sar_patch

Tensors = Dict[str, torch.Tensor]


@dataclass(frozen=True)
class PipelineConfig:
    max_hands: int = 4
    det_size: int = 640
    conf_thres: float = 0.25
    iou_thres: float = 0.35
    classes: Tuple[int, ...] = (0, 1, 2)
    agnostic_nms: bool = True
    max_nms_static: int = 512
    right_class: int = 1  # cls == 1 -> right hand
    crop_size: int = 256
    use_depth_refine: bool = False  # tz forced to RootNet's depth (infer --depth-refine)
    tta: bool = False  # the detector's 3-scale + flip TTA (detect --augment; models/yolov7/tta.py)
    yolo: YoloConfig = field(default_factory=lambda: YoloConfig(nc=3))
    hamer: HamerConfig = field(default_factory=HamerConfig)
    sar: SarConfig = field(default_factory=SarConfig)


def detect_hands_batched(yolo_params: nn.Params, images_bgr: torch.Tensor,
                         orig_hws: torch.Tensor, cfg: PipelineConfig) -> Tensors:
    """Detector over a frame batch: images_bgr (B, Hb, Wb, 3) f32 0..255,
    orig_hws (B, 2) -> per-slot boxes (B, S, 4) xyxy in the original frame,
    scores, is_right, classes and valid (B, S). Under ``cfg.tta`` the
    detector runs its TTA branches on the whole batch (JAX maps the one-frame
    detector over the frames: the same arithmetic per frame)."""
    lb, gain, pad = device_letterbox(images_bgr, orig_hws, cfg.det_size)
    forward = yolov7_forward_tta if cfg.tta else yolov7_forward
    pred = forward(yolo_params, lb.flip(-1) / 255.0, cfg.yolo)  # BGR -> RGB in [0, 1]
    nms = non_max_suppression(pred, conf_thres=cfg.conf_thres, iou_thres=cfg.iou_thres,
                              classes=cfg.classes, agnostic=cfg.agnostic_nms,
                              max_det=cfg.max_hands, max_nms_static=cfg.max_nms_static)
    boxes = torch.round(scale_coords(nms.boxes, gain, pad, orig_hws))  # detector rounds
    return {"boxes": boxes, "scores": nms.scores,
            "is_right": (nms.classes == cfg.right_class).to(torch.float32),
            "classes": nms.classes, "valid": nms.valid}


def detect_hands(yolo_params: nn.Params, image_bgr: torch.Tensor, orig_hw: torch.Tensor,
                 cfg: PipelineConfig) -> Tensors:
    """One frame (Hb, Wb, 3), orig_hw (2,) -> per-slot detections (S, ...)."""
    dets = detect_hands_batched(yolo_params, image_bgr[None], orig_hw[None], cfg)
    return {k: v[0] for k, v in dets.items()}


def _select_attn_impl(cfg: PipelineConfig, crops: torch.Tensor, attn_impl=None):
    """The attention the frame hands hamer_forward (JAX's
    _select_attn_impl): ``attn_impl`` where the caller gives one; none for
    the int8 backbone (core/quant picks its own) or where the bf16 ViT takes
    K2 (models/vit.bf16_kernel_default: on the card, or HYT_ATTN_BF16 =
    megakernel); else fast_mha_self_attention in the form HYT_ATTN names.
    HYT_ATTN unset or "xla" is the einsum, which nn.mha_self_attention
    computes: none is handed over then, and the ViT takes its own."""
    if attn_impl is not None or cfg.hamer.int8_backbone:
        return attn_impl
    force = os.environ.get("HYT_ATTN", "xla")
    if force == "xla" or bf16_kernel_default(crops, cfg.hamer.vit):
        return None
    return functools.partial(fast_mha_self_attention, force=force)


def recover_hands(hamer_params: nn.Params, mano_model: ManoModel, images_bgr: torch.Tensor,
                  dets: Tensors, Ks: torch.Tensor, cfg: PipelineConfig,
                  depth_refine: Optional[torch.Tensor] = None, attn_impl=None) -> Tensors:
    """HaMeR stage over all B*S hand slots in one batch: images_bgr
    (B, Hb, Wb, 3), dets (B, S, ...), Ks (B, 3, 3), depth_refine (B, S) or
    None -> per-crop outputs flattened to (B*S, ...). ``attn_impl`` as in
    hamer_forward (None: _select_attn_impl's choice)."""
    B, S = dets["valid"].shape
    do_flip = 1.0 - dets["is_right"]  # left hands are flipped
    center, size = hamer_box_params(dets["boxes"])
    crops = hamer_crop(images_bgr, center, size, do_flip, cfg.crop_size)
    out = hamer_forward(hamer_params, mano_model, crops.reshape(B * S, *crops.shape[2:]),
                        cfg.hamer, attn_impl=_select_attn_impl(cfg, crops, attn_impl))
    do_flip, center, size = do_flip.reshape(-1), center.reshape(-1, 2), size.reshape(-1)
    K = Ks.repeat_interleave(S, dim=0)
    fx, fy, cx, cy = K[:, 0, 0], K[:, 1, 1], K[:, 0, 2], K[:, 1, 2]
    kp3d = flip_keypoints3d(out["pred_keypoints_3d"], do_flip)
    pred_cam = correct_pred_cam(out["pred_cam"], do_flip)
    cam_t_full = custom_cam_crop_to_full(
        pred_cam, center, size, fx, fy, cx, cy,
        depth_refine=None if depth_refine is None else depth_refine.reshape(-1))
    kp2d_full = project_with_intrinsics(kp3d + cam_t_full[:, None], fx, fy, cx, cy)
    return {
        "pred_cam": pred_cam,
        "pred_cam_t_full": cam_t_full,
        "pred_keypoints_3d": kp3d,
        "pred_keypoints_2d_full": kp2d_full,
        "pred_vertices": out["pred_vertices"],
        "global_orient": out["pred_mano_params"]["global_orient"],
        "hand_pose": out["pred_mano_params"]["hand_pose"],
        "betas": out["pred_mano_params"]["betas"],
    }


def estimate_depths(sar_params: nn.Params, images_bgr: torch.Tensor, dets: Tensors,
                    orig_hws: torch.Tensor, Ks: torch.Tensor, cfg: PipelineConfig
                    ) -> torch.Tensor:
    """RootNet stage over all B*S slots in one batch: images_bgr
    (B, Hb, Wb, 3), dets (B, S, ...), orig_hws (B, 2), Ks (B, 3, 3) -> the
    absolute root depth of each slot (B, S). A masked slot's zero box gives a
    finite value (the k value's area is clamped)."""
    B, S = dets["valid"].shape
    b = dets["boxes"]
    xywh = torch.stack([b[..., 0], b[..., 1], b[..., 2] - b[..., 0], b[..., 3] - b[..., 1]],
                       dim=-1)
    size = float(cfg.sar.input_size)
    pb, _ = process_bbox(xywh, orig_hws[:, 1:2], orig_hws[:, 0:1], (size, size), 1.5)
    patches = sar_patch(images_bgr, pb, cfg.sar.input_size)
    k_val = calculate_k_value(pb[..., 2:4], Ks[:, 0:1, 0], Ks[:, 1:2, 1],
                              real_area=cfg.sar.bbox_real[0] * cfg.sar.bbox_real[1])
    depth = estimate_root_depth(sar_params, patches.reshape(B * S, *patches.shape[2:]),
                                k_val.reshape(-1), cfg.sar)
    return depth.reshape(B, S)


def _npy_fields(dets: Tensors, rec: Tensors, depth: Optional[torch.Tensor]) -> Tensors:
    """Save-side axis-angle conversion and the npy-schema dict, (B, S, ...);
    ``root_depth`` where RootNet ran."""
    B, S = dets["valid"].shape
    global_aa = rotmat_to_aa(rec["global_orient"][:, 0])            # (B*S, 3)
    hand_aa = rotmat_to_aa(rec["hand_pose"]).reshape(B * S, -1)     # (B*S, 45)
    flat = {
        "betas": rec["betas"],
        "theta": torch.cat([global_aa, hand_aa], dim=-1),
        "pose_hand": hand_aa,
        "pose_global": global_aa,
        "cam_t": rec["pred_cam_t_full"],
        "pred_cam": rec["pred_cam"],
        "keypoints_3d": rec["pred_keypoints_3d"],
        "keypoints_2d": rec["pred_keypoints_2d_full"],
        "vertices": rec["pred_vertices"],
    }
    out = {**dets, **{k: v.reshape(B, S, *v.shape[1:]) for k, v in flat.items()}}
    if depth is not None:
        out["root_depth"] = depth
    return out


def _infer_from_dets(params: nn.Params, mano_model: ManoModel, images_bgr: torch.Tensor,
                     dets: Tensors, orig_hws: torch.Tensor, Ks: torch.Tensor,
                     cfg: PipelineConfig, run_depth: bool) -> Tensors:
    """Everything after the detector over a frame batch: RootNet depth
    (where ``run_depth``) -> HaMeR -> npy-schema fields (B, S, ...); the
    lift is refined by the depth under ``use_depth_refine``."""
    depth = None
    if run_depth:
        depth = estimate_depths(params["sar"], images_bgr, dets, orig_hws, Ks, cfg)
    refine = depth if cfg.use_depth_refine else None
    rec = recover_hands(params["hamer"], mano_model, images_bgr, dets, Ks, cfg, refine)
    return _npy_fields(dets, rec, depth)


def infer_frames(params: nn.Params, mano_model: ManoModel, images_bgr: torch.Tensor,
                 orig_hws: torch.Tensor, Ks: torch.Tensor, cfg: PipelineConfig) -> Tensors:
    """The full program over a frame batch: images_bgr (B, Hb, Wb, 3) f32
    raw BGR 0..255 (bucket-padded), orig_hws (B, 2), Ks (B, 3, 3) ->
    per-slot outputs (B, S, ...) with the npy-schema fields as masked arrays.
    JAX's conditions: depth runs under ``use_depth_refine`` or with "sar" in
    the params, and refines the lift only under ``use_depth_refine``."""
    dets = detect_hands_batched(params["yolo"], images_bgr, orig_hws, cfg)
    return _infer_from_dets(params, mano_model, images_bgr, dets, orig_hws, Ks, cfg,
                            cfg.use_depth_refine or "sar" in params)


def infer_frame(params: nn.Params, mano_model: ManoModel, image_bgr: torch.Tensor,
                orig_hw: torch.Tensor, K: torch.Tensor, cfg: PipelineConfig) -> Tensors:
    """One frame: image_bgr (Hb, Wb, 3), orig_hw (2,), K (3, 3) -> (S, ...)."""
    out = infer_frames(params, mano_model, image_bgr[None], orig_hw[None], K[None], cfg)
    return {k: v[0] for k, v in out.items()}


def infer_frames_tracked(params: nn.Params, mano_model: ManoModel, images_bgr: torch.Tensor,
                         prev_kp2d: torch.Tensor, prev_is_right: torch.Tensor,
                         prev_valid: torch.Tensor, orig_hws: torch.Tensor, Ks: torch.Tensor,
                         cfg: PipelineConfig, track_expand: float = 1.3,
                         track_min_size: float = 32.0) -> Tensors:
    """The detector-skip program over a frame batch: each slot's box is
    ``track_boxes_from_keypoints`` of the previous tick's ``keypoints_2d``
    (prev_kp2d (B, S, 21, 2)), the detector does not run. prev_is_right and
    prev_valid (B, S) carry over; ``scores`` is the validity mask and
    ``classes`` is ``cfg.right_class`` where is_right > 0.5, else 0 (the
    raw class id is not recoverable). The key set and shapes are those of
    ``infer_frames``, so that serving can stitch detected and tracked
    sub-batches tick by tick."""
    boxes = track_boxes_from_keypoints(prev_kp2d, prev_valid, orig_hws, expand=track_expand,
                                       min_size=track_min_size)
    dets = {"boxes": boxes, "scores": prev_valid.to(torch.float32),
            "is_right": prev_is_right.to(torch.float32),
            "classes": torch.where(prev_is_right > 0.5, cfg.right_class, 0).to(torch.int32),
            "valid": prev_valid.to(torch.bool)}
    return _infer_from_dets(params, mano_model, images_bgr, dets, orig_hws, Ks, cfg,
                            cfg.use_depth_refine or "sar" in params)


def infer_frame_with_boxes(params: nn.Params, mano_model: ManoModel, image_bgr: torch.Tensor,
                           boxes: torch.Tensor, is_right: torch.Tensor, box_valid: torch.Tensor,
                           orig_hw: torch.Tensor, K: torch.Tensor, cfg: PipelineConfig
                           ) -> Tensors:
    """The pipeline with the boxes given, the detector bypassed (the
    reference's mask-driven process_batch_manopara_with_mask): boxes (S, 4)
    xyxy, is_right and box_valid (S,) -> (S, ...). JAX's form: depth runs
    only with "sar" in the params, and the outputs have no classes and no
    pred_cam."""
    dets = {"boxes": boxes[None], "scores": box_valid.to(torch.float32)[None],
            "is_right": is_right.to(torch.float32)[None], "valid": box_valid.to(torch.bool)[None]}
    out = _infer_from_dets(params, mano_model, image_bgr[None], dets, orig_hw[None], K[None],
                           cfg, "sar" in params)
    return {k: v[0] for k, v in out.items() if k != "pred_cam"}
