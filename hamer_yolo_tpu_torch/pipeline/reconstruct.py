"""OBJ reconstruction from saved npy MANO params and the overlay projection
(port of hamer_yolo_tpu/pipeline/reconstruct.py):

- reconstruct_and_save_obj: axis-angle -> rotmat -> MANO forward ->
  left-hand mirror of the model-frame x BEFORE the camera translation ->
  right hand first, then left -> one OBJ;
- project_overlay: the reference's painter's-algorithm vertex projection
  (reconstruct.py:50-86), numpy + cv2.fillPoly, no GL."""
from __future__ import annotations

from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch

from hamer_yolo_tpu_torch.geometry.rotations import aa_to_rotmat
from hamer_yolo_tpu_torch.io.writers import combine_hand_meshes, mano_faces_for_side, write_obj
from hamer_yolo_tpu_torch.models.mano import ManoModel, mano_forward_rotmat


_MANO_FROM_AA_CACHE: Dict[int, Tuple[ManoModel, Callable]] = {}


def _mano_from_aa_fn(mano_model: ManoModel) -> Callable:
    """(theta (48,), betas (10,)) -> model-frame vertices (778, 3) on the
    model's device, made once per model (JAX caches its jitted form so)."""
    hit = _MANO_FROM_AA_CACHE.get(id(mano_model))
    if hit is None or hit[0] is not mano_model:
        def fn(theta: torch.Tensor, betas: torch.Tensor) -> torch.Tensor:
            rotmats = aa_to_rotmat(theta.reshape(16, 3))[None]
            out = mano_forward_rotmat(mano_model, rotmats[:, :1], rotmats[:, 1:], betas[None])
            return out.vertices[0]

        hit = _MANO_FROM_AA_CACHE[id(mano_model)] = (mano_model, fn)
    return hit[1]


def reconstruct_hand_mesh(mano_model: ManoModel, hand: Dict[str, np.ndarray]
                          ) -> Dict[str, np.ndarray]:
    """One saved hand dict -> {'vertices', 'faces'} with the left-hand mirror."""
    dev = mano_model.v_template.device
    theta = torch.as_tensor(np.asarray(hand["theta"], np.float32), device=dev)
    betas = torch.as_tensor(np.asarray(hand["betas"], np.float32), device=dev)
    verts = _mano_from_aa_fn(mano_model)(theta, betas).cpu().numpy().copy()
    is_right = bool(hand["is_right"])
    if not is_right:
        verts[:, 0] *= -1.0  # mirror before translating: tx stays as predicted
    verts += np.asarray(hand["cam_t"], np.float32)
    return {"vertices": verts, "faces": mano_faces_for_side(mano_model.faces, is_right)}


def reconstruct_and_save_obj(mano_model: ManoModel, results: Dict[str, Optional[dict]],
                             obj_path: str) -> Optional[Dict[str, np.ndarray]]:
    """Both hands of one frame -> a single OBJ, right hand first."""
    hands = [reconstruct_hand_mesh(mano_model, results[side])
             for side in ("right", "left") if results.get(side) is not None]
    if not hands:
        return None
    mesh = combine_hand_meshes(hands)
    write_obj(obj_path, mesh["vertices"], mesh["faces"])
    return mesh


def project_overlay(image_bgr: np.ndarray, vertices: np.ndarray, faces: np.ndarray,
                    K: np.ndarray, color=(80, 200, 80)) -> np.ndarray:
    """Painter's-algorithm mesh overlay (the reference's reconstruct.py:50-86):
    the triangles filled back to front by mean depth, numpy + cv2.fillPoly."""
    import cv2

    uv = vertices @ K.T
    uv = uv[:, :2] / np.maximum(uv[:, 2:3], 1e-9)
    tri_depth = vertices[faces][..., 2].mean(axis=1)
    order = np.argsort(-tri_depth)  # far first
    out = image_bgr.copy()
    for t in uv[faces[order]].astype(np.int32):
        cv2.fillPoly(out, [t], color)
    return out
