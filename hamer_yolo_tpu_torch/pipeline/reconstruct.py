"""OBJ reconstruction from saved npy MANO params (port of
hamer_yolo_tpu/pipeline/reconstruct.py:reconstruct_and_save_obj):
axis-angle -> rotmat -> MANO forward -> left-hand mirror of the model-frame
x BEFORE the camera translation -> right hand first, then left -> one OBJ."""
from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from hamer_yolo_tpu_torch.geometry.rotations import aa_to_rotmat
from hamer_yolo_tpu_torch.io.writers import combine_hand_meshes, mano_faces_for_side, write_obj
from hamer_yolo_tpu_torch.models.mano import ManoModel, mano_forward_rotmat


def reconstruct_hand_mesh(mano_model: ManoModel, hand: Dict[str, np.ndarray]
                          ) -> Dict[str, np.ndarray]:
    """One saved hand dict -> {'vertices', 'faces'} with the left-hand mirror."""
    dev = mano_model.v_template.device
    theta = torch.as_tensor(np.asarray(hand["theta"], np.float32), device=dev)
    betas = torch.as_tensor(np.asarray(hand["betas"], np.float32), device=dev)
    rotmats = aa_to_rotmat(theta.reshape(16, 3))[None]
    verts = mano_forward_rotmat(mano_model, rotmats[:, :1], rotmats[:, 1:], betas[None])
    verts = verts.vertices[0].cpu().numpy().copy()
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
