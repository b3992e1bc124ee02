"""Host-side IO (port of hamer_yolo_tpu/io/writers.py): intrinsics, the
per-image npy MANO dicts and OBJ export.

npy schema: {'left': hand | None, 'right': hand | None}, each hand a dict
{betas (10,), theta (48,), pose_hand (45,), pose_global (3,), cam_t (3,),
is_right bool}.
"""
from __future__ import annotations

import os
from typing import Dict, List, Optional

import numpy as np

from hamer_yolo_tpu_torch.models.mano import watertight_closure_faces


def load_intrinsics(path: str) -> np.ndarray:
    """Read a 3x3 K matrix from a whitespace-separated text file."""
    return np.loadtxt(path, dtype=np.float64).reshape(3, 3).astype(np.float32)


def frame_outputs_to_hand_dicts(out: Dict[str, np.ndarray]) -> Dict[str, Optional[dict]]:
    """Masked slot arrays of one frame -> the npy schema, keeping the
    highest-scored detection per side (slots are score-sorted)."""
    results: Dict[str, Optional[dict]] = {"left": None, "right": None}
    valid = np.asarray(out["valid"])
    is_right = np.asarray(out["is_right"])
    for i in range(len(valid)):
        if not valid[i]:
            continue
        label = "right" if is_right[i] > 0.5 else "left"
        if results[label] is not None:
            continue
        results[label] = {
            "betas": np.asarray(out["betas"][i]),
            "theta": np.asarray(out["theta"][i]),
            "pose_hand": np.asarray(out["pose_hand"][i]),
            "pose_global": np.asarray(out["pose_global"][i]),
            "cam_t": np.asarray(out["cam_t"][i]),
            "is_right": label == "right",
        }
    return results


def save_hand_npy(path: str, results: Dict[str, Optional[dict]]) -> None:
    np.save(path, results)  # dict-of-dicts object array, like the reference


def load_hand_npy(path: str) -> Dict[str, Optional[dict]]:
    return np.load(path, allow_pickle=True).item()


def write_obj(path: str, vertices: np.ndarray, faces: np.ndarray) -> None:
    with open(path, "w") as f:
        f.write("# hamer_yolo_tpu_torch mesh export\n")
        for v in vertices:
            f.write(f"v {v[0]:.6f} {v[1]:.6f} {v[2]:.6f}\n")
        for face in faces + 1:  # OBJ is 1-indexed
            f.write(f"f {face[0]} {face[1]} {face[2]}\n")


def combine_hand_meshes(hands: List[Dict[str, np.ndarray]]) -> Dict[str, np.ndarray]:
    """Concatenate per-hand (vertices, faces) into one mesh."""
    all_v, all_f, offset = [], [], 0
    for h in hands:
        all_v.append(h["vertices"])
        all_f.append(h["faces"] + offset)
        offset += len(h["vertices"])
    return {"vertices": np.concatenate(all_v), "faces": np.concatenate(all_f)}


def mano_faces_for_side(faces: np.ndarray, is_right: bool) -> np.ndarray:
    """MANO_RIGHT faces, sealed and (for left hands) rewound."""
    faces = np.concatenate([faces, watertight_closure_faces()])
    if not is_right:
        faces = faces[:, [0, 2, 1]]
    return faces


def list_images(folder: str) -> List[str]:
    exts = (".jpg", ".jpeg", ".png", ".bmp")
    return sorted(os.path.join(folder, f) for f in os.listdir(folder) if f.lower().endswith(exts))
