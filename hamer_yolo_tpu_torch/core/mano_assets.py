"""MANO asset loading (port of hamer_yolo_tpu/core/mano_assets.py):
chumpy-free pkl parsing, the npz cache under assets/, and the seeded
synthetic MANO-shaped model used when no asset is available.

Fields: v_template (778, 3), shapedirs (778, 3, 10), posedirs (778, 3, 135),
J_regressor (16, 778), weights (778, 16), f (1538, 3) int32,
kintree_parents (16,) int32, hands_components (45, 45), hands_mean (45,).
"""
from __future__ import annotations

import io
import os
import pickle
from typing import Dict, Optional

import numpy as np

ASSETS_DIR = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))), "assets")


class _ChumpyStub:
    """Stand-in for chumpy.Ch while unpickling: keeps the wrapped array."""

    def __init__(self, *args, **kwargs):
        self._data = args[0] if args else None

    def __setstate__(self, state):
        if isinstance(state, dict):
            self.__dict__.update(state)
        else:
            self._data = state


def _to_numpy(obj) -> np.ndarray:
    if isinstance(obj, np.ndarray):
        return obj
    if hasattr(obj, "toarray"):  # scipy sparse
        return np.asarray(obj.toarray())
    if isinstance(obj, _ChumpyStub):
        d = obj.__dict__
        for key in ("x", "_data", "a"):  # chumpy keeps the base array in .x
            if key in d:
                return _to_numpy(d[key])
        for v in d.values():
            if isinstance(v, np.ndarray) and v.size > 1:
                return v
        raise ValueError(f"cannot extract array from chumpy stub with keys {list(d)}")
    return np.asarray(obj)


class _ManoUnpickler(pickle.Unpickler):
    def find_class(self, module, name):
        if module.startswith("chumpy"):
            return _ChumpyStub
        return super().find_class(module, name)


def load_mano_pkl(path: str) -> Dict[str, np.ndarray]:
    """Parse an official MANO pkl into plain float32/int32 arrays."""
    with open(path, "rb") as f:
        raw = _ManoUnpickler(io.BytesIO(f.read()), encoding="latin1").load()
    out: Dict[str, np.ndarray] = {}
    for key in ("v_template", "shapedirs", "posedirs", "weights", "hands_mean",
                "hands_components", "hands_coeffs", "betas"):
        if key in raw:
            out[key] = _to_numpy(raw[key]).astype(np.float32)
    out["J_regressor"] = _to_numpy(raw["J_regressor"]).astype(np.float32)
    out["f"] = _to_numpy(raw["f"]).astype(np.int32)
    parents = _to_numpy(raw["kintree_table"]).astype(np.int64)[0].copy()
    parents[0] = -1  # root sentinel (the pkl stores 2**32 - 1)
    out["kintree_parents"] = parents.astype(np.int32)
    out.setdefault("betas", np.zeros(10, np.float32))
    return out


def load_mano_model(side: str = "right", mano_dir: Optional[str] = None) -> Dict[str, np.ndarray]:
    """The npz cache under assets/ if present, else MANO_<SIDE>.pkl from mano_dir."""
    if side not in ("right", "left"):
        raise ValueError(side)
    cache = os.path.join(ASSETS_DIR, f"mano_{side}.npz")
    if os.path.exists(cache):
        with np.load(cache) as z:
            return {k: z[k] for k in z.files}
    if mano_dir is None:
        raise FileNotFoundError(f"no {cache} and no MANO dir given")
    return load_mano_pkl(os.path.join(mano_dir, f"MANO_{side.upper()}.pkl"))


def synthetic_mano_model(seed: int = 0) -> Dict[str, np.ndarray]:
    """Random MANO-shaped asset with the real kinematic tree; byte-identical
    to the JAX package's for the same seed (same numpy draws in order)."""
    rng = np.random.default_rng(seed)
    V, J = 778, 16
    parents = np.array([-1, 0, 1, 2, 0, 4, 5, 0, 7, 8, 0, 10, 11, 0, 13, 14], np.int32)
    v_template = rng.normal(scale=0.03, size=(V, 3)).astype(np.float32)
    weights = rng.dirichlet(np.ones(J) * 0.1, size=V).astype(np.float32)
    J_regressor = rng.dirichlet(np.ones(V) * 0.05, size=J).astype(np.float32)
    return {
        "v_template": v_template,
        "shapedirs": rng.normal(scale=1e-3, size=(V, 3, 10)).astype(np.float32),
        "posedirs": rng.normal(scale=1e-4, size=(V, 3, 135)).astype(np.float32),
        "J_regressor": J_regressor,
        "weights": weights,
        "f": rng.integers(0, V, size=(1538, 3)).astype(np.int32),
        "kintree_parents": parents,
        "hands_components": rng.normal(size=(45, 45)).astype(np.float32),
        "hands_mean": rng.normal(scale=0.1, size=(45,)).astype(np.float32),
        "betas": np.zeros(10, np.float32),
    }
