"""HaMeR evaluation: MPJPE / PA-MPJPE / MPVPE over predictions (port of
tools/eval_hamer.py; the reference's Evaluator wiring,
hamer/hamer/utils/pose_utils.py:89-225). Two modes:

  npy  two dirs of per-image .npy hand dicts (``infer``'s outputs against a
       reference capture): the largest theta / betas / cam_t differences and
       the MPVPE of the meshes (MANO from each hand's theta and betas, plus
       its cam_t), which passes under ``--mpvpe-mm``;
  npz  joints (and vertices) arrays saved as npz, prediction against truth.

  python -m hamer_yolo_tpu_torch.tools.eval_hamer npy --pred out/ --ref ref_out/ [--device cuda]
  python -m hamer_yolo_tpu_torch.tools.eval_hamer npz --pred pred.npz --ref gt.npz

JAX's npy mode hands cam_t to its two-argument MANO function and raises a
TypeError; the port adds cam_t to the model-frame vertices, which is what
that call means.
"""
from __future__ import annotations

import argparse
import os
from typing import Optional

import numpy as np


def cmd_npy(args) -> int:
    import torch

    from hamer_yolo_tpu_torch.cli.main import load_mano
    from hamer_yolo_tpu_torch.io.writers import load_hand_npy
    from hamer_yolo_tpu_torch.pipeline.reconstruct import _mano_from_aa_fn
    from hamer_yolo_tpu_torch.utils.metrics import Evaluator, mpvpe

    device = torch.device(args.device)
    mano = load_mano(None, device)
    mano_fn = _mano_from_aa_fn(mano)

    def mesh(hand):
        def t(k):
            return torch.as_tensor(np.asarray(hand[k], np.float32), device=device)

        with torch.inference_mode():
            return (mano_fn(t("theta"), t("betas")) + t("cam_t")).cpu().numpy()

    ev = Evaluator()
    param_diffs = {"theta": [], "betas": [], "cam_t": []}
    n = 0
    for f in sorted(os.listdir(args.pred)):
        if not f.endswith(".npy"):
            continue
        ref_path = os.path.join(args.ref, f)
        if not os.path.exists(ref_path):
            continue
        pred = load_hand_npy(os.path.join(args.pred, f))
        ref = load_hand_npy(ref_path)
        for side in ("left", "right"):
            p, r = pred.get(side), ref.get(side)
            if p is None or r is None:
                continue
            for k in param_diffs:
                param_diffs[k].append(np.abs(p[k] - r[k]).max())
            ev.mpvpe_all.append(mpvpe(mesh(p)[None], mesh(r)[None]))
            n += 1
    if n == 0:
        print("no overlapping hands found")
        return 1
    mm = float(np.concatenate(ev.mpvpe_all).mean() * 1000.0)
    print(f"hands compared: {n}")
    for k, v in param_diffs.items():
        print(f"max |d{k}|: {np.max(v):.5f}")
    print(f"MPVPE: {mm:.3f} mm  ({'PASS' if mm < args.mpvpe_mm else 'FAIL'} "
          f"@ {args.mpvpe_mm} mm)")
    return 0 if mm < args.mpvpe_mm else 1


def cmd_npz(args) -> int:
    from hamer_yolo_tpu_torch.utils.metrics import Evaluator

    pred = np.load(args.pred)
    ref = np.load(args.ref)
    ev = Evaluator()
    ev.update(pred["joints"], ref["joints"], pred.get("vertices"), ref.get("vertices"))
    for k, v in ev.results().items():
        print(f"{k}: {v:.3f}")
    return 0


def main(argv: Optional[list] = None) -> int:
    p = argparse.ArgumentParser(prog="eval_hamer")
    sub = p.add_subparsers(dest="cmd", required=True)
    a = sub.add_parser("npy")
    a.add_argument("--pred", required=True)
    a.add_argument("--ref", required=True)
    a.add_argument("--mpvpe-mm", type=float, default=1.0)
    a.add_argument("--device", default="cuda",
                   help="torch device of the MANO forward (default: the card)")
    a.set_defaults(fn=cmd_npy)
    b = sub.add_parser("npz")
    b.add_argument("--pred", required=True)
    b.add_argument("--ref", required=True)
    b.set_defaults(fn=cmd_npz)
    args = p.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    raise SystemExit(main())
