"""On-device preprocessing (banded-matmul letterbox and HaMeR crops) and the
f32 geometry of the slice, against the JAX package on the same inputs."""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from hamer_yolo_tpu.pipeline import preprocess as jpre
from hamer_yolo_tpu_torch.pipeline import preprocess as tpre

torch.set_num_threads(1)


def _frame(rng, h, w, bucket):
    img = np.zeros(bucket + (3,), np.float32)
    img[:h, :w] = rng.integers(0, 256, (h, w, 3))
    return img


@pytest.mark.parametrize("h,w,bucket,size", [
    (97, 131, (128, 160), 64),    # odd landscape
    (150, 90, (160, 96), 64),     # portrait
    (120, 160, (120, 160), 96),   # exact bucket, mod-32 pad on one side
])
def test_device_letterbox_matches_jax(h, w, bucket, size):
    rng = np.random.default_rng(h)
    img = _frame(rng, h, w, bucket)
    hw = np.array([h, w], np.float32)
    ref, rg, rp = jpre.device_letterbox(jnp.asarray(img), jnp.asarray(hw), size)
    got, gg, gp = tpre.device_letterbox(torch.from_numpy(img)[None], torch.from_numpy(hw)[None],
                                        size)
    np.testing.assert_array_equal(gg.numpy()[0], np.asarray(rg))
    np.testing.assert_array_equal(gp.numpy()[0], np.asarray(rp))
    # Outputs are snapped to integers; an f32 product-sum order difference
    # can only move a value that sits on a .5 boundary, by one level.
    d = np.abs(got.numpy()[0] - np.asarray(ref))
    assert d.max() <= 1.0 and (d > 0).mean() < 1e-3


@pytest.mark.parametrize("h,w", [(97, 131), (150, 90)])
def test_hamer_crop_matches_jax(h, w):
    rng = np.random.default_rng(w)
    img = _frame(rng, h, w, (160, 160))
    S = 4
    center = rng.uniform(0, [w, h], (S, 2)).astype(np.float32)
    size = rng.uniform(10, 200, S).astype(np.float32)
    flip = np.array([0, 1, 0, 1], np.float32)
    ref = jax.vmap(lambda c, s, f: jpre.hamer_crop(jnp.asarray(img), c, s, f, 64))(
        jnp.asarray(center), jnp.asarray(size), jnp.asarray(flip))
    got = tpre.hamer_crop(torch.from_numpy(img)[None], torch.from_numpy(center)[None],
                          torch.from_numpy(size)[None], torch.from_numpy(flip)[None], 64)[0]
    # Source coords sit on cv2's 1/128 grid and the bilinear products of
    # 8-bit pixels are exact in f32, so the crops agree to f32 rounding of
    # the normalisation.
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-6, atol=1e-5)


def _geometry_cases():
    from hamer_yolo_tpu.geometry import boxes as jb, camera as jc, rotations as jr
    from hamer_yolo_tpu.geometry.affine import letterbox_geometry_traced as jlb
    from hamer_yolo_tpu.geometry.flip import correct_pred_cam as jcc, flip_keypoints3d as jfk
    from hamer_yolo_tpu_torch.geometry import boxes as tb, camera as tc, rotations as tr
    from hamer_yolo_tpu_torch.geometry.affine import letterbox_geometry_traced as tlb
    from hamer_yolo_tpu_torch.geometry.flip import correct_pred_cam as tcc, flip_keypoints3d as tfk

    r = np.random.default_rng(11)
    f = lambda *s: r.normal(size=s).astype(np.float32)  # noqa: E731
    xyxy = np.sort(r.uniform(0, 300, (6, 2, 2)), axis=1).transpose(0, 2, 1).reshape(6, 4)
    xyxy = xyxy[:, [0, 2, 1, 3]].astype(np.float32)
    rot = np.asarray(jr.aa_to_rotmat(jnp.asarray(f(8, 3) * 1.5)))
    near_pi = np.asarray(jr.aa_to_rotmat(jnp.asarray(np.float32([[3.1, 0.2, -0.1]]))))
    flip = np.float32([0, 1, 1, 0, 1, 0])
    K = np.float32([900, 880, 300, 200])
    cam = np.abs(f(6, 3)) + 0.5
    return {
        "aa_to_rotmat": (jr.aa_to_rotmat, tr.aa_to_rotmat, (f(8, 3),)),
        "rot6d_to_rotmat": (jr.rot6d_to_rotmat, tr.rot6d_to_rotmat, (f(8, 6),)),
        "rotmat_to_aa": (jr.rotmat_to_aa, tr.rotmat_to_aa,
                         (np.concatenate([rot, near_pi, np.eye(3, dtype=np.float32)[None]]),)),
        "xywh2xyxy": (jb.xywh2xyxy, tb.xywh2xyxy, (np.abs(f(6, 4)) * 50,)),
        "box_iou": (jb.box_iou, tb.box_iou, (xyxy, xyxy[::-1].copy())),
        "hamer_box_params": (jb.hamer_box_params, tb.hamer_box_params, (xyxy,)),
        "scale_coords": (lambda b, g, p, hw: jb.scale_coords(b, g, p, (hw[0], hw[1])),
                         lambda b, g, p, hw: tb.scale_coords(b, g, p, hw),
                         (xyxy * 2, np.float32(0.7), np.float32([3.0, 11.0]),
                          np.float32([200.0, 250.0]))),
        "letterbox_geometry": (lambda h, w: jlb(h, w, 640), lambda h, w: tlb(h, w, 640),
                               (np.float32(481.0), np.float32(797.0))),
        "flip_keypoints3d": (jfk, tfk, (f(6, 21, 3), flip)),
        "correct_pred_cam": (jcc, tcc, (f(6, 3), flip)),
        "cam_to_translation": (lambda c: jc.cam_to_translation(c, 5000.0, 256.0),
                               lambda c: tc.cam_to_translation(c, 5000.0, 256.0), (cam,)),
        "custom_cam_crop_to_full": (
            lambda c, ce, s: jc.custom_cam_crop_to_full(c, ce, s, *K),
            lambda c, ce, s: tc.custom_cam_crop_to_full(c, ce, s, *(torch.full((6,), float(k))
                                                                    for k in K)),
            (cam, np.abs(f(6, 2)) * 100, np.abs(f(6)) * 80 + 10)),
        "project_with_intrinsics": (
            lambda p: jc.project_with_intrinsics(p, *(jnp.full((6,), k) for k in K)),
            lambda p: tc.project_with_intrinsics(p, *(torch.full((6,), float(k)) for k in K)),
            (f(6, 21, 3) * 0.05 + np.float32([0, 0, 0.8]),)),
        "perspective_projection": (
            lambda p, t, fo: jc.perspective_projection(p, t, fo),
            lambda p, t, fo: tc.perspective_projection(p, t, fo),
            (f(6, 21, 3) * 0.05, np.abs(f(6, 3)) + np.float32([0, 0, 5]), np.full((6, 2), 78.1,
                                                                                np.float32))),
    }


_CASES = _geometry_cases()


@pytest.mark.parametrize("name", sorted(_CASES))
def test_geometry_matches_jax(name):
    jfn, tfn, args = _CASES[name]
    ref = jfn(*(jnp.asarray(a) for a in args))
    got = tfn(*(torch.from_numpy(np.array(a)) for a in args))
    ref = ref if isinstance(ref, tuple) else (ref,)
    got = got if isinstance(got, tuple) else (got,)
    assert len(ref) == len(got)
    for r, g in zip(ref, got):
        # f32, same op order; only transcendental implementations (sin, cos,
        # atan2, XLA's approximate rsqrt inside norms) differ, by an ulp or two
        np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=2e-6, atol=2e-6, err_msg=name)
