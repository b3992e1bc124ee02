"""The geometry helpers this slice adds to hamer_yolo_tpu_torch/geometry
against the JAX package's, on seeded numpy inputs, at tests/test_geometry.py's
tolerances or tighter: the warp and HaMeR's crop (atol 1e-3 on 0..255
pixels, 1e-4 after the normalisation), the letterbox (its geometry equal,
the numpy letterbox byte-equal, the resize atol 1e-3), the orthonormalisation
(1e-5), the Euler conversions (1e-6; the axis-angle round trips 1e-5), and
the flips, boxes and crop camera (equal, or rtol 1e-6)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import hamer_yolo_tpu.geometry as JG
import hamer_yolo_tpu_torch.geometry as TG
from hamer_yolo_tpu.geometry import rotations as JR
from hamer_yolo_tpu_torch.geometry import rotations as TR

MEAN = np.array([0.485, 0.456, 0.406], np.float32)
STD = np.array([0.229, 0.224, 0.225], np.float32)


def t(a):
    return torch.from_numpy(np.array(a))


def test_geometry_exports_what_jax_exports():
    assert sorted(TG.__all__) == sorted(JG.__all__)


@pytest.mark.parametrize("box", [(150.0, 120.0, 180.0, 64), (40.0, 200.0, 90.0, 32),
                                 (1000.0, 1000.0, 10.0, 16)], ids=["inside", "edge", "outside"])
def test_warp_affine_equals_jax(box):
    rng = np.random.default_rng(0)
    img = rng.integers(0, 255, (240, 320, 3)).astype(np.float32)
    cx, cy, size, out = box
    trans = np.asarray(JG.gen_trans_from_patch(cx, cy, size, size, float(out), float(out)))
    want = np.asarray(JG.warp_affine(jnp.asarray(img), jnp.asarray(trans), (out, out), 7.0))
    got = TG.warp_affine(t(img), t(trans), (out, out), 7.0).numpy()
    np.testing.assert_allclose(got, want, atol=1e-3, rtol=0)


@pytest.mark.parametrize("flip", [0.0, 1.0])
def test_crop_resize_normalize_equals_jax(flip):
    rng = np.random.default_rng(1)
    img = rng.integers(0, 255, (100, 120, 3)).astype(np.float32)
    for center, size, out_hw in (((50.0, 50.0), 80.0, (32, 32)), ((90.0, 20.0), 130.0, (64, 48))):
        want = np.asarray(JG.crop_resize_normalize(
            jnp.asarray(img), jnp.asarray(center, jnp.float32), jnp.asarray(size, jnp.float32),
            out_hw, jnp.asarray(MEAN), jnp.asarray(STD), jnp.asarray(flip)))
        got = TG.crop_resize_normalize(t(img), torch.tensor(center), torch.tensor(size), out_hw,
                                       t(MEAN), t(STD), torch.tensor(flip)).numpy()
        np.testing.assert_allclose(got, want, atol=1e-4, rtol=0)


@pytest.mark.parametrize("shape,auto", [((480, 640), False), ((480, 640), True),
                                        ((300, 170), False), ((720, 1280), True),
                                        ((640, 640), False)])
def test_letterbox_equals_jax(shape, auto):
    rng = np.random.default_rng(2)
    img = rng.integers(0, 255, shape + (3,)).astype(np.uint8)
    want = JG.letterbox_params(shape, 320, 32, auto)
    assert TG.letterbox_params(shape, 320, 32, auto) == want
    assert TG.letterbox_params(shape, 320, 32, auto, scaleup=False) == \
        JG.letterbox_params(shape, 320, 32, auto, scaleup=False)
    got_np, r, pad = TG.letterbox_numpy(img, 320, 32, auto)
    want_np, r2, pad2 = JG.letterbox_numpy(img, 320, 32, auto)
    np.testing.assert_array_equal(got_np, want_np)
    assert (r, pad) == (r2, pad2)
    if auto:
        return
    _, new_unpad, _, pads = want
    jx = np.asarray(JG.letterbox_image(jnp.asarray(img, jnp.float32), new_unpad, pads, 320))
    tx = TG.letterbox_image(t(img.astype(np.float32)), new_unpad, pads, 320).numpy()
    assert tx.shape == jx.shape == (320, 320, 3)
    np.testing.assert_allclose(tx, jx, atol=1e-3, rtol=0)


def test_rotmat_orthonormalize_equals_jax():
    rng = np.random.default_rng(3)
    aa = rng.uniform(-2, 2, (16, 3)).astype(np.float32)
    rot = np.asarray(JG.aa_to_rotmat(jnp.asarray(aa))) + rng.normal(0, 0.05, (16, 3, 3))
    rot = rot.astype(np.float32)
    rot[0] = -rot[0]  # det < 0: the last singular direction flips
    want = np.asarray(JG.rotmat_orthonormalize(jnp.asarray(rot)))
    got = TG.rotmat_orthonormalize(t(rot)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5)
    np.testing.assert_allclose(np.linalg.det(got), 1.0, atol=1e-5)


@pytest.mark.parametrize("conv", ["xyz", "xzy", "yxz", "yzx", "zxy", "zyx"])
def test_euler_equals_jax(conv):
    rng = np.random.default_rng(4)
    ang = rng.uniform(-1.2, 1.2, (32, 3)).astype(np.float32)
    want = np.asarray(JR.ee_to_rotmat(jnp.asarray(ang), conv))
    got = TR.ee_to_rotmat(t(ang), conv)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-6)
    np.testing.assert_allclose(TR.rotmat_to_ee(got, conv).numpy(),
                               np.asarray(JR.rotmat_to_ee(jnp.asarray(want), conv)), atol=1e-6)
    np.testing.assert_allclose(TR.rotmat_to_ee(got, conv).numpy(), ang, atol=1e-5)
    aa = rng.uniform(-1.0, 1.0, (8, 3)).astype(np.float32)
    np.testing.assert_allclose(TR.aa_to_ee(t(aa), conv).numpy(),
                               np.asarray(JR.aa_to_ee(jnp.asarray(aa), conv)), atol=1e-5)
    ee = TR.aa_to_ee(t(aa), conv)
    np.testing.assert_allclose(TG.aa_to_rotmat(TR.ee_to_aa(ee, conv)).numpy(),
                               TG.aa_to_rotmat(t(aa)).numpy(), atol=1e-5)
    np.testing.assert_allclose(TR.ee_to_aa(ee, conv).numpy(),
                               np.asarray(JR.ee_to_aa(jnp.asarray(ee.numpy()), conv)), atol=1e-5)


def test_euler_conventions_refused_as_jax():
    for bad in ("xxy", "xw", "xyzz"):
        with pytest.raises(ValueError):
            TR.ee_to_rotmat(torch.zeros(3), bad)
    with pytest.raises(NotImplementedError):
        TR.rotmat_to_ee(torch.eye(3), "zxz")
    with pytest.raises(ValueError):
        TR._axis_rotmat("w", torch.zeros(()))


def test_flips_boxes_and_crop_camera_equal_jax():
    rng = np.random.default_rng(5)
    v = rng.normal(size=(3, 2, 10, 3)).astype(np.float32)
    left = np.array([[0.0, 1.0], [1.0, 0.0], [0.7, 0.2]], np.float32)
    np.testing.assert_array_equal(TG.mirror_mesh(t(v), t(left)).numpy(),
                                  np.asarray(JG.mirror_mesh(jnp.asarray(v), jnp.asarray(left))))
    faces = rng.integers(0, 10, (7, 3))
    np.testing.assert_array_equal(TG.rewind_faces(t(faces)).numpy(),
                                  np.asarray(JG.rewind_faces(jnp.asarray(faces))))
    boxes = rng.uniform(0, 100, (4, 5, 4)).astype(np.float32)
    np.testing.assert_array_equal(TG.xyxy2xywh(t(boxes)).numpy(),
                                  np.asarray(JG.xyxy2xywh(jnp.asarray(boxes))))
    np.testing.assert_allclose(TG.xywh2xyxy(TG.xyxy2xywh(t(boxes))).numpy(), boxes, atol=1e-4)
    cam = rng.uniform(0.5, 2.0, (6, 3)).astype(np.float32)
    center = rng.uniform(0, 640, (6, 2)).astype(np.float32)
    size = rng.uniform(50, 300, (6,)).astype(np.float32)
    img = np.tile(np.array([[640.0, 480.0]], np.float32), (6, 1))
    want = np.asarray(JG.cam_crop_to_full(*(jnp.asarray(a) for a in (cam, center, size, img))))
    got = TG.cam_crop_to_full(t(cam), t(center), t(size), t(img)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6)
    fx = np.full(6, 5000.0, np.float32)
    np.testing.assert_allclose(
        got, TG.custom_cam_crop_to_full(t(cam), t(center), t(size), t(fx), t(fx),
                                        t(img[:, 0] / 2), t(img[:, 1] / 2)).numpy(), rtol=1e-5)
