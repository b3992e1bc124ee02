"""The port's host library (hamer_yolo_tpu_torch.cpp) against JAX's
(hamer_yolo_tpu.cpp), bit for bit: both are built from cpp/src with the
same flags, one by g++ into the port's _build/, the other by cmake. Then,
as tests/test_cpp.py holds JAX's library to JAX's device functions, the
port's library against the port's device letterbox, crop and NMS; and the
C++ runner of AOTInductor packages built against this host's torch."""
import subprocess

import numpy as np
import pytest
import torch

from hamer_yolo_tpu import cpp as jax_cpp
from hamer_yolo_tpu_torch import cpp


def _pred(rng, N=100, nc=3):
    pred = np.zeros((N, 5 + nc), np.float32)
    pred[:, 0:2] = rng.uniform(50, 600, (N, 2))
    pred[:, 2:4] = rng.uniform(10, 120, (N, 2))
    pred[:, 4] = rng.uniform(0, 1, N)
    pred[:, 5:] = rng.dirichlet(np.ones(nc), N)
    return pred


def _same(a, b):
    np.testing.assert_array_equal(np.asarray(a).view(np.uint8), np.asarray(b).view(np.uint8))


@pytest.fixture(scope="module")
def both():
    if not jax_cpp.available():
        pytest.skip("JAX's libhyt_host.so did not build (cmake and ninja)")
    return cpp.load_library()


@pytest.mark.parametrize("hw,size", [((120, 160), 64), ((100, 200), 64), ((720, 1280), 640),
                                     ((481, 333), 256)])
def test_letterbox_equals_jax_library(both, hw, size):
    img = np.random.default_rng(hw[0]).integers(0, 256, (*hw, 3)).astype(np.uint8)
    got, r, pad = cpp.letterbox(img, size)
    ref, r2, pad2 = jax_cpp.letterbox(img, size)
    _same(got, ref)
    assert (r, pad) == (r2, pad2)


@pytest.mark.parametrize("cx,cy,size,out", [(150.0, 90.0, 120.0, 64), (10.5, 190.25, 300.0, 32),
                                            (299.0, 0.0, 17.0, 256)])
def test_crop_and_normalize_equal_jax_library(both, cx, cy, size, out):
    img = np.random.default_rng(1).integers(0, 255, (200, 300, 3)).astype(np.float32)
    crop = cpp.crop_bilinear(img, cx, cy, size, out)
    _same(crop, jax_cpp.crop_bilinear(img, cx, cy, size, out))
    mean, std = [0.485, 0.456, 0.406], [0.229, 0.224, 0.225]
    _same(cpp.normalize(crop.copy(), mean, std), jax_cpp.normalize(crop.copy(), mean, std))


@pytest.mark.parametrize("agnostic", [False, True])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_nms_equals_jax_library(both, seed, agnostic):
    pred = _pred(np.random.default_rng(seed), N=300)
    got = cpp.nms(pred, 0.25, 0.45, agnostic=agnostic, max_det=50)
    _same(got, jax_cpp.nms(pred, 0.25, 0.45, agnostic=agnostic, max_det=50))
    assert len(got)


def test_letterbox_matches_device_letterbox(rng):
    from hamer_yolo_tpu_torch.ops.warp_matmul import letterbox_matmul

    img = rng.integers(0, 255, (120, 160, 3)).astype(np.uint8)
    native, r, _ = cpp.letterbox(img, 64)
    dev, r2, _ = letterbox_matmul(torch.from_numpy(img.astype(np.float32))[None],
                                  torch.tensor([[120.0, 160.0]]), 64)
    dev = dev[0]
    assert abs(r - float(r2[0])) < 1e-6
    # interior rows (the device path pads to 114 sub-pixel at the edge rows,
    # the native one clamps like cv2.resize), test_cpp.py's comparison
    assert np.abs(native[9:55] - dev.numpy()[9:55]).max() < 1.0


def test_pad_value(rng):
    img = rng.integers(0, 255, (100, 200, 3)).astype(np.uint8)
    out, r, _ = cpp.letterbox(img, 64)
    assert np.allclose(out[32:], 114.0)  # the rect letterbox sits at the top left
    assert r == pytest.approx(0.32)


def test_crop_matches_device_crop(rng):
    from hamer_yolo_tpu_torch.ops.warp_matmul import crop_square_matmul

    img = rng.integers(0, 255, (200, 300, 3)).astype(np.float32)
    native = cpp.crop_bilinear(img, 150.0, 90.0, 120.0, 64)
    dev = crop_square_matmul(torch.from_numpy(img)[None], torch.tensor([[[150.0, 90.0]]]),
                             torch.tensor([[[120.0, 120.0]]]), (64, 64))[0, 0].numpy()
    assert np.abs(native - dev).max() < 1e-2


def test_normalize():
    img = np.full((4, 4, 3), 128.0, np.float32)
    out = cpp.normalize(img.copy(), [0.5, 0.5, 0.5], [0.25, 0.25, 0.25])
    np.testing.assert_allclose(out, (128.0 - 127.5) / 63.75, atol=1e-6)


def test_nms_matches_device_nms(rng):
    from hamer_yolo_tpu_torch.ops.nms import non_max_suppression

    pred = _pred(rng)
    out = cpp.nms(pred, 0.25, 0.45)
    dev = non_max_suppression(torch.from_numpy(pred)[None], 0.25, 0.45)
    dv = dev.valid[0].numpy()
    assert len(out) == dv.sum()
    np.testing.assert_allclose(out[:, 4], dev.scores[0].numpy()[dv], rtol=1e-5)
    np.testing.assert_allclose(out[:, :4], dev.boxes[0].numpy()[dv], rtol=1e-4)


def test_nms_agnostic():
    pred = np.zeros((2, 8), np.float32)
    pred[:, 0:4] = [100, 100, 20, 20]
    pred[:, 4] = 0.9
    pred[0, 5] = 1.0
    pred[1, 6] = 0.9
    assert len(cpp.nms(pred, agnostic=False)) == 2
    assert len(cpp.nms(pred, agnostic=True)) == 1


def test_runner_builds_and_prints_usage():
    """The runner builds with g++ against this host's torch; with no
    arguments it prints its usage and exits non-zero."""
    runner = cpp.build_runner()
    res = subprocess.run([str(runner)], capture_output=True, text=True, timeout=60)
    assert res.returncode != 0
    assert "usage:" in res.stderr and "--serve" in res.stderr
    assert res.stdout == ""
