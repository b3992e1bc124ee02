"""Kernel K1 (greedy NMS keep mask) and non_max_suppression: the port's
plain twin against the JAX Pallas kernel in interpret mode and the JAX scan.
Keep sets must be identical: NMS output is discrete, and the IoU arithmetic
is the same f32 op sequence on both sides."""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from hamer_yolo_tpu.geometry.boxes import box_iou as jax_box_iou
from hamer_yolo_tpu.ops.nms import _greedy_suppress
from hamer_yolo_tpu.ops.nms import non_max_suppression as jax_nms
from hamer_yolo_tpu.ops.nms_pallas import greedy_nms_keep as jax_greedy_nms_keep
from hamer_yolo_tpu_torch.ops.nms import (greedy_nms_keep, greedy_nms_keep_ref,
                                          non_max_suppression)

torch.set_num_threads(1)


def _random_boxes(rng, B, K):
    boxes = np.zeros((B, K, 4), np.float32)
    boxes[..., :2] = rng.uniform(0, 300, (B, K, 2))
    boxes[..., 2:] = boxes[..., :2] + rng.uniform(10, 80, (B, K, 2))
    active = (rng.uniform(0, 1, (B, K)) > 0.2).astype(np.float32)
    return boxes, active


def _threshold_boxes(rng, B, K):
    """Clusters of boxes shifted by fractions of a pixel, with the threshold
    set to one pair's f32 IoU: many pairs sit exactly at, one ulp above or
    one ulp below the threshold."""
    base = rng.uniform(0, 200, (B, K // 4, 1, 2)).astype(np.float32)
    shift = rng.choice(np.float32([0.0, 0.25, 0.5, 0.75]), (B, K // 4, 4, 2))
    xy1 = (base + shift).reshape(B, -1, 2)
    boxes = np.concatenate([xy1, xy1 + np.float32(40.0)], axis=-1).astype(np.float32)
    a, b = jnp.asarray(boxes[0, :1]), jnp.asarray(boxes[0, 1:2])
    thres = float(np.asarray(jax_box_iou(a, b))[0, 0])
    return boxes, np.ones((B, boxes.shape[1]), np.float32), thres


@pytest.mark.parametrize("K", [64, 252, 512])
@pytest.mark.parametrize("kind", ["random", "at_threshold"])
def test_twin_matches_pallas_and_scan(kind, K):
    rng = np.random.default_rng(K)
    if kind == "random":
        boxes, active = _random_boxes(rng, 2, K)
        thres = 0.45
    else:
        boxes, active, thres = _threshold_boxes(rng, 2, K)
    got = greedy_nms_keep(torch.from_numpy(boxes), torch.from_numpy(active), thres).numpy()
    if kind == "random":
        # At pairs exactly on the threshold the interpret-mode Pallas kernel
        # disagrees with the JAX scan itself (XLA fuses the kernel's IoU
        # into another op sequence, one ulp off box_iou at some pairs); the
        # contract of both kernels is the scan's keep set, checked below.
        pallas = np.asarray(jax_greedy_nms_keep(jnp.asarray(boxes), jnp.asarray(active), thres,
                                                interpret=True))
        np.testing.assert_array_equal(got, pallas)
    for b in range(boxes.shape[0]):
        bx = jnp.asarray(boxes[b])
        scan = np.asarray(_greedy_suppress(jax_box_iou(bx, bx), jnp.asarray(active[b]) > 0.5,
                                           thres))
        np.testing.assert_array_equal(got[b] > 0.5, scan)
    assert 0 < got.sum() < active.sum()  # suppression happened, something survived


def test_wrapper_takes_twin_on_cpu():
    rng = np.random.default_rng(1)
    boxes, active = _random_boxes(rng, 2, 32)
    before = greedy_nms_keep.launches
    a = greedy_nms_keep(torch.from_numpy(boxes), torch.from_numpy(active), 0.4)
    b = greedy_nms_keep_ref(torch.from_numpy(boxes), torch.from_numpy(active), 0.4)
    assert torch.equal(a, b) and greedy_nms_keep.launches == before


def test_aligned16_realigns_views():
    """The kernels read 16-byte vectors: a view starting at an odd element
    is copied to an aligned tensor with the same values."""
    from hamer_yolo_tpu_torch.ops.cuda_build import aligned16

    base = torch.arange(41, dtype=torch.float32)
    view = base[1:].reshape(10, 4)
    assert view.is_contiguous() and view.data_ptr() % 16
    got = aligned16(view)
    assert got.data_ptr() % 16 == 0 and torch.equal(got, view)
    whole = base[:40].reshape(10, 4)
    assert aligned16(whole).data_ptr() == whole.data_ptr()  # no copy when aligned


def _prediction(rng, B, N, nc, tie_frac=0.3):
    pred = np.zeros((B, N, 5 + nc), np.float32)
    pred[..., :2] = rng.uniform(20, 600, (B, N, 2))
    pred[..., 2:4] = rng.uniform(8, 120, (B, N, 2))
    pred[..., 4:] = rng.uniform(0, 1, (B, N, 1 + nc))
    # exact score ties: whole rows copied, so obj * cls ties too
    ties = rng.uniform(0, 1, (B, N)) < tie_frac
    pred[..., 4:] = np.where(ties[..., None], pred[:, :1, 4:], pred[..., 4:])
    return pred


@pytest.mark.parametrize("agnostic,classes,max_det,N", [
    (True, (0, 1, 2), 4, 700),     # the pipeline's settings, top-K cut at 512
    (False, None, 300, 200),      # class offsets; fewer candidates than max_det
    (True, (1,), 16, 252),
])
def test_non_max_suppression_matches_jax(agnostic, classes, max_det, N):
    rng = np.random.default_rng(N)
    pred = _prediction(rng, 3, N, 3)
    ref = jax_nms(jnp.asarray(pred), conf_thres=0.25, iou_thres=0.35, classes=classes,
                  agnostic=agnostic, max_det=max_det, max_nms_static=512)
    got = non_max_suppression(torch.from_numpy(pred), conf_thres=0.25, iou_thres=0.35,
                              classes=classes, agnostic=agnostic, max_det=max_det,
                              max_nms_static=512)
    valid = np.asarray(ref.valid)
    np.testing.assert_array_equal(got.valid.numpy(), valid)
    assert valid.any()
    np.testing.assert_array_equal(got.boxes.numpy()[valid], np.asarray(ref.boxes)[valid])
    np.testing.assert_array_equal(got.scores.numpy()[valid], np.asarray(ref.scores)[valid])
    np.testing.assert_array_equal(got.classes.numpy()[valid], np.asarray(ref.classes)[valid])
