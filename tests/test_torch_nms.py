"""Kernel K1 (greedy NMS keep mask) and non_max_suppression: the port's
plain twin against the JAX Pallas kernel in interpret mode and the JAX scan,
and a numpy model of the reduced formulation that csrc/nms.cu computes held
to the twin. Keep sets must be identical: NMS output is discrete, and the
IoU arithmetic is the same f32 op sequence on every side."""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from hamer_yolo_tpu.geometry.boxes import box_iou as jax_box_iou
from hamer_yolo_tpu.ops.nms import _greedy_suppress
from hamer_yolo_tpu.ops.nms import non_max_suppression as jax_nms
from hamer_yolo_tpu.ops.nms_pallas import greedy_nms_keep as jax_greedy_nms_keep
from hamer_yolo_tpu_torch.ops.nms import (MAX_K, greedy_nms_keep, greedy_nms_keep_mask,
                                          greedy_nms_keep_ref, non_max_suppression)

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


def _reduced_keep(boxes, active, thres):
    """numpy model of csrc/nms.cu on one image (K, 4), (K,): bits only for
    active i < j, no division where the intersection is 0 (the bit is then
    0 > thres), rows flagged where they have a bit; then the scan a word of
    32 candidates at a time, from one word with an alive flagged candidate
    to the next: inside the word the fixed point of kept = alive & ~(OR of
    the kept rows' words), then the kept flagged rows' later words. The
    words the kernel never builds (before word i // 32 of row i, and every
    word of an inactive row) hold all ones here, so reading one would
    suppress wrongly."""
    f32 = np.float32
    K = boxes.shape[0]
    W = -(-K // 32)
    thr = f32(thres)
    act = np.zeros(W * 32, bool)
    act[:K] = active > 0.5
    x1, y1, x2, y2 = (boxes[:, c].astype(f32) for c in range(4))
    area = (x2 - x1) * (y2 - y1)
    shifts = np.uint32(1) << np.arange(32, dtype=np.uint32)

    def pack(bits):
        return (bits.reshape(W, 32) * shifts).sum(axis=1, dtype=np.uint32)

    rows = np.full((W * 32, W), 0xFFFFFFFF, np.uint32)
    flags = np.zeros(W * 32, bool)
    for i in np.flatnonzero(act[:K]):
        j = np.arange(i + 1, K)
        j = j[act[j]]
        iw = np.maximum(np.minimum(x2[i], x2[j]) - np.maximum(x1[i], x1[j]), f32(0))
        ih = np.maximum(np.minimum(y2[i], y2[j]) - np.maximum(y1[i], y1[j]), f32(0))
        inter = iw * ih
        bit = np.full(j.shape, f32(0) > thr)
        pos = inter != 0
        uni = (area[i] + area[j[pos]]) - inter[pos]
        bit[pos] = inter[pos] / np.maximum(uni, f32(1e-12)) > thr
        row = np.zeros(W * 32, bool)
        row[j[bit]] = True
        rows[i, i // 32:] = pack(row)[i // 32:]
        flags[i] = bit.any()
    cand, flag = pack(act), pack(flags)
    pend = cand & flag
    while pend.any():
        w = int(np.flatnonzero(pend)[0])
        c, f = cand[w], flag[w]
        d = np.where(f & shifts, rows[32 * w:32 * w + 32, w], np.uint32(0))
        kept = c
        while True:
            nxt = c & ~np.bitwise_or.reduce(np.where(kept & shifts, d, np.uint32(0)))
            if nxt == kept:
                break
            kept = nxt
        cand[w], pend[w] = kept, 0
        for t in np.flatnonzero(kept & f & shifts):
            cand[w + 1:] &= ~rows[32 * w + t, w + 1:]
        pend[w + 1:] = cand[w + 1:] & flag[w + 1:]
    return ((cand[:, None] & shifts) != 0).reshape(-1)[:K]


def _edge_case(name):
    """(boxes (2, K, 4), active (2, K), thres) of one edge case."""
    rng = np.random.default_rng(len(name))
    K = 1000 if name == "ragged_1000" else 96
    boxes, active = _random_boxes(rng, 2, K)
    thres = 0.45
    if name == "all_inactive":
        active[:] = 0
    elif name == "all_active_disjoint":
        x = np.arange(K, dtype=np.float32) * 50
        boxes = np.broadcast_to(np.stack([x, x * 0, x + 40, x * 0 + 40], -1), (2, K, 4)).copy()
        active[:] = 1
    elif name == "identical":
        boxes[:] = boxes[:, :1]
        active[:, :3] = 0
    elif name == "degenerate":  # x2 < x1 or y2 < y1: negative areas
        flip = rng.uniform(0, 1, (2, K)) < 0.3
        boxes[flip] = boxes[flip][:, [2, 1, 0, 3]]
        flip = rng.uniform(0, 1, (2, K)) < 0.3
        boxes[flip] = boxes[flip][:, [0, 3, 2, 1]]
    elif name == "negative_thr":
        thres = -0.1
    elif name == "nan_thr":
        thres = float("nan")
    return boxes.astype(np.float32), active, thres


EDGE_CASES = ["all_inactive", "all_active_disjoint", "identical", "degenerate", "negative_thr",
              "nan_thr", "ragged_1000"]


@pytest.mark.parametrize("K", [64, 252, 512, 1024, 2048])
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


@pytest.mark.parametrize("case", EDGE_CASES)
def test_twin_edge_cases_match_pallas_and_scan(case):
    boxes, active, thres = _edge_case(case)
    got = greedy_nms_keep(torch.from_numpy(boxes), torch.from_numpy(active), thres).numpy()
    pallas = np.asarray(jax_greedy_nms_keep(jnp.asarray(boxes), jnp.asarray(active), thres,
                                            interpret=True))
    np.testing.assert_array_equal(got, pallas)
    for b in range(boxes.shape[0]):
        bx = jnp.asarray(boxes[b])
        scan = np.asarray(_greedy_suppress(jax_box_iou(bx, bx), jnp.asarray(active[b]) > 0.5,
                                           thres))
        np.testing.assert_array_equal(got[b] > 0.5, scan)
    want = {"all_inactive": 0, "all_active_disjoint": active.sum(), "identical": 2,
            "negative_thr": 2, "nan_thr": active.sum()}
    if case in want:
        assert got.sum() == want[case]


@pytest.mark.parametrize("case", ["random_512", "at_threshold_512", "random_2048",
                                  "at_threshold_2048"] + EDGE_CASES)
def test_reduced_formulation_matches_twin(case):
    """What csrc/nms.cu leaves out (the lower triangle, inactive rows and
    columns, the division where boxes do not touch, the scan steps of
    candidates that suppress nothing) changes no keep set."""
    if case.startswith("random") or case.startswith("at_threshold"):
        K = int(case.rsplit("_", 1)[1])
        rng = np.random.default_rng(K + 1)
        if case.startswith("random"):
            boxes, active = _random_boxes(rng, 2, K)
            thres = 0.45
        else:
            boxes, active, thres = _threshold_boxes(rng, 2, K)
    else:
        boxes, active, thres = _edge_case(case)
    ref = greedy_nms_keep_ref(torch.from_numpy(boxes), torch.from_numpy(active), thres).numpy()
    for b in range(boxes.shape[0]):
        np.testing.assert_array_equal(_reduced_keep(boxes[b], active[b], thres), ref[b] > 0.5)


def test_mask_entry_takes_twin_on_cpu():
    rng = np.random.default_rng(2)
    boxes, active = _random_boxes(rng, 2, 40)
    before = greedy_nms_keep.launches
    got = greedy_nms_keep_mask(torch.from_numpy(boxes), torch.from_numpy(active > 0.5), 0.4)
    ref = greedy_nms_keep_ref(torch.from_numpy(boxes), torch.from_numpy(active), 0.4)
    assert got.dtype == torch.bool and torch.equal(got, ref > 0.5)
    assert greedy_nms_keep.launches == before


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


@pytest.mark.parametrize("max_nms_static", [1024, MAX_K])
def test_non_max_suppression_past_512_candidates_matches_jax(max_nms_static):
    """max_nms_static past the 512 that K1 took before (up to the kernel's
    MAX_K): the same detections as JAX."""
    rng = np.random.default_rng(max_nms_static)
    pred = _prediction(rng, 2, max_nms_static + 300, 3, tie_frac=0.05)
    K = max_nms_static
    ref = jax_nms(jnp.asarray(pred), conf_thres=0.25, iou_thres=0.45, classes=None,
                  agnostic=False, max_det=K, max_nms_static=K)
    got = non_max_suppression(torch.from_numpy(pred), conf_thres=0.25, iou_thres=0.45,
                              agnostic=False, max_det=K, max_nms_static=K)
    valid = np.asarray(ref.valid)
    np.testing.assert_array_equal(got.valid.numpy(), valid)
    score = (pred[..., 5:] * pred[..., 4:5]).max(-1)
    candidates = np.minimum(((pred[..., 4] > 0.25) & (score > 0.25)).sum(-1), K)
    assert (0 < valid.sum(-1)).all() and (valid.sum(-1) < candidates).all()  # some suppressed
    np.testing.assert_array_equal(got.boxes.numpy()[valid], np.asarray(ref.boxes)[valid])
    np.testing.assert_array_equal(got.scores.numpy()[valid], np.asarray(ref.scores)[valid])
    np.testing.assert_array_equal(got.classes.numpy()[valid], np.asarray(ref.classes)[valid])
