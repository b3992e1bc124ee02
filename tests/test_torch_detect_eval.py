"""The detector's evaluation and the tools around it (hamer_yolo_tpu_torch/
utils/metrics.py, utils/detect_eval.py, utils/autoanchor.py,
training/evolve.py) against the JAX package's, on numpy-made detections,
labels, weights and a labelled folder written in tmp_path.

Tolerances, stated at each test: the numpy ports (metrics, autoanchor,
evolve's draws and files) equal to JAX's; the detector's records through
its f32 forward and NMS at rel 1e-5 (boxes atol 1e-3 px), its mAP at rel
1e-5.
"""
import numpy as np
import pytest
import torch
import yaml

import jax
import jax.numpy as jnp

from hamer_yolo_tpu.models.yolov7 import model as JY
from hamer_yolo_tpu.training import evolve as JEv
from hamer_yolo_tpu.utils import autoanchor as JAA
from hamer_yolo_tpu.utils import detect_eval as JD
from hamer_yolo_tpu.utils import metrics as JM
from hamer_yolo_tpu_torch.core.bridge import from_jax_params
from hamer_yolo_tpu_torch.io.datasets import image_label_pairs
from hamer_yolo_tpu_torch.models.yolov7 import model as TY
from hamer_yolo_tpu_torch.training import evolve as TEv
from hamer_yolo_tpu_torch.utils import autoanchor as TAA
from hamer_yolo_tpu_torch.utils import detect_eval as TD
from hamer_yolo_tpu_torch.utils import metrics as TM
from test_torch_bridge import numpy_params
from test_torch_datasets import write_labelled_folder

# a deploy detector of three levels at 64 px (strides 8, 16, 32)
TINY_SPEC = [(-1, "C", (8, 3, 2)), (-1, "C", (16, 3, 2)), (-1, "C", (16, 3, 2)),
             (-1, "C", (24, 3, 2)), (-1, "C", (32, 3, 2)), ((2, 3, 4), "DET", ())]


def _boxes(rng, n, scale=100.0):
    xy = rng.uniform(0, scale, (n, 2))
    return np.concatenate([xy, xy + rng.uniform(2, scale / 3, (n, 2))], 1)


def test_pose_metrics_match_jax():
    """Procrustes, PA-MPJPE, MPJPE (root-centred or not), MPVPE, eval_pose,
    PCK and the Evaluator, at rel 1e-12 (the same float64 numpy)."""
    rng = np.random.default_rng(60)
    pred, gt = rng.normal(size=(4, 21, 3)), rng.normal(size=(4, 21, 3))
    verts = rng.normal(size=(2, 4, 778, 3))
    for name in ("reconstruction_error", "mpjpe", "mpvpe"):
        args = (verts[0], verts[1]) if name == "mpvpe" else (pred, gt)
        np.testing.assert_allclose(getattr(TM, name)(*args), getattr(JM, name)(*args),
                                   rtol=1e-12)
    np.testing.assert_allclose(TM.mpjpe(pred, gt, 0), JM.mpjpe(pred, gt, 0), rtol=1e-12)
    np.testing.assert_allclose(TM.compute_similarity_transform(pred[0], gt[0]),
                               JM.compute_similarity_transform(pred[0], gt[0]), rtol=1e-12)
    assert TM.eval_pose(pred, gt) == pytest.approx(JM.eval_pose(pred, gt), rel=1e-12)
    valid = rng.uniform(size=(4, 21)) < 0.7
    thr = np.array([0.5, 1.0, 2.0])
    np.testing.assert_array_equal(TM.pck(pred[..., :2], gt[..., :2], thr, valid),
                                  JM.pck(pred[..., :2], gt[..., :2], thr, valid))
    te, je = TM.Evaluator(), JM.Evaluator()
    for e in (te, je):
        e.update(pred, gt, verts[0], verts[1])
        e.update(gt, pred)
    assert te.results() == pytest.approx(je.results(), rel=1e-12)


def test_detection_metrics_match_jax():
    """box_iou_np, compute_ap, match_predictions at the ten IoU thresholds
    (predictions shifted from the labels, some of the wrong class),
    ap_per_class (classes with no prediction and with no label) and the
    ConfusionMatrix, equal to JAX's."""
    rng = np.random.default_rng(61)
    gt = _boxes(rng, 12)
    gt_cls = rng.integers(0, 3, 12).astype(np.float64)
    pred = np.concatenate([gt + rng.normal(0, 3, gt.shape), _boxes(rng, 8)])
    pred_cls = np.concatenate([gt_cls, rng.integers(0, 4, 8)]).astype(np.float64)
    pred_cls[:2] = (pred_cls[:2] + 1) % 3
    conf = rng.uniform(size=20)
    np.testing.assert_array_equal(TM.box_iou_np(pred, gt), JM.box_iou_np(pred, gt))
    thr = np.linspace(0.5, 0.95, 10)
    tp = TM.match_predictions(pred, pred_cls, gt, gt_cls, thr)
    np.testing.assert_array_equal(tp, JM.match_predictions(pred, pred_cls, gt, gt_cls, thr))
    assert tp[:, 0].any() and not tp[:, -1].all()
    got = TM.ap_per_class(tp, conf, pred_cls, np.concatenate([gt_cls, [5.0]]))
    ref = JM.ap_per_class(tp, conf, pred_cls, np.concatenate([gt_cls, [5.0]]))
    assert got.keys() == ref.keys()
    for k in got:
        np.testing.assert_array_equal(got[k], ref[k], err_msg=k)
    assert TM.compute_ap(np.array([0.1, 0.5, 0.9]), np.array([1.0, 0.8, 0.6])) == \
        JM.compute_ap(np.array([0.1, 0.5, 0.9]), np.array([1.0, 0.8, 0.6]))
    tcm, jcm = TM.ConfusionMatrix(3, conf=0.3), JM.ConfusionMatrix(3, conf=0.3)
    dets = np.concatenate([pred, conf[:, None], np.minimum(pred_cls, 2)[:, None]], 1)
    labels = np.concatenate([gt_cls[:, None], gt], 1)
    for cm in (tcm, jcm):
        cm.process_batch(dets, labels)
        cm.process_batch(dets[::2], labels[1::2])
    np.testing.assert_array_equal(tcm.matrix, jcm.matrix)
    assert tcm.matrix.sum() > 0


def test_autoanchor_matches_jax():
    """anchor_metric, kmeans_anchors from one seed and check_anchors (kept
    and re-derived), equal to JAX's."""
    rng = np.random.default_rng(62)
    wh = np.concatenate([rng.uniform(5, 40, (150, 2)), rng.uniform(60, 300, (150, 2)),
                         [[1.0, 1.0]]])
    anchors = np.asarray(TY.YOLOV7_ANCHORS, np.float64).reshape(-1, 2)
    assert TAA.anchor_metric(wh, anchors) == JAA.anchor_metric(wh, anchors)
    np.testing.assert_array_equal(TAA.kmeans_anchors(wh, 9, generations=60, seed=3),
                                  JAA.kmeans_anchors(wh, 9, generations=60, seed=3))
    for anc in (anchors, anchors * 8.0):
        got, ref = TAA.check_anchors(wh, anc, bpr_threshold=0.999), \
            JAA.check_anchors(wh, anc, bpr_threshold=0.999)
        np.testing.assert_array_equal(got[0], ref[0])
        assert got[1] == ref[1]


def test_mutate_hyp_and_fitness_match_jax():
    """fitness and five generations of mutate_hyp from one seed over a
    growing history (the first unmutated), equal to JAX's; mp or sigma 0
    raises."""
    hist = np.zeros((0, TEv.N_RESULT_COLS + len(TEv.META)))
    trng, jrng = np.random.default_rng(63), np.random.default_rng(63)
    hyp = dict(TEv.DEFAULT_HYP, lr0=0.02)
    rows = np.random.default_rng(64).uniform(size=(5, 4))
    np.testing.assert_array_equal(TEv.fitness(rows), JEv.fitness(rows))
    for gen in range(5):
        got, ref = TEv.mutate_hyp(hyp, hist, trng), JEv.mutate_hyp(hyp, hist, jrng)
        assert got == ref
        if gen == 0:
            assert got["lr0"] == 0.02
        row = np.concatenate([rows[gen], np.zeros(3), [got[k] for k in TEv.META]])
        hist = np.vstack([hist, row])
    assert TEv.META == JEv.META and TEv.DEFAULT_HYP == JEv.DEFAULT_HYP
    with pytest.raises(ValueError, match="mp > 0"):
        TEv.mutate_hyp(hyp, hist, trng, mp=0.0)


def test_evolve_files_match_jax(tmp_path):
    """Three generations of evolve() from one seed with the same fake
    train-and-eval: evolve.txt byte-equal to JAX's, hyp_evolved.yaml
    byte-equal (written without PyYAML) and read back by yaml.safe_load as
    JAX's dict, and the same best hyp."""
    def fake(hyp, gen):
        return (0.1 * gen, 0.2, hyp["lr0"] * 10, hyp["momentum"] / 3, 0.5, 0.6, 0.7)

    got = TEv.evolve(fake, 3, str(tmp_path / "t"), hyp0={"lr0": 0.02}, seed=5, log=lambda s: None)
    ref = JEv.evolve(fake, 3, str(tmp_path / "j"), hyp0={"lr0": 0.02}, seed=5, log=lambda s: None)
    assert got == ref
    for name in ("evolve.txt", "hyp_evolved.yaml"):
        assert (tmp_path / "t" / name).read_bytes() == (tmp_path / "j" / name).read_bytes(), name
    assert yaml.safe_load((tmp_path / "t" / "hyp_evolved.yaml").read_text()) == ref
    assert TEv.yaml_floats({"a": 1e-05, "b": 3.0, "c": 1e17, "d": float("nan")}) == \
        "a: 1.0e-05\nb: 3.0\nc: 1.0e+17\nd: .nan\n"


@pytest.fixture(scope="module")
def detector(tmp_path_factory):
    """A labelled folder of 4 frames, the tiny detector's deploy weights made
    with numpy for both packages, and the two configs (f32, 64 px)."""
    folder = write_labelled_folder(tmp_path_factory.mktemp("det"), 4,
                                   [(96, 128), (120, 90)], 65)
    jcfg = JY.YoloConfig(nc=3, img_size=64, compute_dtype="float32")
    tcfg = TY.YoloConfig(nc=3, img_size=64, compute_dtype="float32")
    params = jax.tree_util.tree_map(np.asarray, numpy_params(
        lambda k: JY.init_yolov7(k, jcfg, spec=TINY_SPEC), 66))
    return folder, params, jcfg, tcfg


def test_eval_records_and_detector_map_match_jax(detector):
    """eval_detector_images' records (boxes in the frame's pixels, clipped;
    scores; classes; labels) and detector_map at test.py's settings against
    JAX's, on the same weights and folder."""
    folder, params, jcfg, tcfg = detector
    pairs = image_label_pairs(folder)
    tparams = from_jax_params(params)
    ref = list(JD.eval_detector_images(params, jcfg, pairs, spec=TINY_SPEC, img_size=64))
    got = list(TD.eval_detector_images(tparams, tcfg, pairs, spec=TINY_SPEC, img_size=64))
    assert len(got) == len(ref) == 4
    for g, r in zip(got, ref):
        assert g["img_path"] == r["img_path"] and len(g["boxes"]) == len(r["boxes"]) > 0
        np.testing.assert_allclose(g["boxes"], r["boxes"], rtol=1e-5, atol=1e-3)
        np.testing.assert_allclose(g["scores"], np.asarray(r["scores"]), rtol=1e-5, atol=1e-7)
        np.testing.assert_array_equal(g["classes"], np.asarray(r["classes"]))
        np.testing.assert_array_equal(g["gt_boxes"], r["gt_boxes"])
        np.testing.assert_array_equal(g["gt_cls"], r["gt_cls"])
    got_map = TD.detector_map(tparams, tcfg, pairs, spec=TINY_SPEC, img_size=64)
    ref_map = JD.detector_map(params, jcfg, pairs, spec=TINY_SPEC, img_size=64)
    np.testing.assert_allclose(got_map, ref_map, rtol=1e-5, atol=1e-12)
    assert got_map[1] > 0
    bin_spec = TINY_SPEC[:-1] + [((2, 3, 4), "BIN", ())]
    with pytest.raises(ValueError, match="BIN"):
        next(TD.eval_detector_images(tparams, tcfg, pairs, spec=bin_spec, img_size=64))


def test_detector_map_of_a_perfect_detector():
    """ap_per_class through detector_map's arithmetic: predictions equal to
    the labels score mAP@.5 = mAP@.5:.95 = 1, P = R = 1; none scores 0."""
    rng = np.random.default_rng(67)
    gt = _boxes(rng, 6)
    cls = rng.integers(0, 2, 6).astype(np.float64)
    tp = TM.match_predictions(gt, cls, gt, cls, np.linspace(0.5, 0.95, 10))
    res = TM.ap_per_class(tp, np.linspace(0.9, 0.4, 6), cls, cls)
    assert res["map50"] == pytest.approx(1.0, abs=1e-2) and res["map"] == pytest.approx(1.0, abs=1e-2)
    assert (res["precision"] == 1).all() and (res["recall"] == 1).all()
    assert TD.detector_map(None, None, []) == (0.0, 0.0, 0.0, 0.0)
