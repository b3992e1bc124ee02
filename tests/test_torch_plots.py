"""The port's plots and debug drawings (hamer_yolo_tpu_torch/utils/plots.py and
vis_tool.py) against the JAX package's, pixel for pixel (both draw with the
same cv2 and matplotlib here), and tools/train_yolo --plots.

Files are compared by their decoded pixels (cv2.imread), arrays as they
are; there is no tolerance."""
import json
import os

import cv2
import numpy as np
import pytest

from hamer_yolo_tpu.utils import plots as JP
from hamer_yolo_tpu.utils import vis_tool as JV
from hamer_yolo_tpu_torch.utils import plots as TP
from hamer_yolo_tpu_torch.utils import vis_tool as TV


def same_file(a, b):
    pa, pb = cv2.imread(str(a), cv2.IMREAD_UNCHANGED), cv2.imread(str(b), cv2.IMREAD_UNCHANGED)
    assert pa is not None and pb is not None
    np.testing.assert_array_equal(pa, pb)


def _pose(rng, n=21, lo=10, hi=110):
    return rng.uniform(lo, hi, (n, 2))


@pytest.mark.parametrize("case", ["labels_float", "preds_uint8_downscaled", "paths_names"])
def test_plot_images_equals_jax(case, tmp_path):
    rng = np.random.default_rng(0)
    if case == "labels_float":
        imgs = rng.uniform(0, 1, (5, 64, 64, 3)).astype(np.float32)
        tg = np.array([[0, 1, 0.5, 0.5, 0.4, 0.4], [3, 0, 0.3, 0.3, 0.2, 0.2],
                       [4, 2, 0.7, 0.6, 0.5, 0.3]])
        kw = {}
    elif case == "preds_uint8_downscaled":
        imgs = rng.integers(0, 255, (3, 100, 120, 3)).astype(np.uint8)
        tg = np.array([[0, 0, 50.0, 50.0, 40.0, 40.0, 0.9], [1, 1, 30.0, 60.0, 20.0, 50.0, 0.2],
                       [2, 2, 60.0, 40.0, 70.0, 30.0, 0.6]])
        kw = dict(max_size=50)
    else:
        imgs = rng.uniform(0, 255, (4, 80, 80, 3)).astype(np.float32)
        tg = np.array([[1, 1, 0.5, 0.5, 0.6, 0.2], [2, 0, 0.2, 0.8, 0.1, 0.1]])
        kw = dict(paths=[f"/x/frame_{i}.jpg" for i in range(4)], names=["hand", "left", "right"])
    a = TP.plot_images(imgs, tg, fname=str(tmp_path / "t.jpg"), **kw)
    b = JP.plot_images(imgs, tg, fname=str(tmp_path / "j.jpg"), **kw)
    np.testing.assert_array_equal(a, b)
    same_file(tmp_path / "t.jpg", tmp_path / "j.jpg")


def test_output_rows_and_keypoints_equal_jax():
    rng = np.random.default_rng(1)
    boxes = rng.uniform(0, 60, (3, 5, 4))
    boxes[..., 2:] += boxes[..., :2]
    scores, classes = rng.uniform(0, 1, (3, 5)), rng.integers(0, 3, (3, 5))
    valid = rng.random((3, 5)) < 0.6
    kpts = rng.uniform(0, 60, (3, 5, 51))
    np.testing.assert_array_equal(TP.output_to_target(boxes, scores, classes, valid),
                                  JP.output_to_target(boxes, scores, classes, valid))
    np.testing.assert_array_equal(TP.output_to_keypoint(boxes, scores, classes, kpts, valid),
                                  JP.output_to_keypoint(boxes, scores, classes, kpts, valid))
    k = np.concatenate([rng.uniform(-5, 100, (17, 2)), rng.uniform(0, 1, (17, 1))], 1).ravel()
    a = TP.plot_skeleton_kpts(np.zeros((100, 100, 3), np.uint8), k)
    b = JP.plot_skeleton_kpts(np.zeros((100, 100, 3), np.uint8), k)
    np.testing.assert_array_equal(a, b)


def test_plot_labels_results_lr_equal_jax(tmp_path):
    rng = np.random.default_rng(2)
    labels = np.concatenate([rng.integers(0, 3, (40, 1)), rng.uniform(0, 1, (40, 4))], 1)
    for mod, tag in ((TP, "t"), (JP, "j")):
        mod.plot_labels(labels, str(tmp_path / f"labels_{tag}.png"), names=["a", "b", "c"])
    same_file(tmp_path / "labels_t.png", tmp_path / "labels_j.png")
    log = tmp_path / "run" / "metrics.jsonl"
    log.parent.mkdir()
    log.write_text("\n".join(json.dumps({"step": s, "time": 1.0 * s, "loss": 1.0 / (s + 1),
                                         "box": 0.1 * s, "tag": "x"}) for s in range(12)) + "\n")
    TP.plot_results(str(log.parent), out=str(tmp_path / "res_t.png"))
    JP.plot_results(str(log.parent), out=str(tmp_path / "res_j.png"))
    same_file(tmp_path / "res_t.png", tmp_path / "res_j.png")
    assert TP.plot_results(str(log.parent)) == str(log.parent / "results.png")
    with pytest.raises(ValueError):
        TP.plot_results(str(log.parent), keys=["nothing"])
    sched = lambda s: 1e-3 * (1 - s / 50)  # noqa: E731
    TP.plot_lr_scheduler(sched, 50, str(tmp_path / "lr_t.png"))
    JP.plot_lr_scheduler(sched, 50, str(tmp_path / "lr_j.png"))
    same_file(tmp_path / "lr_t.png", tmp_path / "lr_j.png")


def test_plot_3d_pose_and_point_cloud_equal_jax(tmp_path):
    rng = np.random.default_rng(3)
    joints, pcl = rng.normal(size=(21, 3)), rng.normal(size=(300, 3))
    for mod, tag in ((TP, "t"), (JP, "j")):
        mod.plot_3d_pose(joints, str(tmp_path / f"pose_{tag}.png"), pcl=pcl)
        mod.plot_3d_pose(joints, str(tmp_path / f"bare_{tag}.png"), title="no cloud")
        mod.plot_point_cloud(pcl, str(tmp_path / f"pcl_{tag}.png"), color_by=pcl[:, 2])
    for name in ("pose", "bare", "pcl"):
        same_file(tmp_path / f"{name}_t.png", tmp_path / f"{name}_j.png")


@pytest.mark.parametrize("dataset", ["hands_2017", "FHAD", "nyu", "nyu_all", "icvl", "msra",
                                     "itop", "shrec", "DHG2016", "mano", "smplerx", "unknown"])
def test_vis_tool_topologies_and_draw_pose_equal_jax(dataset):
    assert TV.get_sketch_setting(dataset) == JV.get_sketch_setting(dataset)
    assert TV.get_sketch_color(dataset) == JV.get_sketch_color(dataset)
    assert TV.get_joint_color(dataset) == JV.get_joint_color(dataset)
    rng = np.random.default_rng(4)
    for n in (21, 14, 8):
        pose = _pose(rng, n)
        for scale in (1, 2):
            a = TV.draw_pose(dataset, np.zeros((128, 128, 3), np.uint8), pose, scale)
            b = JV.draw_pose(dataset, np.zeros((128, 128, 3), np.uint8), pose, scale)
            np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(TV.draw_point(dataset, np.zeros((64, 64, 3), np.uint8), pose),
                                  JV.draw_point(dataset, np.zeros((64, 64, 3), np.uint8), pose))


def test_vis_tool_pcl_heatmap_tiles_equal_jax(tmp_path):
    rng = np.random.default_rng(5)
    pcl = rng.uniform(-1.2, 1.2, (3, 200, 3)).astype(np.float32)
    np.testing.assert_array_equal(TV.draw_pcl(pcl, 64), JV.draw_pcl(pcl, 64))
    joints = rng.uniform(-0.8, 0.8, (3, 21, 3))
    a = TV.debug_pcl_pose(pcl, joints, 2, "mano", str(tmp_path / "t"), "dbg", 64)
    b = JV.debug_pcl_pose(pcl, joints, 2, "mano", str(tmp_path / "j"), "dbg", 64)
    assert [os.path.basename(p) for p in a] == [os.path.basename(p) for p in b] == \
        ["6-dbg.png", "7-dbg.png", "8-dbg.png"]
    for pa, pb in zip(a, b):
        same_file(pa, pb)
    img = rng.uniform(-1, 1, (2, 32, 32)).astype(np.float32)
    hm = rng.uniform(0, 3, (2, 4, 16, 16)).astype(np.float32)
    for norm in (True, False):
        np.testing.assert_array_equal(TV.heatmap_overlay(img, hm, 32, norm),
                                      JV.heatmap_overlay(img, hm, 32, norm))
    tiles = [rng.integers(0, 255, (20, 30, 3)).astype(np.uint8) for _ in range(9)]
    for max_col, text in ((7, None), (4, "batch 3"), (9, "x")):
        np.testing.assert_array_equal(TV.tile_batch_images(tiles, max_col, text),
                                      JV.tile_batch_images(tiles, max_col, text))
    with pytest.raises(ValueError):
        TV.tile_batch_images([])


def test_vis_tool_matplotlib_figures_equal_jax(tmp_path):
    rng = np.random.default_rng(6)
    kpt = rng.normal(size=(21, 3))
    vis = (rng.random(21) > 0.2).astype(np.float32)
    lines = TV.get_sketch_setting("mano")
    a = TV.vis_3d_skeleton(kpt, vis, lines, "t", out=str(tmp_path / "sk_t.png"))
    b = JV.vis_3d_skeleton(kpt, vis, lines, "t", out=str(tmp_path / "sk_j.png"))
    np.testing.assert_array_equal(a, b)
    same_file(tmp_path / "sk_t.png", tmp_path / "sk_j.png")
    verts = rng.normal(size=(40, 3))
    faces = rng.integers(0, 40, (30, 3))
    for with_axis in (True, False):
        a = TV.draw_mesh(verts, faces, str(tmp_path / f"m_t{with_axis}.png"), with_axis=with_axis)
        b = JV.draw_mesh(verts, faces, str(tmp_path / f"m_j{with_axis}.png"), with_axis=with_axis)
        np.testing.assert_array_equal(a, b)
        same_file(tmp_path / f"m_t{with_axis}.png", tmp_path / f"m_j{with_axis}.png")


def test_train_yolo_plots_writes_jax_files(tmp_path):
    """--plots, 2 steps at 64 px on the CPU: train_batch0.jpg and labels.png
    are JAX's plot_images and plot_labels of the same first batch (the two
    loaders are byte-equal, tests/test_torch_datasets.py), results.png is
    JAX's plot_results of the run's metrics."""
    import yaml

    from hamer_yolo_tpu.io.datasets import YoloDataConfig, yolo_batch_iterator
    from hamer_yolo_tpu_torch.tools import train_yolo as tool
    from test_torch_datasets import write_labelled_folder
    from test_torch_train_yolo_tool import TINY

    images = write_labelled_folder(tmp_path / "data", 4, [(96, 128), (120, 90)], 70)
    (tmp_path / "tiny.yaml").write_text(yaml.safe_dump(TINY))
    out = tmp_path / "run"
    assert tool.main(["--data", images, "--batch", "2", "--img-size", "64", "--cfg",
                      str(tmp_path / "tiny.yaml"), "--out", str(out), "--log-every", "1",
                      "--device", "cpu", "--steps", "2", "--plots"]) == 0
    for name in ("train_batch0.jpg", "labels.png", "results.png", "metrics.jsonl"):
        assert (out / name).exists(), name
    batch = next(yolo_batch_iterator(images, 2, YoloDataConfig(img_size=64)))
    ref = tmp_path / "ref"
    ref.mkdir()
    tgt = batch["targets"]
    live = tgt[..., 3] > 0
    rows = [np.concatenate([[b], tgt[b, t]]) for b, t in zip(*np.nonzero(live))]
    JP.plot_images(batch["img"], np.asarray(rows).reshape(-1, 6),
                   fname=str(ref / "train_batch0.jpg"))
    JP.plot_labels(tgt[live], str(ref / "labels.png"))
    JP.plot_results(str(out), out=str(ref / "results.png"))
    for name in ("train_batch0.jpg", "labels.png", "results.png"):
        same_file(out / name, ref / name)
