"""The RGB-D slice end to end on the CPU: the port's RGBDRuntime and its
``rgbd`` subcommand (hamer_yolo_tpu_torch/models/kpfusion_rgbd/runtime.py,
cli/main.py) against the JAX package's on the same weights, frames and seed,
at test_torch_kpfusion's small config (64 x 64 crops, 128 points, two
stages). Outputs within the runtime tolerance of the JAX package's own tests
(atol 1e-4, rtol 1e-3); the host steps (center, crops, M) equal. The numpy
nearest resize that stands in for cv2.resize(INTER_NEAREST) is held to cv2
itself over 60 crop shapes.

The CLI runs the default KPFusionConfig; both packages' ``rgbd`` read it at
call time, so the tests hand both the small config instead.
"""
import json

import numpy as np
import pytest
import torch

from hamer_yolo_tpu.models.kpfusion_rgbd import model as JM
from hamer_yolo_tpu.models.kpfusion_rgbd import runtime as JRT
from hamer_yolo_tpu_torch.cli import main as tcli
from hamer_yolo_tpu_torch.core.bridge import from_jax_params
from hamer_yolo_tpu_torch.models.kpfusion_rgbd import model as TM
from hamer_yolo_tpu_torch.models.kpfusion_rgbd import runtime as TRT
from test_torch_kpfusion import SMALL, jnp_tree, kpf_inputs, kpf_tree
from test_torch_state_dicts import write_kpfusion_file

torch.set_num_threads(1)

H, W = 1080, 1920  # the runtime's default camera
BBOX = [880.0, 460.0, 160.0, 150.0]


@pytest.fixture(scope="module")
def tree():
    """Calibrated small-config weights, numpy in JAX layout."""
    return kpf_tree(TM.KPFusionConfig(**SMALL), 20, kpf_inputs(20))


def frame(seed, bbox=BBOX, radius_frac=2.2):
    """A 1080p RGB frame and a depth frame (mm) with a hand-like blob at
    440-560 mm on a disk inside ``bbox``; zero depth elsewhere."""
    rng = np.random.default_rng(seed)
    depth = np.zeros((H, W), np.float32)
    x0, y0, w, h = (int(v) for v in bbox)
    yy, xx = np.mgrid[0:h, 0:w]
    blob = 500.0 + 60.0 * np.sin(xx / 9.0) * np.cos(yy / 7.0)
    blob[((xx - w / 2) ** 2 + (yy - h / 2) ** 2) > (min(h, w) / radius_frac) ** 2] = 0
    depth[y0:y0 + h, x0:x0 + w] = blob
    rgb = rng.uniform(0, 255, (H, W, 3)).astype(np.float32)
    return rgb, depth


@pytest.mark.parametrize("channels", [1, 3])
def test_resize_nearest_matches_cv2(channels):
    """cv2.resize(INTER_NEAREST)'s index rule, down and up, square and not,
    over 60 (source, destination) shapes like the crops' (a crop of ~100-900
    pixels into 128 or 64)."""
    import cv2

    rng = np.random.default_rng(channels)
    shapes = [((int(h), int(w)), (int(dw), int(dh))) for h, w, dw, dh in zip(
        rng.integers(3, 900, 60), rng.integers(3, 900, 60), rng.integers(1, 160, 60),
        rng.integers(1, 160, 60))]
    shapes[:4] = [((453, 453), (128, 128)), ((454, 453), (127, 128)), ((31, 17), (64, 35)),
                  ((128, 128), (128, 128))]
    for (h, w), dsize in shapes:
        img = rng.uniform(0, 1000, (h, w) if channels == 1 else (h, w, 3)).astype(np.float32)
        ref = cv2.resize(img, dsize, interpolation=cv2.INTER_NEAREST)
        got = TRT.resize_nearest(img, dsize)
        assert got.shape == ref.shape, ((h, w), dsize)
        np.testing.assert_array_equal(got, ref, err_msg=str(((h, w), dsize)))


@pytest.mark.parametrize("seed,radius_frac", [(1234, 2.2), (7, 12.0)],
                         ids=["dense", "few_points"])
def test_runtime_matches_jax(tree, seed, radius_frac):
    """The same frame, bbox and seed through both runtimes (JAX seeds
    numpy's global RNG, the port takes RandomState(seed)). "few_points": a
    small blob gives fewer valid pixels than sample_num, so the sampler
    repeats them (its other branch)."""
    rgb, depth = frame(seed, radius_frac=radius_frac)
    jrt = JRT.RGBDRuntime(jnp_tree(tree), JM.KPFusionConfig(**SMALL))
    np.random.seed(seed)
    ref = jrt.estimate_pose_rgbd(rgb, depth, BBOX)
    trt = TRT.RGBDRuntime(from_jax_params(tree), TM.KPFusionConfig(**SMALL), "cpu")
    prep = trt.prepare(rgb, depth, BBOX, np.random.RandomState(seed))
    n_valid = int((~np.isclose(prep["crop_depth"], 1)).sum())
    assert (n_valid < SMALL["sample_num"]) == (radius_frac > 10), n_valid
    got = trt.estimate_pose_rgbd(rgb, depth, BBOX, np.random.RandomState(seed))
    for k in ("center", "M", "crop_rgb", "crop_depth"):
        np.testing.assert_array_equal(got[k], ref[k], err_msg=k)
    for k in ("joint_uvd_full", "joint_xyz_world"):
        assert got[k].dtype == np.float32 and got[k].shape == (21, 3)
        np.testing.assert_allclose(got[k], ref[k], atol=1e-4, rtol=1e-3, err_msg=k)


@pytest.fixture
def small_cli(monkeypatch):
    """Both CLIs' rgbd at the small config."""
    jsmall, tsmall = JM.KPFusionConfig(**SMALL), TM.KPFusionConfig(**SMALL)
    monkeypatch.setattr(JM, "KPFusionConfig", lambda: jsmall)
    monkeypatch.setattr(tcli, "KPFusionConfig", lambda: tsmall)


def _run(main, argv, capsys):
    rc = main(argv)
    out = capsys.readouterr().out.strip().splitlines()
    return rc, out


@pytest.mark.parametrize("box", ["bbox", "bbox_file"])
def test_cli_matches_jax(tree, tmp_path, capsys, small_cli, box):
    """``rgbd --rgb PNG --depth NPY (--bbox | --bbox-file) --kpf-checkpoint
    PTH --seed 3``: the port's JSON line (--device cpu) against JAX's
    cmd_rgbd's on the same KPFusion .pth. --bbox-file holds the reference's
    normalized center box."""
    import cv2

    from hamer_yolo_tpu.cli.main import main as jmain

    rgb, depth = frame(5)
    png, npy, pth = (str(tmp_path / n) for n in ("rgb.png", "depth.npy", "kpf.pth"))
    cv2.imwrite(png, rgb.astype(np.uint8))
    np.save(npy, depth)
    write_kpfusion_file(pth, tree)
    if box == "bbox":
        where = ["--bbox", ",".join(f"{v:g}" for v in BBOX)]
    else:
        x, y, w, h = BBOX
        txt = str(tmp_path / "bbox.txt")
        np.savetxt(txt, [[(x + w / 2) / W, (y + h / 2) / H, w / W, h / H]])
        where = ["--bbox-file", txt]
    argv = ["rgbd", "--rgb", png, "--depth", npy, *where, "--kpf-checkpoint", pth, "--seed", "3"]
    rc_j, out_j = _run(jmain, argv, capsys)
    rc_t, out_t = _run(tcli.main, argv + ["--device", "cpu"], capsys)
    assert rc_j == rc_t == 0 and len(out_j) == len(out_t) == 1
    ref, got = json.loads(out_j[0]), json.loads(out_t[0])
    assert list(got) == list(ref) == ["joint_uvd_full", "joint_xyz_world", "center"]
    np.testing.assert_array_equal(got["center"], ref["center"])
    for k in ("joint_uvd_full", "joint_xyz_world"):
        np.testing.assert_allclose(got[k], ref[k], atol=1e-4, rtol=1e-3, err_msg=k)


def test_cli_without_box_or_weights(tmp_path, capsys, small_cli):
    """No box: rc 2 and nothing printed. No --kpf-checkpoint: a warning and
    the seeded init's joints, the same on a second run."""
    import cv2

    rgb, depth = frame(6)
    png, npy = str(tmp_path / "rgb.png"), str(tmp_path / "depth.npy")
    cv2.imwrite(png, rgb.astype(np.uint8))
    np.save(npy, depth)
    base = ["rgbd", "--rgb", png, "--depth", npy, "--device", "cpu"]
    assert tcli.main(base) == 2
    err = capsys.readouterr()
    assert err.out == "" and "needs --bbox" in err.err
    outs = []
    for _ in range(2):
        assert tcli.main(base + ["--bbox", "880,460,160,150"]) == 0
        got = capsys.readouterr()
        assert "no --kpf-checkpoint; random weights" in got.err
        outs.append(got.out)
    assert outs[0] == outs[1]
    res = json.loads(outs[0])
    assert np.isfinite(res["joint_xyz_world"]).all() and len(res["joint_uvd_full"]) == 21
