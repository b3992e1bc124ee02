"""The port's RGB-D datasets (hamer_yolo_tpu_torch/io/rgbd_datasets.py) against
the JAX package's, array for array, on numpy-made samples written with cv2;
its nearest warps and Rodrigues against cv2 itself; and
tools/train_kpfusion_rgbd on such a directory.

The point sampling: JAX's draws from numpy's global RNG, the port's from a
RandomState; ``np.random.seed(s)`` before the JAX call and ``RandomState(s)``
for the port give both the same points."""
import glob
import json
import os
import re

import cv2
import numpy as np
import pytest
import scipy.io as sio

from hamer_yolo_tpu.io import rgbd_datasets as J
from hamer_yolo_tpu_torch.io import images as I
from hamer_yolo_tpu_torch.io import rgbd_datasets as T

# a 320 x 240 camera: the 250 mm cube at 450 mm spans 133 px, so that crops
# run past the frame's border too
CAM = (240.0, 238.0, 160.0, 120.0)
FRAME_HW = (240, 320)


def hand_frame(rng, center_xyz=(0.0, 0.0, 450.0), cam=CAM, hw=FRAME_HW):
    """(BGR uint8 frame, u16 depth in mm, (21, 3) joints in mm): a depth blob
    around the joints' projection at 380-520 mm."""
    H, W = hw
    joints = np.asarray(center_xyz, np.float32) + rng.uniform(-60, 60, (21, 3)).astype(np.float32)
    joints[:, 2] = center_xyz[2] + rng.uniform(-40, 40, 21)
    u = joints[:, 0] * cam[0] / joints[:, 2] + cam[2]
    v = joints[:, 1] * cam[1] / joints[:, 2] + cam[3]
    yy, xx = np.mgrid[0:H, 0:W]
    cu, cv = u.mean(), v.mean()
    r = max(np.ptp(u), np.ptp(v)) / 2 + 6
    blob = center_xyz[2] + 70.0 * np.sin(xx / 5.0) * np.cos(yy / 4.0)
    depth = np.where((xx - cu) ** 2 + (yy - cv) ** 2 < r ** 2, blob, 0.0)
    depth[rng.random((H, W)) < 0.02] = 0.0  # holes
    depth[rng.random((H, W)) < 0.01] = 1400.0  # background behind the cube
    rgb = rng.integers(0, 256, (H, W, 3), dtype=np.uint8)
    return rgb, depth.astype(np.uint16), joints


def write_fixture_dir(root, n, seed, bbox_only=0):
    """n labelled samples ({stem}.png, {stem}_d.png u16, {stem}.txt) and
    ``bbox_only`` samples with a {stem}_bbox.txt in place of the joints."""
    rng = np.random.default_rng(seed)
    os.makedirs(root, exist_ok=True)
    for i in range(n + bbox_only):
        rgb, depth, joints = hand_frame(rng, (rng.uniform(-30, 30), rng.uniform(-20, 20),
                                              rng.uniform(420, 480)))
        stem = os.path.join(root, f"s{i:02d}")
        cv2.imwrite(stem + ".png", rgb)
        cv2.imwrite(stem + "_d.png", depth)
        if i < n:
            np.savetxt(stem + ".txt", joints)
        else:
            np.savetxt(stem + "_bbox.txt", [[0.5, 0.5, 0.4, 0.5]])
    return root


def write_stb_dir(root, n, seed):
    """STB's layout: {seq}/SK_color_i.png, SK_depth_i.png (R + 256 G mm) and
    labels/{seq}_SK.mat, the joints in the SK camera placed in front of it."""
    rng = np.random.default_rng(seed)
    seq = os.path.join(root, "B1Counting")
    os.makedirs(seq, exist_ok=True)
    os.makedirs(os.path.join(root, "labels"), exist_ok=True)
    hand_para = np.zeros((3, 21, n))
    for i in range(n):
        rgb, depth, joints = hand_frame(rng, (rng.uniform(-20, 20), rng.uniform(-20, 20), 500.0),
                                        cam=T.STB_CAM, hw=(480, 640))
        hand_para[:, :, i] = joints.T
        enc = np.zeros(depth.shape + (3,), np.uint8)
        enc[..., 2] = depth % 256
        enc[..., 1] = depth // 256
        cv2.imwrite(os.path.join(seq, f"SK_color_{i}.png"), rgb)
        cv2.imwrite(os.path.join(seq, f"SK_depth_{i}.png"), enc)
    sio.savemat(os.path.join(root, "labels", "B1Counting_SK.mat"), {"handPara": hand_para})
    return root


def assert_items_equal(got, want):
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
        assert got[k].dtype == want[k].dtype, k


@pytest.fixture(scope="module")
def fixture_dir(tmp_path_factory):
    return write_fixture_dir(str(tmp_path_factory.mktemp("rgbd")), 6, 3, bbox_only=1)


@pytest.fixture(scope="module")
def stb_dir(tmp_path_factory):
    return write_stb_dir(str(tmp_path_factory.mktemp("stb")), 4, 4)


# --- cv2's nearest warps and Rodrigues -----------------------------------------

def _images(rng, h, w):
    return [rng.normal(500, 100, (h, w)).astype(np.float32),
            rng.uniform(0, 255, (h, w, 3)).astype(np.float32)]


@pytest.mark.parametrize("m", [
    [[1, 0, 0.5], [0, 1, -0.5]], [[2, 0, 0], [0, 2, 0]], [[0.5, 0, -0.5], [0, 0.5, 1.5]],
    [[1, 0, -1.5], [0, 1, 2.5]], [[4, 0, 0.25], [0, 4, -0.75]], [[1, 0, 37.5], [0, 1, -20]],
], ids=["half", "x2", "half_scale", "shift_ties", "x4", "past_the_border"])
def test_warp_affine_nearest_is_cv2_on_ties(m):
    """Source coordinates on .5: cv2 rounds them half to even."""
    rng = np.random.default_rng(0)
    m = np.asarray(m, np.float64)
    for img in _images(rng, 37, 53):
        for border in (0.0, 7.0):
            want = cv2.warpAffine(img, m, (53, 37), flags=cv2.INTER_NEAREST,
                                  borderMode=cv2.BORDER_CONSTANT, borderValue=border)
            np.testing.assert_array_equal(I.warp_affine_nearest(img, m, (53, 37), border), want)


def test_warp_affine_nearest_is_cv2_at_rand_augment_angles():
    """rotate_hand's matrices at the angles rand_augment draws, on crops of
    128 (all SIMD body) and widths with a scalar tail."""
    rng = np.random.default_rng(1)
    for size in ((128, 128), (61, 75), (33, 130)):
        for img in _images(rng, *size):
            for rot in rng.uniform(-180, 180, 12):
                rot = np.mod(rot, 360)
                mr = cv2.getRotationMatrix2D((size[1] // 2, size[0] // 2), -rot, 1)
                want = cv2.warpAffine(img, mr, (size[1], size[0]), flags=cv2.INTER_NEAREST,
                                      borderMode=cv2.BORDER_CONSTANT, borderValue=0)
                got = I.warp_affine_nearest(
                    img, I.rotation_matrix_2d((size[1] // 2, size[0] // 2), -rot, 1),
                    (size[1], size[0]), 0)
                np.testing.assert_array_equal(got, want)


def test_warp_perspective_nearest_is_cv2():
    """recrop_hand's form (a crop matrix times another's inverse) and general
    3 x 3 maps, with and without ties."""
    rng = np.random.default_rng(2)
    for size in ((128, 128), (47, 90)):
        for img in _images(rng, *size):
            for t in range(10):
                M = np.eye(3)
                M[:2, :2] *= rng.choice([0.5, 1.0, 2.0]) if t < 4 else rng.uniform(0.6, 1.7)
                M[:2, 2] = rng.choice([0.5, -1.5, 3.0], 2) if t < 4 else rng.uniform(-30, 30, 2)
                if t >= 7:
                    M[2, :2] = rng.uniform(-2e-3, 2e-3, 2)
                want = cv2.warpPerspective(img, M, size[::-1], flags=cv2.INTER_NEAREST,
                                           borderMode=cv2.BORDER_CONSTANT, borderValue=3.0)
                np.testing.assert_array_equal(
                    I.warp_perspective_nearest(img, M, size[::-1], 3.0), want)


def test_rodrigues_within_one_ulp_of_cv2():
    rng = np.random.default_rng(3)
    vecs = [np.asarray(T.STB_SK_ROT), np.zeros(3), np.array([1e-20, 0, 0])]
    vecs += [rng.normal(size=3) * s for s in (1e-6, 1e-2, 1.0, 3.0) for _ in range(50)]
    for v in vecs:
        want = cv2.Rodrigues(v)[0]
        got = I.rodrigues(v)
        assert got.dtype == np.float64 and got.shape == (3, 3)
        ulp = np.abs(got - want) / np.spacing(np.maximum(np.abs(want), np.finfo(float).tiny))
        assert ulp.max() <= 1, (v, ulp.max())


# --- depth decoding -----------------------------------------------------------

def test_read_depth_decoders_on_cv2_pngs(tmp_path):
    d16 = (np.arange(64, dtype=np.uint16) * 37 % 4000).reshape(8, 8)
    cv2.imwrite(str(tmp_path / "u16.png"), d16)
    raw = np.array([[0, 123, 255], [256, 4567, 65535]], np.uint32)
    nyu = np.zeros((2, 3, 3), np.uint8)
    nyu[..., 0], nyu[..., 1] = raw % 256, raw // 256
    cv2.imwrite(str(tmp_path / "nyu.png"), nyu)
    ho3d = np.zeros((2, 3, 3), np.uint8)
    ho3d[..., 2], ho3d[..., 1] = raw % 256, raw // 256
    cv2.imwrite(str(tmp_path / "ho3d.png"), ho3d)
    np.save(tmp_path / "d.npy", np.random.default_rng(0).uniform(100, 900, (4, 4)))
    cases = [("u16.png", "u16"), ("u16.png", "auto"), ("nyu.png", "nyu"), ("nyu.png", "auto"),
             ("ho3d.png", "ho3d"), ("d.npy", "auto"), ("d.npy", "npy")]
    for name, fmt in cases:
        got = T.read_depth(str(tmp_path / name), fmt)
        want = J.read_depth(str(tmp_path / name), fmt)
        assert got.dtype == np.float32
        np.testing.assert_array_equal(got, want, err_msg=f"{name} {fmt}")
    np.testing.assert_array_equal(T.read_depth(str(tmp_path / "u16.png")), d16)
    np.testing.assert_array_equal(T.read_depth(str(tmp_path / "nyu.png"), "nyu"), raw)
    for name, fmt in (("nyu.png", "u16"), ("u16.png", "ho3d")):
        with pytest.raises(ValueError):
            T.read_depth(str(tmp_path / name), fmt)
    with pytest.raises(ValueError, match="unknown depth format"):
        T.read_depth(str(tmp_path / "u16.png"), "exr")
    np.testing.assert_array_equal(T.read_depth_stb(str(tmp_path / "ho3d.png")),
                                  J.read_depth_stb(str(tmp_path / "ho3d.png")))


def test_calculate_com_and_projection_match_jax():
    rng = np.random.default_rng(5)
    d = rng.uniform(0, 1200, (30, 40)).astype(np.float32)
    for lo, hi in ((100, 1000), (2000, 3000)):
        np.testing.assert_array_equal(T.calculate_com(d, lo, hi), J.calculate_com(d, lo, hi))
    xyz = rng.uniform(-80, 80, (21, 3)) + [0, 0, 500]
    np.testing.assert_array_equal(T.joint_3d_to_img(xyz, CAM), J.joint_3d_to_img(xyz, CAM))
    pts = rng.uniform(0, 128, (21, 3))
    np.testing.assert_array_equal(T.rotate_points_2d(pts, (64, 60), 37.0),
                                  J.rotate_points_2d(pts, (64, 60), 37.0))
    com = np.array([150.0, 110.0, 450.0])
    for cube in ((250.0,) * 3, (300.0,) * 3):
        np.testing.assert_array_equal(T.com_to_transform(com, cube, (128, 128), CAM),
                                      J.com_to_transform(com, cube, (128, 128), CAM))


# --- samples, augmentations, datasets -------------------------------------------

def _crops(seed):
    from hamer_yolo_tpu_torch.models.kpfusion_rgbd.runtime import crop_depth, crop_rgb

    rng = np.random.default_rng(seed)
    rgb, depth, joints = hand_frame(rng)
    center_xyz = joints.mean(0)
    com = T.joint_3d_to_img(center_xyz, CAM)
    cube = np.asarray((250.0,) * 3, np.float32)
    dc, M = crop_depth(depth.astype(np.float32), com, cube, (64, 64), CAM)
    rc, M_rgb = crop_rgb(rgb.astype(np.float32), com, cube, (64, 64), CAM)
    return dict(depth=dc, M=M, rgb=rc, M_rgb=M_rgb, com=com, cube=list(cube),
                gt=(joints - center_xyz).astype(np.float64))


@pytest.mark.parametrize("mode,off,rot,sc", [
    ("none", np.zeros(3), 0.0, 1.0),
    ("com", np.array([8.0, -6.0, 12.0]), 0.0, 1.0),
    ("com", np.array([-12.0, 9.0, -20.0]), 0.0, 1.0),
    ("rot", np.zeros(3), 73.0, 1.0),
    ("rot", np.zeros(3), -41.0, 1.0),
    ("rot", np.zeros(3), 180.0, 1.0),
    ("sc", np.zeros(3), 0.0, 1.17),
    ("sc", np.zeros(3), 0.0, 0.86),
], ids=lambda v: str(v) if isinstance(v, str) else None)
def test_augment_crop_equals_jax(mode, off, rot, sc):
    f = _crops(7)
    m = T.AUG_MODES.index(mode)
    for img, M, rgb in ((f["depth"], f["M"], False), (f["rgb"], f["M_rgb"], True)):
        got = T.augment_crop(img.copy(), f["gt"].copy(), f["com"].copy(), list(f["cube"]),
                             M.copy(), m, off.copy(), rot, sc, CAM, rgb=rgb)
        want = J.augment_crop(img.copy(), f["gt"].copy(), f["com"].copy(), list(f["cube"]),
                              M.copy(), m, off.copy(), rot, sc, CAM, rgb=rgb)
        for a, b in zip(got, want):
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b), err_msg=f"{mode} {rgb}")


@pytest.mark.parametrize("augment", [False, True], ids=["eval", "augment"])
def test_make_rgbd_sample_equals_jax(augment):
    rng = np.random.default_rng(11)
    for s in range(6):
        rgb, depth, joints = hand_frame(rng)
        kw = dict(joints=joints) if s < 5 else dict(bbox=[100, 60, 120, 120])
        if augment and s == 5:
            continue
        aug = (lambda: np.random.default_rng(s)) if augment else (lambda: None)
        np.random.seed(s)
        want = J.make_rgbd_sample(rgb.astype(np.float32), depth.astype(np.float32), CAM,
                                  (250.0,) * 3, 64, 256, 21, aug_rng=aug(), **kw)
        got = T.make_rgbd_sample(rgb.astype(np.float32), depth.astype(np.float32), CAM,
                                 (250.0,) * 3, 64, 256, np.random.RandomState(s), 21,
                                 aug_rng=aug(), **kw)
        assert_items_equal(got, want)


def test_rgbd_disk_dataset_equals_jax(fixture_dir):
    cfg_t = T.RGBDDatasetConfig(img_size=64, sample_num=256, cam_para=CAM)
    cfg_j = J.RGBDDatasetConfig(img_size=64, sample_num=256, cam_para=CAM)
    ds_t = T.RGBDDiskDataset(fixture_dir, cfg_t, pcl_rng=np.random.RandomState(21))
    ds_j = J.RGBDDiskDataset(fixture_dir, cfg_j)
    assert [s.stem for s in ds_t.samples] == [s.stem for s in ds_j.samples]
    assert len(ds_t) == 6
    np.random.seed(21)
    want = ds_j.load(2)
    assert_items_equal(ds_t.load(2), want)
    for augment, seed in ((False, 0), (True, 1), (True, 2)):
        np.random.seed(seed + 30)
        ds_t.pcl_rng = np.random.RandomState(seed + 30)
        want = list(ds_j.batches(4, shuffle=True, seed=seed, augment=augment))
        got = list(ds_t.batches(4, shuffle=True, seed=seed, augment=augment))
        assert len(got) == len(want) == 2  # 6 samples: the second batch wraps around
        for a, b in zip(got, want):
            assert_items_equal(a, b)
    # the unlabelled sample, its center from the bbox
    unl_t = T.RGBDDiskDataset(fixture_dir, cfg_t, require_labels=False,
                              pcl_rng=np.random.RandomState(4))
    unl_j = J.RGBDDiskDataset(fixture_dir, cfg_j, require_labels=False)
    np.random.seed(4)
    assert_items_equal(unl_t.load(6), unl_j.load(6))
    with pytest.raises(FileNotFoundError):
        T.RGBDDiskDataset(os.path.join(fixture_dir, "missing"), pcl_rng=np.random.RandomState(0))


def test_stb_dataset_equals_jax(stb_dir):
    ds_t = T.STBDataset(stb_dir, img_size=64, sample_num=256, pcl_rng=np.random.RandomState(8))
    ds_j = J.STBDataset(stb_dir, img_size=64, sample_num=256)
    assert [(s.seq, s.frame) for s in ds_t.samples] == [(s.seq, s.frame) for s in ds_j.samples]
    for a, b in zip(ds_t.samples, ds_j.samples):
        np.testing.assert_array_equal(a.joints_xyz, b.joints_xyz)
    np.testing.assert_array_equal(ds_t._rot_mat, ds_j._rot_mat)
    for augment, seed in ((False, 3), (True, 4)):
        np.random.seed(seed + 8)
        ds_t.pcl_rng = np.random.RandomState(seed + 8)
        want = list(ds_j.batches(3, seed=seed, augment=augment))
        got = list(ds_t.batches(3, seed=seed, augment=augment))
        assert len(got) == len(want) == 2
        for a, b in zip(got, want):
            assert_items_equal(a, b)
    uvd = np.random.default_rng(0).uniform(0, 100, (21, 3))
    np.testing.assert_array_equal(T.preprocess_stb(uvd), J.preprocess_stb(uvd))
    assert T.scan_stb_dir(os.path.join(stb_dir, "B1Counting")) == []


# --- the tool -----------------------------------------------------------------

@pytest.mark.parametrize("fmt", ["fixture", "stb"])
def test_train_kpfusion_rgbd_tool_on_data(fmt, fixture_dir, stb_dir, tmp_path, capsys):
    from hamer_yolo_tpu_torch.tools.train_kpfusion_rgbd import main

    data = fixture_dir if fmt == "fixture" else stb_dir
    out = str(tmp_path / "run")
    rc = main(["--data", data, "--data-format", fmt, "--augment", "--tiny", "--device", "cpu",
               "--steps", "2", "--batch", "2", "--log-every", "1", "--out", out])
    assert rc == 0
    text = capsys.readouterr().out
    assert f"({fmt})" in text and "loader" in text
    with open(os.path.join(out, "metrics.jsonl")) as fh:
        recs = [json.loads(line) for line in fh]
    assert [r["step"] for r in recs] == [0, 1]
    assert all(np.isfinite(r["loss"]) for r in recs)
    assert os.path.exists(os.path.join(out, "ckpt_final.npz"))


def test_train_kpfusion_rgbd_tool_refuses_bad_flags(fixture_dir, tmp_path):
    from hamer_yolo_tpu_torch.tools.train_kpfusion_rgbd import main

    with pytest.raises(SystemExit):  # --devices above 1 still raises (data parallelism)
        main(["--data", fixture_dir, "--devices", "2", "--device", "cpu", "--tiny"])
    with pytest.raises(SystemExit):
        main(["--data", fixture_dir, "--depth-fmt", "exr", "--device", "cpu", "--tiny"])


def test_data_parallel_is_named_queue_1_item_8():
    """Every place in the port that names the missing data mesh or data
    parallelism cites ROADMAP.md's Queue 1 item 8."""
    root = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                        "hamer_yolo_tpu_torch")
    cited = []
    for path in glob.glob(os.path.join(root, "**", "*.py"), recursive=True):
        text = open(path).read()
        for m in re.finditer(r"(mesh|parallelism).{0,80}?Queue 1 item (\d+)", text, re.S):
            cited.append((os.path.relpath(path, root), m.group(2)))
    assert cited and all(item == "8" for _, item in cited), cited
