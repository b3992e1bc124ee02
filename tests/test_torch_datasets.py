"""The port's host data pipeline (hamer_yolo_tpu_torch/io/images.py,
io/datasets.py, io/extreme_crop.py) against cv2 and the JAX package's
loaders, on numpy-made images written in tmp_path.

Tolerances, stated at each test: cv2's arithmetic (warpAffine,
warpPerspective, BGR <-> HSV, getAffineTransform, getRotationMatrix2D) is
held byte-equal, as are the batches the loaders build from one seed (images
and targets); rotation matrices from axis-angle at 1e-6 (the port's torch
aa_to_rotmat against JAX's, f32).
"""
import io
import json
import math
import tarfile

import cv2
import numpy as np
import pytest

from hamer_yolo_tpu.io import datasets as J
from hamer_yolo_tpu.io import extreme_crop as JE
from hamer_yolo_tpu_torch.io import datasets as T
from hamer_yolo_tpu_torch.io import extreme_crop as TE
from hamer_yolo_tpu_torch.io import images as I


def _affine_case(rng, h, w, perspective=0.0):
    """A random_perspective-like matrix over an (h, w) image: centre,
    perspective, rotation and scale, shear, translation."""
    C = np.eye(3)
    C[0, 2], C[1, 2] = -w / 2, -h / 2
    P = np.eye(3)
    P[2, :2] = rng.uniform(-perspective, perspective, 2)
    R = np.eye(3)
    R[:2] = cv2.getRotationMatrix2D((0, 0), rng.uniform(-180, 180), rng.uniform(0.3, 2.5))
    Sh = np.eye(3)
    Sh[0, 1], Sh[1, 0] = (math.tan(v * math.pi / 180) for v in rng.uniform(-10, 10, 2))
    Tr = np.eye(3)
    Tr[0, 2], Tr[1, 2] = rng.uniform(-40, 200, 2)
    return Tr @ Sh @ R @ P @ C


# (h, w) of the source, (W, H) of the output: widths around the SIMD body's
# multiples (16) and past them, 1-pixel and tall shapes
WARP_SHAPES = [((37, 53), (60, 40)), ((64, 64), (64, 64)), ((128, 96), (17, 33)),
               ((5, 300), (31, 7)), ((200, 150), (160, 128)), ((90, 120), (15, 90)),
               ((1, 40), (48, 3)), ((66, 71), (129, 65)), ((120, 77), (1, 1)),
               ((33, 33), (32, 200))]


@pytest.mark.parametrize("case", range(len(WARP_SHAPES)))
@pytest.mark.parametrize("kind", ["affine", "perspective"])
def test_warps_byte_equal_to_cv2(case, kind):
    """warp_affine_linear / warp_perspective_linear against cv2's
    INTER_LINEAR with a constant border (114 and 0), byte-equal, on two
    matrices per shape."""
    (h, w), size = WARP_SHAPES[case]
    rng = np.random.default_rng(100 + case)
    for border in (114, 0):
        img = rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
        if kind == "affine":
            M = _affine_case(rng, h, w)[:2]
            ref = cv2.warpAffine(img, M, size, borderValue=(border,) * 3)
            got = I.warp_affine_linear(img, M, size, border)
        else:
            M = _affine_case(rng, h, w, perspective=0.001)
            ref = cv2.warpPerspective(img, M, size, borderValue=(border,) * 3)
            got = I.warp_perspective_linear(img, M, size, border)
        assert got.shape == ref.shape and got.dtype == np.uint8
        np.testing.assert_array_equal(got, ref)


def test_hsv_byte_equal_to_cv2_on_every_colour():
    """BGR -> HSV on all 2^24 colours and HSV -> BGR on all (h < 180, s, v),
    each laid out 4096 and 3840 pixels wide (the SIMD body) and on random
    images of odd widths (the scalar tail), byte-equal to cv2."""
    v = np.arange(256, dtype=np.uint8)
    bgr = np.stack(np.meshgrid(v, v, v, indexing="ij"), -1).reshape(4096, 4096, 3)
    for rows in np.array_split(bgr, 8):
        np.testing.assert_array_equal(I.bgr_to_hsv(rows), cv2.cvtColor(rows, cv2.COLOR_BGR2HSV))
    hsv = np.stack(np.meshgrid(np.arange(180, dtype=np.uint8), v, v, indexing="ij"),
                   -1).reshape(3072, 3840, 3)
    for rows in np.array_split(hsv, 8):
        np.testing.assert_array_equal(I.hsv_to_bgr(rows), cv2.cvtColor(rows, cv2.COLOR_HSV2BGR))
    rng = np.random.default_rng(7)
    for h, w in ((3, 31), (17, 45), (9, 97), (1, 1), (40, 33)):
        img = rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
        np.testing.assert_array_equal(I.bgr_to_hsv(img), cv2.cvtColor(img, cv2.COLOR_BGR2HSV))
        img[..., 0] %= 180
        np.testing.assert_array_equal(I.hsv_to_bgr(img), cv2.cvtColor(img, cv2.COLOR_HSV2BGR))


def test_affine_solvers_equal_cv2():
    """getRotationMatrix2D and getAffineTransform (HaMeR's three-point crop
    maps and random triangles), float64 equal bit for bit."""
    rng = np.random.default_rng(8)
    for _ in range(50):
        center, angle, scale = rng.uniform(-50, 50, 2), rng.uniform(-360, 360), rng.uniform(0.1, 3)
        np.testing.assert_array_equal(I.rotation_matrix_2d(tuple(center), angle, scale),
                                      cv2.getRotationMatrix2D(tuple(center), angle, scale))
        c = rng.uniform(0, 1000, 2).astype(np.float32)
        sw, rad = rng.uniform(20, 400), rng.uniform(-1, 1)
        rot = np.array([[np.cos(rad), -np.sin(rad)], [np.sin(rad), np.cos(rad)]])
        src = np.stack([c, c + (rot @ [0, sw / 2]).astype(np.float32),
                        c + (rot @ [sw / 2, 0]).astype(np.float32)]).astype(np.float32)
        dst = np.array([[128, 128], [128, 256], [256, 128]], np.float32)
        np.testing.assert_array_equal(I.affine_transform(src, dst),
                                      cv2.getAffineTransform(src, dst))
        tri = rng.uniform(-100, 500, (2, 3, 2)).astype(np.float32)
        np.testing.assert_array_equal(I.affine_transform(tri[0], tri[1]),
                                      cv2.getAffineTransform(tri[0], tri[1]))


def test_letterbox_matches_jax():
    """letterbox_numpy (resize + 114 border) byte-equal to JAX's, with the
    same ratio and pads, on 720p, portrait and square frames."""
    from hamer_yolo_tpu.geometry.affine import letterbox_numpy as jletterbox

    rng = np.random.default_rng(9)
    for h, w, S in ((720, 1280, 640), (300, 200, 128), (64, 64, 64), (50, 97, 96)):
        img = rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
        got, ref = I.letterbox_numpy(img, S), jletterbox(img, S)
        np.testing.assert_array_equal(got[0], ref[0])
        assert got[1:] == ref[1:]


def write_labelled_folder(root, n, shapes, seed, nc=3):
    """n PNG frames of the given (h, w) shapes (cycled) with 1-3 filled
    boxes each, and their YOLO label files in the sibling labels folder."""
    rng = np.random.default_rng(seed)
    (root / "images").mkdir(parents=True)
    (root / "labels").mkdir()
    for i in range(n):
        h, w = shapes[i % len(shapes)]
        img = (rng.integers(0, 256, (h, w, 3), dtype=np.uint8) // 4).astype(np.uint8)
        rows = []
        for _ in range(int(rng.integers(1, 4))):
            bw, bh = int(rng.integers(w // 8, w // 3)), int(rng.integers(h // 8, h // 3))
            x0, y0 = int(rng.integers(0, w - bw)), int(rng.integers(0, h - bh))
            c = int(rng.integers(0, nc))
            img[y0:y0 + bh, x0:x0 + bw] = (60 + 60 * c, 200 - 50 * c, 120)
            rows.append(f"{c} {(x0 + bw / 2) / w:.6f} {(y0 + bh / 2) / h:.6f} "
                        f"{bw / w:.6f} {bh / h:.6f}")
        cv2.imwrite(str(root / "images" / f"im{i:03d}.png"), img)
        (root / "labels" / f"im{i:03d}.txt").write_text("\n".join(rows) + "\n")
    return str(root / "images")


@pytest.fixture(scope="module")
def folder(tmp_path_factory):
    return write_labelled_folder(tmp_path_factory.mktemp("yolo"), 6,
                                 [(96, 128), (75, 100), (128, 64)], 10)


@pytest.mark.parametrize("mode", ["mosaic", "no_mosaic", "mixup", "perspective"])
def test_yolo_batch_iterator_matches_jax(folder, mode):
    """Three batches of 2 from seed 3: images and targets byte-equal. Modes:
    the default recipe (mosaic, mixup 0.15), no mosaic, mixup on every
    image, the mosaic with rotation, shear and perspective."""
    kw = {"mosaic": {}, "no_mosaic": {"mosaic": False}, "mixup": {"mixup": 1.0},
          "perspective": {"degrees": 20.0, "shear": 5.0, "perspective": 0.0005}}[mode]
    jit = J.yolo_batch_iterator(folder, 2, J.YoloDataConfig(img_size=64, max_targets=16, **kw),
                                seed=3)
    tit = T.yolo_batch_iterator(folder, 2, T.YoloDataConfig(img_size=64, max_targets=16, **kw),
                                seed=3)
    for _ in range(3):
        ref, got = next(jit), next(tit)
        assert got["img"].shape == (2, 64, 64, 3) and got["targets"].shape == (2, 16, 5)
        np.testing.assert_array_equal(got["img"], ref["img"])
        np.testing.assert_array_equal(got["targets"], ref["targets"])
    assert (got["targets"][..., 3] > 0).any()


def test_mosaic9_and_random_perspective_match_jax(folder):
    """load_mosaic9 and random_perspective with given and drawn parameters,
    byte-equal."""
    pairs = J.image_label_pairs(folder)
    assert pairs == T.image_label_pairs(folder)
    for seed in range(3):
        jr, tr = np.random.default_rng(seed), np.random.default_rng(seed)
        idx = jr.integers(0, len(pairs), 9)
        assert (idx == tr.integers(0, len(pairs), 9)).all()
        cfg = dict(img_size=64)
        ref = J.load_mosaic9(pairs, idx, jr, J.YoloDataConfig(**cfg))
        got = T.load_mosaic9(pairs, idx, tr, T.YoloDataConfig(**cfg))
        for g, r in zip(got, ref):
            np.testing.assert_array_equal(g, r)
    img = cv2.imread(pairs[0][0])
    tg = np.array([[0, 10, 12, 60, 50], [2, 30, 5, 90, 70]], np.float64)
    for params in (None, (0.0004, -0.0002, 30.0, 1.2, 4.0, -3.0, 0.45, 0.6)):
        for persp in (0.0, 0.0005):
            ref = J.random_perspective(img, tg.copy(), np.random.default_rng(5), 15, 0.2, 0.5, 5,
                                       persp, params=params)
            got = T.random_perspective(img, tg.copy(), np.random.default_rng(5), 15, 0.2, 0.5, 5,
                                       persp, params=params)
            for g, r in zip(got, ref):
                np.testing.assert_array_equal(g, r)


def _hand_frame(rng, h=120, w=160):
    return rng.integers(0, 256, (h, w, 3), dtype=np.uint8)


def _body_keypoints(rng):
    """44 visible keypoints of a full body (the extreme crop's convention)."""
    kp = np.zeros((44, 3), np.float32)
    kp[:, :2] = rng.uniform(20, 140, (44, 2))
    kp[:, 2] = 1.0
    return kp


@pytest.mark.parametrize("variant", ["default", "flip", "extreme"])
def test_hamer_training_crop_matches_jax(variant):
    """hamer_training_crop over 6 seeds: the normalised crop and the draws
    equal to JAX's (the flip forced on, or the EFT extreme crop forced on
    over a full body's keypoints)."""
    aug = {"default": {}, "flip": {"do_flip": True, "flip_aug_rate": 1.0},
           "extreme": {"extreme_crop_aug_rate": 1.0}}[variant]
    for seed in range(6):
        rng = np.random.default_rng(seed)
        img = _hand_frame(rng)
        center = rng.uniform(40, 120, 2).astype(np.float32)
        size = float(rng.uniform(30, 90))
        kp = _body_keypoints(rng) if variant == "extreme" else None
        ref = J.hamer_training_crop(img, center, size, np.random.default_rng(seed + 50),
                                    J.HamerAugConfig(**aug), 64, keypoints_2d=kp)
        got = T.hamer_training_crop(img, center, size, np.random.default_rng(seed + 50),
                                    T.HamerAugConfig(**aug), 64, keypoints_2d=kp)
        np.testing.assert_array_equal(got[0], ref[0])
        assert got[1] == ref[1]


def test_extreme_crop_matches_jax():
    """Both extreme-crop families on full-body, upper-body and other
    keypoints, every variant's p range, equal to JAX's."""
    rng = np.random.default_rng(11)
    for _ in range(20):
        kp = _body_keypoints(rng)
        kind = rng.integers(0, 3)
        if kind == 1:  # upper body: no lower-body keypoints
            kp[[10, 11, 13, 14, 25, 26, 29, 30], 2] = 0
        elif kind == 2:
            kp[rng.uniform(size=44) < 0.7, 2] = 0
        for p in np.linspace(0.0, 0.99, 12):
            for jf, tf in ((JE.extreme_cropping, TE.extreme_cropping),
                           (JE.extreme_cropping_aggressive, TE.extreme_cropping_aggressive)):
                ref = jf(50.0, 60.0, 30.0, 40.0, kp, p=float(p))
                got = tf(50.0, 60.0, 30.0, 40.0, kp, p=float(p))
                np.testing.assert_array_equal(np.asarray(got, np.float64),
                                              np.asarray(ref, np.float64))


def _write_tar(path, rng, n):
    """n samples: <key>.jpg and <key>.json (some without the MANO fields,
    one without a json, one json without its jpg)."""
    with tarfile.open(path, "w") as tf:
        def add(name, data):
            info = tarfile.TarInfo(name)
            info.size = len(data)
            tf.addfile(info, io.BytesIO(data))

        for i in range(n):
            img = _hand_frame(rng, 90, 110)
            ok, buf = cv2.imencode(".jpg", img)
            meta = {"center": [55.0, 45.0], "scale": float(rng.uniform(30, 60)),
                    "keypoints_2d": rng.normal(size=(21, 3)).tolist()}
            if i % 2 == 0:
                meta.update(mano_pose=(0.3 * rng.normal(size=48)).tolist(),
                            mano_betas=rng.normal(size=10).tolist(),
                            keypoints_3d=rng.normal(size=(21, 4)).tolist())
            if i != 3:
                add(f"s{i:03d}.jpg", buf.tobytes())
            if i != 1:
                add(f"s{i:03d}.json", json.dumps(meta).encode())


def test_tar_reader_and_hamer_batches_match_jax(tmp_path):
    """iter_tar_samples over two shards equal to JAX's; hamer_batch_iterator
    (batches of 3, finite, with and without a mocap pool) equal to JAX's:
    crops and annotations byte-equal, rotation matrices at 1e-6; the mocap
    pool's samples likewise."""
    rng = np.random.default_rng(12)
    shards = [str(tmp_path / f"shard{i}.tar") for i in range(2)]
    for s in shards:
        _write_tar(s, rng, 5)
    ref, got = list(J.iter_tar_samples(shards)), list(T.iter_tar_samples(shards))
    assert [k for k, _ in got] == [k for k, _ in ref] and len(got) == 10
    assert all(g == r for (_, g), (_, r) in zip(got, ref))
    mocap_path = J.write_synthetic_mocap_npz(str(tmp_path / "mocap.npz"), n=64, seed=1)
    T.write_synthetic_mocap_npz(str(tmp_path / "mocap_t.npz"), n=64, seed=1)
    for k in ("hand_pose", "betas"):
        np.testing.assert_array_equal(np.load(tmp_path / "mocap_t.npz")[k],
                                      np.load(mocap_path)[k])
    jm, tm = J.MoCapSource(mocap_path), T.MoCapSource(mocap_path)
    assert len(jm) == len(tm) == 64
    np.testing.assert_array_equal(tm[5]["hand_pose"], jm[5]["hand_pose"])
    for mocap in (None, (jm, tm)):
        jb = list(J.hamer_batch_iterator(shards, 3, 64, seed=4, infinite=False,
                                         mocap=mocap and mocap[0]))
        tb = list(T.hamer_batch_iterator(shards, 3, 64, seed=4, infinite=False,
                                         mocap=mocap and mocap[1]))
        assert len(tb) == len(jb) == 3  # 8 usable samples: 3 + 3 + 2
        for g, r in zip(tb, jb):
            assert g.keys() == r.keys()
            for k in g:
                if k in ("mano_global_orient", "mano_hand_pose", "mocap_hand_pose"):
                    np.testing.assert_allclose(g[k], np.asarray(r[k]), atol=1e-6, err_msg=k)
                else:
                    np.testing.assert_array_equal(g[k], np.asarray(r[k]), err_msg=k)


def test_json_box_dataset_matches_jax(tmp_path):
    """JsonBoxDataset items (eval crops and training crops with the extreme
    crop's keypoints) equal to JAX's."""
    rng = np.random.default_rng(13)
    boxes = []
    for i in range(3):
        cv2.imwrite(str(tmp_path / f"f{i}.jpg"), _hand_frame(rng))
        x0, y0 = rng.uniform(10, 60, 2)
        boxes.append([float(x0), float(y0), float(x0 + rng.uniform(30, 80)),
                      float(y0 + rng.uniform(30, 50))])
    (tmp_path / "boxes.json").write_text(json.dumps(boxes))
    ann = tmp_path / "ann.npz"
    np.savez(ann, hand_pose=rng.normal(size=(3, 48)), has_hand_pose=np.ones(3),
             hand_keypoints_2d=rng.normal(size=(3, 21, 3)))
    for train in (False, True):
        jd = J.JsonBoxDataset(str(tmp_path / "boxes.json"), str(tmp_path), train=train,
                              out_size=64, annotations_npz=str(ann), seed=2)
        td = T.JsonBoxDataset(str(tmp_path / "boxes.json"), str(tmp_path), train=train,
                              out_size=64, annotations_npz=str(ann), seed=2)
        assert len(td) == len(jd) == 3
        for i in range(3):
            r, g = jd[i], td[i]
            assert g.keys() == r.keys()
            for k in g:
                if isinstance(g[k], dict):
                    for kk in g[k]:
                        np.testing.assert_array_equal(g[k][kk], r[k][kk])
                else:
                    np.testing.assert_array_equal(g[k], r[k], err_msg=k)


def test_labels_and_pairs(tmp_path):
    """load_yolo_labels on a file with a short row and on a missing file,
    image_label_pairs over mixed extensions, as JAX's."""
    (tmp_path / "images").mkdir()
    (tmp_path / "labels").mkdir()
    for name in ("b.PNG", "a.jpg", "c.txt", "d.bmp"):
        (tmp_path / "images" / name).write_bytes(b"")
    (tmp_path / "labels" / "a.txt").write_text("1 0.5 0.5 0.2 0.3\n2 0.1\n0 0.2 0.2 0.1 0.1 9\n")
    img_dir = str(tmp_path / "images")
    assert T.image_label_pairs(img_dir) == J.image_label_pairs(img_dir)
    for stem in ("a", "b"):
        path = str(tmp_path / "labels" / f"{stem}.txt")
        np.testing.assert_array_equal(T.load_yolo_labels(path), J.load_yolo_labels(path))
