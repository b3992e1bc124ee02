"""The overlay outputs against the JAX package: the lit rasterizer
(utils/render.py) on meshes that hide parts of themselves and on exact depth
ties, the numpy + cv2 drawing (utils/viz.py), and the CLI's ``detect
--save-img`` and ``reconstruct --overlay-images`` files against the JAX
CLI's.

Limits. The vertex stage (projection, normals) is bit-equal to numpy's;
which face owns each supersample, and so the alpha, is equal; the colours
are equal to f64 rounding (the shading's dot products and power round as
BLAS and libm round them, RGB_ATOL); the uint8 images are equal. viz is the
same numpy and cv2 calls: pixel-equal. ``detect --save-img`` images are
equal where the two CLIs give the same boxes and two-decimal scores, which
they do on these inputs (tests/test_torch_int8_yolo.py holds the
detections). ``reconstruct --overlay-images`` meshes come from each
package's own MANO forward, whose f32 vertices differ in the last bits, so
a few silhouette pixels may change by one level: at most
OVERLAY_PIXEL_FRAC of the covered pixels, by at most 1; on JAX's own
vertices the port's overlay is equal.
"""
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from hamer_yolo_tpu.utils import render as jr
from hamer_yolo_tpu.utils import viz as jv
from hamer_yolo_tpu_torch.cli.main import main
from hamer_yolo_tpu_torch.io.writers import save_hand_npy
from hamer_yolo_tpu_torch.pipeline.reconstruct import reconstruct_hand_mesh
from hamer_yolo_tpu_torch.utils import render as tr
from hamer_yolo_tpu_torch.utils import viz as tv
from test_torch_bridge import REPO, mano_pair
from test_torch_int8_yolo import checkpoints, image_dir, jax_cli  # noqa: F401 (fixtures)

torch.set_num_threads(1)

RGB_ATOL = 1e-12
OVERLAY_PIXEL_FRAC = 0.002


def _hand(rng, is_right, tx, tz=0.6):
    return {"theta": (0.3 * rng.normal(size=48)).astype(np.float32),
            "betas": (0.5 * rng.normal(size=10)).astype(np.float32),
            "pose_hand": np.zeros(45, np.float32), "pose_global": np.zeros(3, np.float32),
            "is_right": float(is_right), "cam_t": np.array([tx, 0.01, tz], np.float32)}


@pytest.fixture(scope="module")
def hands():
    """Two posed MANO hands in front of a 120 x 160 camera (the port's MANO
    forward; the fingers curl over the palm, so the mesh hides parts of
    itself), overlapping each other."""
    _, tm = mano_pair()
    rng = np.random.default_rng(0)
    meshes = [reconstruct_hand_mesh(tm, _hand(rng, r, tx)) for r, tx in ((1, 0.03), (0, -0.02))]
    K = np.array([[300.0, 0, 80], [0, 300.0, 60], [0, 0, 1]], np.float32)
    img = rng.integers(0, 255, (120, 160, 3)).astype(np.uint8)
    return meshes, K, img


def _assert_render_equal(got, ref):
    rgb, alpha = got
    np.testing.assert_array_equal(alpha.numpy(), ref[1])
    np.testing.assert_allclose(rgb.numpy(), ref[0], rtol=0, atol=RGB_ATOL)


def test_vertex_normals_bit_equal(hands):
    meshes, _, _ = hands
    for m in meshes:
        got = tr.vertex_normals(m["vertices"], m["faces"]).numpy()
        np.testing.assert_array_equal(got, jr.vertex_normals(m["vertices"], m["faces"]))


@pytest.mark.parametrize("cull", [True, False], ids=["cull", "no_cull"])
@pytest.mark.parametrize("ss", [1, 2])
def test_rasterize_mesh_matches_jax(hands, cull, ss):
    """Both hands as one mesh (each hides parts of the other and of
    itself): the same face wins every supersample (alpha equal), colours to
    f64 rounding."""
    meshes, K, img = hands
    v = np.concatenate([m["vertices"] for m in meshes])
    f = np.concatenate([meshes[0]["faces"], meshes[1]["faces"] + len(meshes[0]["vertices"])])
    ref = jr.rasterize_mesh(v, f, K, img.shape[:2], ss=ss, backface_cull=cull)
    assert (ref[1] > 0).sum() > 1000
    _assert_render_equal(tr.rasterize_mesh(v, f, K, img.shape[:2], ss=ss, backface_cull=cull),
                         ref)


def test_rasterize_mesh_chunks_pick_the_same_faces(hands, monkeypatch):
    """Chunks of a few faces (ties and occlusions settled across chunks)
    give the render of one chunk."""
    meshes, K, img = hands
    m = meshes[0]
    whole = tr.rasterize_mesh(m["vertices"], m["faces"], K, img.shape[:2])
    monkeypatch.setattr(tr, "CHUNK_PAIRS", 64)
    chunked = tr.rasterize_mesh(m["vertices"], m["faces"], K, img.shape[:2])
    assert torch.equal(whole[0], chunked[0]) and torch.equal(whole[1], chunked[1])


def test_exact_depth_ties_go_to_the_lower_face_index():
    """Coplanar faces at one depth over the same pixels, with exact
    (dyadic) barycentrics: JAX's strict < keeps the first face drawn; the
    port gives each such pixel the lowest face index, the same faces. Each
    face has its own colour (its own normals), so a wrong winner shows."""
    z = 2.0
    K = np.array([[2.0, 0, 0], [0, 2.0, 0], [0, 0, 1]], np.float32)
    # front faces wind clockwise on screen (+y down): one big triangle, a
    # smaller one inside it, and the big one again with its vertices rotated
    v = np.array([[0, 0, z], [8, 0, z], [0, 8, z],          # big, flat
                  [1, 1, z], [5, 1, z], [1, 5, z],          # small, flat
                  [0, 0, z], [8, 0, z], [0, 8, z],          # big again
                  [4, 4, z - 1.0], [6, 6, z - 1.0], [2, 2, z + 3.0]],   # tilted, for colour
                 np.float32)
    faces = np.array([[0, 2, 1], [3, 5, 4], [7, 6, 8], [3, 9, 5], [6, 10, 8], [7, 11, 6]])
    for order in (faces, faces[::-1].copy(), faces[[1, 0, 2, 3, 4, 5]]):
        ref = jr.rasterize_mesh(v, order, K, (9, 9), backface_cull=False)
        got = tr.rasterize_mesh(v, order, K, (9, 9), backface_cull=False)
        assert (ref[1] > 0).sum() > 10
        _assert_render_equal(got, ref)


def test_lit_mesh_overlay_and_rgba_match_jax(hands):
    """Both hands composited one after the other on a uint8 frame: equal
    images; render_rgba equal to f64 rounding."""
    meshes, K, img = hands
    ref, got = img, img
    for m in meshes:
        ref = jr.lit_mesh_overlay(ref, m["vertices"], m["faces"], K)
        got = tr.lit_mesh_overlay(got, m["vertices"], m["faces"], K)
    assert got.dtype == np.uint8 and (ref != img).any()
    np.testing.assert_array_equal(got, ref)
    half = tr.lit_mesh_overlay(img, meshes[0]["vertices"], meshes[0]["faces"], K,
                               alpha_scale=0.5)
    np.testing.assert_array_equal(half, jr.lit_mesh_overlay(
        img, meshes[0]["vertices"], meshes[0]["faces"], K, alpha_scale=0.5))
    rgba_ref = jr.render_rgba(meshes[1]["vertices"], meshes[1]["faces"], K, (60, 80))
    rgba = tr.render_rgba(meshes[1]["vertices"], meshes[1]["faces"], K, (60, 80))
    np.testing.assert_array_equal(rgba[..., 3], rgba_ref[..., 3])
    np.testing.assert_allclose(rgba, rgba_ref, rtol=0, atol=RGB_ATOL)


# ------------------------------------------------------------------------ viz
def test_viz_pixel_equal(hands):
    """Every drawing function on the same inputs: the same pixels."""
    meshes, K, img = hands
    rng = np.random.default_rng(1)
    kp = rng.uniform(0, 120, (21, 2))
    valid = rng.random(21) > 0.2
    np.testing.assert_array_equal(tv.draw_hand_skeleton(img, kp),
                                  jv.draw_hand_skeleton(img, kp))
    np.testing.assert_array_equal(tv.draw_hand_skeleton(img, kp, valid, 2, 1),
                                  jv.draw_hand_skeleton(img, kp, valid, 2, 1))
    for label in (None, "right 0.93"):
        np.testing.assert_array_equal(tv.plot_box(img, [10.4, 20.7, 90.2, 100.9], label),
                                      jv.plot_box(img, [10.4, 20.7, 90.2, 100.9], label))
    m = meshes[0]
    np.testing.assert_array_equal(tv.shaded_mesh_overlay(img, m["vertices"], m["faces"], K),
                                  jv.shaded_mesh_overlay(img, m["vertices"], m["faces"], K))
    crops = rng.random((5, 32, 32, 3)).astype(np.float32)
    kps = rng.uniform(0, 32, (5, 21, 2))
    np.testing.assert_array_equal(tv.render_eval_grid(crops, kps, cols=2),
                                  jv.render_eval_grid(crops, kps, cols=2))
    out = {"valid": np.array([True, False, True]), "is_right": np.array([1.0, 0.0, 0.0]),
           "boxes": np.array([[5, 5, 50, 60], [0, 0, 1, 1], [60, 20, 150, 110]], np.float32),
           "scores": np.array([0.9, 0.1, 0.55], np.float32), "keypoints_2d": rng.uniform(
               0, 120, (3, 21, 2))}
    np.testing.assert_array_equal(tv.detection_summary_image(img, out),
                                  jv.detection_summary_image(img, out))


# ------------------------------------------------------------------- the CLI
def test_cli_detect_save_img_matches_jax_cli(checkpoints, image_dir, tmp_path, capsys):  # noqa: F811
    """``detect --save-img`` from the same weights: a file per image, the same
    name, equal to the JAX CLI's pixel for pixel."""
    import cv2

    orbax, npz = checkpoints
    args = ["detect", "--tiny", "--max-hands", "2", "--input", image_dir]
    ref_dir, got_dir = str(tmp_path / "jax"), str(tmp_path / "torch")
    jax_cli(args + ["--checkpoint", orbax, "--save-img", ref_dir])
    assert main(args + ["--device", "cpu", "--checkpoint", npz, "--save-img", got_dir]) == 0
    assert '"detections": [{' in capsys.readouterr().out
    names = sorted(os.listdir(ref_dir))
    assert names == sorted(os.listdir(got_dir)) == ["f0.png", "f1.png", "f2.png"]
    for name in names:
        got, ref = cv2.imread(os.path.join(got_dir, name)), cv2.imread(os.path.join(ref_dir, name))
        assert (ref != cv2.imread(os.path.join(image_dir, name))).any(), name
        np.testing.assert_array_equal(got, ref, err_msg=name)


def test_cli_reconstruct_overlay_images_matches_jax_cli(tmp_path):
    """``reconstruct --overlay-images`` on npy files of two hands, one hand
    and an image-less frame: <stem>_overlay.png for each frame with an
    image, within OVERLAY_PIXEL_FRAC of the JAX CLI's (each package's own
    MANO); the port's overlay on JAX's vertices equal to JAX's."""
    import cv2

    rng = np.random.default_rng(2)
    imgs, npys = tmp_path / "imgs", tmp_path / "npys"
    imgs.mkdir()
    npys.mkdir()
    for i, (h, w) in enumerate([(100, 120), (90, 130), (130, 70), (80, 80)]):
        if i < 3:
            cv2.imwrite(str(imgs / f"f{i}.png"), rng.integers(0, 255, (h, w, 3)).astype(np.uint8))
        res = ({"left": _hand(rng, 0, -0.06, 5.0), "right": _hand(rng, 1, 0.06, 5.0)} if i != 2
               else {"left": None, "right": _hand(rng, 1, 0.0, 5.0)})
        save_hand_npy(str(npys / f"f{i}.npy"), res)
    ref_dir, got_dir = str(tmp_path / "jax"), str(tmp_path / "torch")
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=REPO)
    res = subprocess.run([sys.executable, "-m", "hamer_yolo_tpu.cli.main", "reconstruct",
                          "--tiny", "--input", str(npys), "--output", ref_dir,
                          "--overlay-images", str(imgs)], env=env, cwd=REPO,
                         capture_output=True, text=True, timeout=600)
    assert res.returncode == 0, res.stderr[-2000:]
    assert main(["reconstruct", "--tiny", "--device", "cpu", "--input", str(npys), "--output",
                 got_dir, "--overlay-images", str(imgs)]) == 0
    pngs = sorted(f for f in os.listdir(got_dir) if f.endswith(".png"))
    assert pngs == sorted(f for f in os.listdir(ref_dir) if f.endswith(".png")) == [
        "f0_overlay.png", "f1_overlay.png", "f2_overlay.png"]
    for name in pngs:
        got, ref = cv2.imread(os.path.join(got_dir, name)), cv2.imread(os.path.join(ref_dir, name))
        src = cv2.imread(str(imgs / name.replace("_overlay", "")))
        covered = (ref != src).any(-1).sum()
        diff = np.abs(got.astype(int) - ref.astype(int))
        assert covered > 500 and diff.max() <= 1, name
        assert (diff.max(-1) > 0).sum() <= OVERLAY_PIXEL_FRAC * covered, name
    # the renderer alone: JAX's own vertices through the port's overlay
    from hamer_yolo_tpu.io.writers import load_hand_npy
    from hamer_yolo_tpu.pipeline.reconstruct import reconstruct_hand_mesh as jax_mesh
    from hamer_yolo_tpu_torch.pipeline.runner import default_intrinsics

    jm, _ = mano_pair()
    results = load_hand_npy(str(npys / "f0.npy"))
    out = cv2.imread(str(imgs / "f0.png"))
    for side in ("left", "right"):
        m = jax_mesh(jm, results[side])
        out = tr.lit_mesh_overlay(out, m["vertices"], m["faces"], default_intrinsics(out.shape))
    np.testing.assert_array_equal(out, cv2.imread(os.path.join(ref_dir, "f0_overlay.png")))
