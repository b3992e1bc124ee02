"""The depth slice end to end against the JAX package: infer_frames and
infer_frame with "sar" in the params (root_depth and every field), the
depth-refine lift, the runner's npy files with and without --depth-refine,
and the mask-driven path (infer_frame_with_boxes, process_masked_dir).

Tiny configs on numpy-made weights, the SAR trunk's BN stats calibrated
(test_torch_bridge.sar_pipeline_params), intrinsics of focal 200 so that the
root depths are O(1) as with real weights. f32 runs hold root_depth at the
JAX package's composed-oracle limit (atol 2e-3) and every other field at
test_torch_pipeline's f32 limits. bf16 runs hold the slots (boxes, classes,
sides) exactly and root_depth to test_torch_sar's bf16 accuracy limit (the
SAR trunk is 36 layers deep even at --tiny); the HaMeR fields' bf16 parity
is test_torch_pipeline's, whose limits do not hold for every seed of random
weights (ROADMAP.md, F12). Every output, valid slot or not, must be finite.
"""
import dataclasses
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from hamer_yolo_tpu.io.writers import load_hand_npy
from hamer_yolo_tpu.pipeline import frame as jframe
from hamer_yolo_tpu.pipeline.runner import process_image_dir as jax_process_image_dir
from hamer_yolo_tpu.pipeline.runner import process_masked_dir as jax_process_masked_dir
from hamer_yolo_tpu_torch.pipeline.frame import (estimate_depths, infer_frame,
                                                 infer_frame_with_boxes, infer_frames)
from hamer_yolo_tpu_torch.pipeline.runner import process_image_dir, process_masked_dir
from test_torch_bridge import jax_exact, mano_pair, np_tree, sar_pipeline_params, tiny_configs
from test_torch_bridge import to_port
from test_torch_pipeline import _check_frame

torch.set_num_threads(1)

B = 3
K = np.float32([[200.0, 0, 80], [0, 200.0, 60], [0, 0, 1]])
DEPTH_ATOL = 2e-3  # tests/test_composed_entrypoints.py:213-221 (f32)
BF16_ACCURACY_FACTOR = 2.0  # as test_torch_sar
SLOT_KEYS = ("boxes", "classes", "is_right", "valid")


def _inputs():
    rng = np.random.default_rng(0)
    imgs = rng.integers(0, 255, (B, 120, 160, 3)).astype(np.float32)
    hws = np.tile(np.float32([120.0, 160.0]), (B, 1))
    return imgs, hws, np.tile(K, (B, 1, 1))


def _all_finite(out, where):
    for k, v in out.items():
        if v.dtype != bool:
            assert np.isfinite(v).all(), f"{where}: {k} not finite"


def _match(got, ref):
    """For each valid JAX slot, the port's slot with the same box (F3)."""
    out = []
    for i in np.flatnonzero(ref["valid"]):
        hit = np.flatnonzero(got["valid"] & (got["boxes"] == ref["boxes"][i]).all(-1))
        assert hit.size, f"slot {i} box {ref['boxes'][i]} not found"
        out.append((i, hit[0]))
    return out


def _check_depth(got, ref, dtype, ref32, where):
    """root_depth on valid slots: f32 at DEPTH_ATOL of JAX's; bf16 as
    accurate as JAX's bf16 against JAX's f32 trunk (``ref32``, the f32-trunk
    depths of JAX's slots) within BF16_ACCURACY_FACTOR."""
    pairs = _match(got, ref)
    d = np.array([abs(got["root_depth"][j] - ref["root_depth"][i]) for i, j in pairs])
    if dtype == "float32":
        assert d.max() <= DEPTH_ATOL, f"{where}: root_depth off by {d.max()}"
        return
    floor = max(abs(ref["root_depth"][i] - ref32[i]) for i, _ in pairs)
    acc = max(abs(got["root_depth"][j] - ref32[i]) for i, j in pairs)
    assert acc <= BF16_ACCURACY_FACTOR * floor, f"{where}: {acc} vs JAX bf16's {floor}"


def _jax_params(params):
    return jax.tree_util.tree_map(jnp.asarray, params)


def _f32_depths(jp, jcfg, ref, imgs, hws, Ks):
    """JAX's RootNet stage with an f32 trunk on JAX's own detections: (B, S)."""
    cfg32 = dataclasses.replace(jcfg, sar=dataclasses.replace(jcfg.sar, compute_dtype="float32"))
    return np.stack([np.asarray(jframe.estimate_depths(
        jp["sar"], jnp.asarray(imgs[b]),
        {k: jnp.asarray(ref[k][b]) for k in ("boxes", "scores", "is_right", "valid")},
        jnp.asarray(hws[b]), jnp.asarray(Ks[b]), cfg32)) for b in range(imgs.shape[0])])


@pytest.fixture(scope="module")
def setup():
    jm, tm = mano_pair()
    return jm, tm, _inputs()


def _frames(got, ref, where):
    """f32 frames: every field, root_depth at DEPTH_ATOL."""
    assert set(got) == set(ref)
    _all_finite(got, where)
    assert ref["valid"].any(), "no valid slot: the comparison would be empty"
    for b in range(ref["valid"].shape[0]):
        g = {k: v[b] for k, v in got.items()}
        r = {k: v[b] for k, v in ref.items()}
        _check_depth(g, r, "float32", None, f"{where} frame {b}")
        keys = [k for k in r if k != "root_depth"]
        _check_frame({k: g[k] for k in keys}, {k: r[k] for k in keys}, "float32", f"{where} {b}")


def test_infer_frames_with_sar_matches_jax(setup):
    """f32: every field, root_depth at the composed-oracle limit."""
    jm, tm, (imgs, hws, Ks) = setup
    jcfg, tcfg = tiny_configs("float32")
    params = sar_pipeline_params(jcfg, seed=11)
    jp = _jax_params(params)
    ref = np_tree(jax_exact(lambda i, h, k: jframe.infer_frames(jp, jm, i, h, k, jcfg),
                            imgs, hws, Ks))
    got = np_tree(infer_frames(to_port(params), tm, torch.from_numpy(imgs),
                               torch.from_numpy(hws), torch.from_numpy(Ks), tcfg))
    assert "root_depth" in got and got["root_depth"].shape == (B, 2)
    _frames(got, ref, "infer_frames")


def test_infer_frame_with_sar_matches_jax(setup):
    jm, tm, (imgs, hws, _) = setup
    jcfg, tcfg = tiny_configs("float32")
    params = sar_pipeline_params(jcfg, seed=12)
    jp = _jax_params(params)
    ref = np_tree(jax_exact(lambda i, h, k: jframe.infer_frame(jp, jm, i, h, k, jcfg),
                            imgs[0], hws[0], K))
    got = np_tree(infer_frame(to_port(params), tm, torch.from_numpy(imgs[0]),
                              torch.from_numpy(hws[0]), torch.from_numpy(K), tcfg))
    _frames({k: v[None] for k, v in got.items()}, {k: v[None] for k, v in ref.items()},
            "infer_frame")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_estimate_depths_matches_jax(setup, dtype):
    """The RootNet stage over every (frame, slot) at once, on JAX's own
    detections (masked slots included), against JAX's per-frame stage; bf16
    to the bf16 accuracy limit. A bf16 detector may pick other slots than JAX's on
    random weights (F3), so the stage is held on the same detections."""
    jm, tm, (imgs, hws, Ks) = setup
    jcfg, tcfg = tiny_configs(dtype)
    params = sar_pipeline_params(jcfg, seed=11)
    jp = _jax_params(params)
    ref = np_tree(jax_exact(lambda i, h, k: jframe.infer_frames(jp, jm, i, h, k, jcfg),
                            imgs, hws, Ks))
    dets = {k: torch.from_numpy(ref[k]).to(torch.bool if k == "valid" else torch.float32)
            for k in SLOT_KEYS}
    got = estimate_depths(to_port(params)["sar"], torch.from_numpy(imgs), dets,
                          torch.from_numpy(hws), torch.from_numpy(Ks), tcfg).numpy()
    assert got.shape == (B, 2) and np.isfinite(got).all()
    d32 = _f32_depths(jp, jcfg, ref, imgs, hws, Ks) if dtype == "bfloat16" else [None] * B
    for b in range(B):
        g = {"root_depth": got[b], **{k: ref[k][b] for k in SLOT_KEYS}}
        _check_depth(g, {k: ref[k][b] for k in ref}, dtype, d32[b], f"frame {b}")


def test_bf16_infer_frames_reports_its_rootnet_depth(setup):
    """The default bf16 program with "sar": root_depth is the RootNet stage
    on its own detections, bit for bit, and every output is finite."""
    _, tm, (imgs, hws, Ks) = setup
    jcfg, tcfg = tiny_configs("bfloat16")
    params = to_port(sar_pipeline_params(jcfg, seed=11))
    args = (torch.from_numpy(imgs), torch.from_numpy(hws), torch.from_numpy(Ks))
    out = infer_frames(params, tm, *args, tcfg)
    _all_finite(np_tree(out), "bf16")
    assert out["valid"].any()
    dets = {k: out[k] for k in SLOT_KEYS}
    assert torch.equal(out["root_depth"], estimate_depths(params["sar"], args[0], dets, args[1],
                                                          args[2], tcfg))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_depth_refine_forces_tz_to_root_depth(setup, dtype):
    """With use_depth_refine, cam_t z equals root_depth on every valid slot
    (exactly, in the port; as in JAX), every output is finite, and in f32
    cam_t matches JAX's refined lift."""
    jm, tm, (imgs, hws, Ks) = setup
    jcfg, tcfg = tiny_configs(dtype, depth_refine=True)
    params = sar_pipeline_params(jcfg, seed=13)
    got = np_tree(infer_frames(to_port(params), tm, torch.from_numpy(imgs),
                               torch.from_numpy(hws), torch.from_numpy(Ks), tcfg))
    _all_finite(got, "refine")
    v = got["valid"]
    assert v.any()
    np.testing.assert_array_equal(got["cam_t"][..., 2][v], got["root_depth"][v])
    if dtype == "float32":
        jp = _jax_params(params)
        ref = np_tree(jax_exact(lambda i, h, k: jframe.infer_frames(jp, jm, i, h, k, jcfg),
                                imgs, hws, Ks))
        np.testing.assert_array_equal(ref["cam_t"][..., 2][ref["valid"]],
                                      ref["root_depth"][ref["valid"]])
        for b in range(B):
            g = {k: x[b] for k, x in got.items()}
            r = {k: x[b] for k, x in ref.items()}
            for i, j in _match(g, r):
                # the lift scales the depth's f32 error by at most ~1 here
                np.testing.assert_allclose(g["cam_t"][j], r["cam_t"][i], rtol=0,
                                           atol=DEPTH_ATOL)


def test_depth_refine_off_leaves_the_lift_alone(setup):
    """Without use_depth_refine, RootNet's depth is reported and the lift is
    the unrefined one: the HaMeR fields equal a run without SAR."""
    _, tm, (imgs, hws, Ks) = setup
    _, tcfg = tiny_configs("float32")
    jcfg, _ = tiny_configs("float32")
    params = to_port(sar_pipeline_params(jcfg, seed=14))
    args = (tm, torch.from_numpy(imgs), torch.from_numpy(hws), torch.from_numpy(Ks), tcfg)
    with_sar = np_tree(infer_frames(params, *args))
    without = np_tree(infer_frames({k: v for k, v in params.items() if k != "sar"}, *args))
    assert "root_depth" in with_sar and "root_depth" not in without
    for k, v in without.items():
        np.testing.assert_array_equal(with_sar[k], v, err_msg=k)


@pytest.fixture
def image_dir(tmp_path):
    import cv2

    rng = np.random.default_rng(0)
    d = tmp_path / "imgs"
    d.mkdir()
    for i, (h, w) in enumerate([(100, 120), (90, 130), (130, 70)]):
        cv2.imwrite(str(d / f"f{i}.png"), rng.integers(0, 255, (h, w, 3)).astype(np.uint8))
    np.savetxt(str(tmp_path / "cam_K.txt"), K)
    return str(d), str(tmp_path / "cam_K.txt")


def _compare_npy_dirs(out_j, out_t, keys=("betas", "theta", "pose_hand", "pose_global",
                                          "cam_t")):
    names = sorted(f for f in os.listdir(out_j) if f.endswith(".npy"))
    assert names and names == sorted(f for f in os.listdir(out_t) if f.endswith(".npy"))
    n = 0
    for name in names:
        a = load_hand_npy(os.path.join(out_j, name))
        b = load_hand_npy(os.path.join(out_t, name))
        assert set(a) == set(b) == {"left", "right"}
        for side in a:
            assert (a[side] is None) == (b[side] is None), f"{name}:{side}"
            if a[side] is None:
                continue
            n += 1
            assert a[side]["is_right"] == b[side]["is_right"]
            for k in keys:
                # f32 reassociation (test_torch_runner); cam_t under refine
                # carries root_depth's f32 error, within its 2e-3
                np.testing.assert_allclose(b[side][k], a[side][k], rtol=1e-4,
                                           atol=DEPTH_ATOL if k == "cam_t" else 1e-4,
                                           err_msg=f"{name}:{side}:{k}")
    assert n, "no hand written: the comparison would be empty"


@pytest.mark.parametrize("refine", [False, True], ids=["plain", "depth_refine"])
def test_process_image_dir_with_sar_matches_jax(image_dir, tmp_path, refine):
    """The runner's npy files with RootNet on, with and without
    --depth-refine (f32: the JAX runner jits with XLA's default excess
    precision, which only f32 programs are immune to)."""
    images, cam = image_dir
    jcfg, tcfg = tiny_configs("float32", depth_refine=refine)
    params = sar_pipeline_params(jcfg, seed=15)
    jm, tm = mano_pair()
    out_j, out_t = str(tmp_path / "jax"), str(tmp_path / "torch")
    sj = jax_process_image_dir(images, out_j, _jax_params(params), jm, jcfg,
                               intrinsics_path=cam, progress=False)
    st = process_image_dir(images, out_t, to_port(params), tm, tcfg, intrinsics_path=cam,
                           device="cpu", progress=False)
    assert (st.frames, st.hands, st.skipped) == (sj.frames, sj.hands, sj.skipped)
    assert st.frames == 3 and st.skipped == 0
    _compare_npy_dirs(out_j, out_t)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_infer_frame_with_boxes_matches_jax(setup, dtype):
    """The mask-driven frame: given boxes (slot 1 masked), the detector
    bypassed; JAX's key set (no classes, no pred_cam)."""
    jm, tm, (imgs, hws, _) = setup
    jcfg, tcfg = tiny_configs(dtype, depth_refine=True)
    params = sar_pipeline_params(jcfg, seed=16)
    boxes = np.float32([[30, 20, 70, 75], [0, 0, 0, 0]])
    is_right = np.float32([1.0, 1.0])
    valid = np.float32([1.0, 0.0])
    args = (imgs[0], boxes, is_right, valid, hws[0], K)
    jp = _jax_params(params)
    ref = np_tree(jax_exact(lambda *a: jframe.infer_frame_with_boxes(jp, jm, *a, jcfg), *args))
    got = np_tree(infer_frame_with_boxes(to_port(params), tm, *map(torch.from_numpy, args),
                                         tcfg))
    assert set(got) == set(ref) and "classes" not in got and "pred_cam" not in got
    _all_finite(got, "boxes")
    assert got["cam_t"][0, 2] == got["root_depth"][0]
    d32 = None
    if dtype == "bfloat16":
        d32 = _f32_depths(jp, jcfg, {k: v[None] for k, v in ref.items()}, imgs[:1], hws[:1],
                          K[None])[0]
    g, r = ({k: v for k, v in t.items() if k != "root_depth"} for t in (got, ref))
    _check_depth(got, ref, dtype, d32, "boxes")
    keys = [k for k in r if dtype == "float32" or k in SLOT_KEYS]
    _check_frame({k: g[k] for k in keys}, {k: r[k] for k in keys}, dtype, "boxes")


def test_process_masked_dir_matches_jax(image_dir, tmp_path):
    """The mask-driven runner: <name>.npy masks (one without the hand value,
    one image without a mask), the box of the value-3 pixels as a right
    hand."""
    images, cam = image_dir
    masks = tmp_path / "masks"
    masks.mkdir()
    m0 = np.zeros((100, 120), np.uint8)
    m0[20:70, 30:80] = 3
    np.save(str(masks / "f0.npy"), m0)
    m1 = np.zeros((90, 130), np.uint8)
    m1[10:40, 5:60] = 2  # no value-3 pixel: skipped
    np.save(str(masks / "f1.npy"), m1)
    jcfg, tcfg = tiny_configs("float32")
    params = sar_pipeline_params(jcfg, seed=17)
    jm, tm = mano_pair()
    out_j, out_t = str(tmp_path / "jax"), str(tmp_path / "torch")
    sj = jax_process_masked_dir(images, str(masks), out_j, _jax_params(params), jm, jcfg,
                                intrinsics_path=cam)
    st = process_masked_dir(images, str(masks), out_t, to_port(params), tm, tcfg,
                            intrinsics_path=cam, device="cpu", progress=False)
    assert (st.frames, st.hands, st.skipped) == (sj.frames, sj.hands, sj.skipped) == (1, 1, 2)
    _compare_npy_dirs(out_j, out_t)
