"""Detect-skip tracking in the port against the JAX package:
geometry.boxes.track_boxes_from_keypoints (exactly, on JAX's own cases of
tests/test_tracking.py and on random ones) and frame.infer_frames_tracked
(f32 tiny configs with SAR on numpy-made weights, at the limits of
test_torch_serving._same_slots). On the CPU."""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from hamer_yolo_tpu.geometry.boxes import track_boxes_from_keypoints as jax_track
from hamer_yolo_tpu.pipeline.frame import infer_frames_tracked as jax_tracked
from hamer_yolo_tpu_torch.geometry.boxes import track_boxes_from_keypoints
from hamer_yolo_tpu_torch.pipeline.frame import infer_frames, infer_frames_tracked
from test_torch_bridge import mano_pair, sar_pipeline_params, tiny_configs, to_port
from test_torch_serving import _same_slots

torch.set_num_threads(1)


def _both(kp2d, valid, hw, **kw):
    """(JAX's boxes, the port's boxes) of one frame's slots, as numpy."""
    ref = np.asarray(jax_track(jnp.asarray(kp2d, jnp.float32), jnp.asarray(valid),
                               jnp.asarray(hw, jnp.float32), **kw))
    got = track_boxes_from_keypoints(torch.from_numpy(np.float32(kp2d)),
                                     torch.from_numpy(np.asarray(valid)),
                                     torch.from_numpy(np.float32(hw)), **kw).numpy()
    return ref, got


def test_track_boxes_expand_round_clip_invalid():
    """JAX's own case: an expanded extent, a collapsed slot at min_size and
    an invalid slot zeroed, equal to JAX and to the hand-computed boxes."""
    kp0 = np.stack([np.linspace(10, 30, 21), np.linspace(20, 60, 21)], axis=-1)
    kp1 = np.full((21, 2), 100.0)
    kp2 = kp0 + 5.0
    ref, got = _both(np.stack([kp0, kp1, kp2]), np.float32([1, 1, 0]), [120.0, 160.0],
                     expand=1.5, min_size=8.0)
    np.testing.assert_array_equal(got, ref)
    np.testing.assert_array_equal(got, [[5, 10, 35, 70], [96, 96, 104, 104], [0, 0, 0, 0]])


def test_track_boxes_clip_to_frame():
    kp = np.stack([np.linspace(-40, 30, 21), np.linspace(10, 200, 21)], axis=-1)[None]
    ref, got = _both(kp, np.float32([1]), [120.0, 160.0], expand=1.0)
    np.testing.assert_array_equal(got, ref)
    x1, y1, x2, y2 = got[0]
    assert x1 >= 0 and y1 >= 0 and x2 <= 160 and y2 <= 120 and x2 > x1 and y2 > y1


@pytest.mark.parametrize("seed", range(6))
def test_track_boxes_random_match_jax_exactly(seed):
    """Random keypoints (inside, across and outside the frame), bool or f32
    validity, random expand and min_size: the same f32 boxes as JAX, bit
    for bit, on one frame and batched over frames (JAX's vmap)."""
    rng = np.random.default_rng(seed)
    B, S = 3, 4
    hw = np.float32([[rng.integers(40, 720), rng.integers(40, 1280)] for _ in range(B)])
    kp = (rng.uniform(-0.3, 1.3, (B, S, 21, 2)) * hw[:, None, None, ::-1]).astype(np.float32)
    kp[:, 0] = kp[:, 0, :1]  # a collapsed slot: min_size decides
    valid = rng.uniform(size=(B, S)) > 0.3
    if seed % 2:
        valid = valid.astype(np.float32)
    kw = {"expand": float(rng.uniform(1.0, 2.0)), "min_size": float(rng.uniform(4, 64))}
    ref = np.asarray(jax.vmap(lambda k, v, h: jax_track(k, v, h, **kw))(
        jnp.asarray(kp), jnp.asarray(valid), jnp.asarray(hw)))
    got = track_boxes_from_keypoints(torch.from_numpy(kp), torch.from_numpy(valid),
                                     torch.from_numpy(hw), **kw).numpy()
    np.testing.assert_array_equal(got, ref)
    for b in range(B):
        np.testing.assert_array_equal(_both(kp[b], valid[b], hw[b], **kw)[1], ref[b])


@pytest.fixture(scope="module")
def setup():
    jcfg, tcfg = tiny_configs("float32")
    params = sar_pipeline_params(jcfg, seed=31)
    jm, tm = mano_pair()
    rng = np.random.default_rng(5)
    B, S = 2, jcfg.max_hands
    hws = np.float32([[96, 128], [90, 120]])
    images = np.zeros((B, 96, 128, 3), np.float32)
    for b in range(B):
        h, w = hws[b].astype(int)
        images[b, :h, :w] = rng.integers(0, 256, (h, w, 3))
    Ks = np.stack([np.float32([[150.0, 0, 64], [0, 150.0, 48], [0, 0, 1]])] * B)
    # keypoints of hands somewhere in each frame, one slot invalid
    c = rng.uniform(0.3, 0.7, (B, S, 1, 2)) * hws[:, None, None, ::-1]
    kp2d = (c + rng.normal(scale=12.0, size=(B, S, 21, 2))).astype(np.float32)
    valid = np.array([[True, True], [True, False]])[:, :S]
    is_right = np.float32([[1, 0], [0, 1]])[:, :S]
    return jcfg, tcfg, params, jm, tm, (images, kp2d, is_right, valid, hws, Ks)


def test_infer_frames_tracked_matches_jax(setup):
    """The port's tracked program against JAX's jitted one on the same
    frames and previous-tick state: the same key set and shapes, every slot
    within f32 reassociation, root depth at the composed-oracle limit 2e-3;
    the boxes, scores, classes and validity exactly."""
    jcfg, tcfg, params, jm, tm, inputs = setup
    ref = jax.jit(lambda p, *a: jax_tracked(p, jm, *a, jcfg))(
        jax.tree_util.tree_map(jnp.asarray, params), *map(jnp.asarray, inputs))
    ref = {k: np.asarray(v) for k, v in ref.items()}
    with torch.inference_mode():
        got = infer_frames_tracked(to_port(params), tm, *map(torch.from_numpy, inputs), tcfg)
    got = {k: v.numpy() for k, v in got.items()}
    assert set(got) == set(ref)
    for k in ("boxes", "scores", "classes", "valid", "is_right"):
        np.testing.assert_array_equal(got[k], ref[k], err_msg=k)
    for b in range(ref["valid"].shape[0]):
        r = {k: v[b] for k, v in ref.items()}
        g = {k: v[b] for k, v in got.items()}
        depth = r.pop("root_depth")
        _same_slots(g, r, f"frame {b}")
        _same_slots({"root_depth": g["root_depth"], "boxes": g["boxes"], "valid": g["valid"]},
                    {"root_depth": depth, "boxes": r["boxes"], "valid": r["valid"]},
                    f"frame {b} depth", atol=2e-3)


def test_tracked_has_the_detect_schema_and_roundtrips_its_boxes(setup):
    """Keypoints whose tracked extent is the detector's boxes give the
    detect program's outputs (the box source is the only difference), with
    the key set and shapes of infer_frames."""
    _, tcfg, params, _, tm, (images, _, _, _, hws, Ks) = setup
    tp = to_port(params)
    with torch.inference_mode():
        det = infer_frames(tp, tm, *map(torch.from_numpy, (images, hws, Ks)), tcfg)
        boxes = det["boxes"].double()
        expand, min_size = 1.3, 2.0
        c = (boxes[..., :2] + boxes[..., 2:]) / 2.0
        wh = boxes[..., 2:] - boxes[..., :2]
        kp = c[..., None, :].expand(*boxes.shape[:2], 21, 2).clone()
        kp[..., 0, :] = c - wh / (2.0 * expand)
        kp[..., 1, :] = c + wh / (2.0 * expand)
        trk = infer_frames_tracked(tp, tm, torch.from_numpy(images), kp.float(), det["is_right"],
                                   det["valid"], torch.from_numpy(hws), torch.from_numpy(Ks), tcfg,
                                   track_expand=expand, track_min_size=min_size)
    assert set(trk) == set(det)
    for k in det:
        assert trk[k].shape == det[k].shape and trk[k].dtype == det[k].dtype, k
    ok = det["valid"] & (wh >= min_size).all(-1)
    assert ok.any()
    assert torch.equal(trk["boxes"][ok], det["boxes"][ok])
    for k in ("vertices", "keypoints_2d", "cam_t", "root_depth", "betas", "theta"):
        np.testing.assert_allclose(trk[k][ok].double().numpy(), det[k][ok].double().numpy(),
                                   atol=2e-3, err_msg=k)
