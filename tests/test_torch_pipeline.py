"""The slice end to end: infer_frame and infer_frames at the --tiny config
(no SAR) against the JAX package on the same frames and numpy-made weights,
first in f32 for a tight comparison, then at the default bf16."""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from hamer_yolo_tpu.pipeline.frame import detect_hands as jax_detect_hands
from hamer_yolo_tpu.pipeline.frame import detect_hands_batched as jax_detect_hands_batched
from hamer_yolo_tpu.pipeline.frame import infer_frame as jax_infer_frame
from hamer_yolo_tpu.pipeline.frame import infer_frames as jax_infer_frames
from hamer_yolo_tpu_torch.pipeline.frame import (detect_hands, detect_hands_batched, infer_frame,
                                                 infer_frames)
from test_torch_bridge import jax_exact, mano_pair, np_tree, pipeline_params, tiny_configs, to_port

torch.set_num_threads(1)

B = 3
K = np.float32([[200.0, 0, 80], [0, 200.0, 60], [0, 0, 1]])


def _inputs():
    rng = np.random.default_rng(0)
    imgs = rng.integers(0, 255, (B, 120, 160, 3)).astype(np.float32)
    hws = np.tile(np.float32([120.0, 160.0]), (B, 1))
    return imgs, hws, np.tile(K, (B, 1, 1))


def _check_frame(got, ref, dtype, where):
    """Match slots by box, not by index: near-tied detector scores may order
    equal-score candidates differently (ROADMAP F3)."""
    valid = ref["valid"]
    assert valid.sum() == got["valid"].sum(), where
    for i in np.flatnonzero(valid):
        hit = np.flatnonzero(got["valid"] & (got["boxes"] == ref["boxes"][i]).all(-1))
        assert hit.size, f"{where}: slot {i} box {ref['boxes'][i]} not found"
        j = hit[0]
        for k in ref:
            r, g = ref[k][i], got[k][j]
            if k in ("boxes", "classes", "is_right", "valid"):
                np.testing.assert_array_equal(g, r, err_msg=f"{where}:{k}")
            elif dtype == "float32":
                # f32 reassociation and XLA's 1-ulp f32 rsqrt; full-image
                # keypoints are pixels in the thousands, hence rtol
                np.testing.assert_allclose(g, r, rtol=1e-4, atol=1e-4, err_msg=f"{where}:{k}")
            else:
                # bf16 detector and backbone: the tolerance the JAX package
                # pins its own two bf16 program forms to
                # (tests/test_pipeline.py::test_infer_frames_stage_batched_matches)
                np.testing.assert_allclose(g, r, rtol=8e-3, atol=8e-3, err_msg=f"{where}:{k}")


@pytest.fixture(scope="module")
def setup():
    jm, tm = mano_pair()
    return jm, tm, _inputs()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_infer_frames_matches_jax(setup, dtype):
    jm, tm, (imgs, hws, Ks) = setup
    jcfg, tcfg = tiny_configs(dtype)
    params = pipeline_params(jcfg, seed=1)
    jp = jax.tree_util.tree_map(jnp.asarray, params)
    ref = np_tree(jax_exact(lambda i, h, k: jax_infer_frames(jp, jm, i, h, k, jcfg), imgs, hws, Ks))
    got = np_tree(infer_frames(to_port(params), tm, torch.from_numpy(imgs), torch.from_numpy(hws),
                               torch.from_numpy(Ks), tcfg))
    assert set(got) == set(ref) and got["vertices"].shape == (B, 2, 778, 3)
    assert ref["valid"].any(), "no valid slot: the comparison would be empty"
    for b in range(B):
        _check_frame({k: v[b] for k, v in got.items()}, {k: v[b] for k, v in ref.items()}, dtype,
                     f"frame {b}")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_infer_frame_matches_jax(setup, dtype):
    jm, tm, (imgs, hws, Ks) = setup
    jcfg, tcfg = tiny_configs(dtype)
    params = pipeline_params(jcfg, seed=2)
    jp = jax.tree_util.tree_map(jnp.asarray, params)
    ref = np_tree(jax_exact(lambda i, h, k: jax_infer_frame(jp, jm, i, h, k, jcfg),
                            imgs[0], hws[0], K))
    got = np_tree(infer_frame(to_port(params), tm, torch.from_numpy(imgs[0]),
                              torch.from_numpy(hws[0]), torch.from_numpy(K), tcfg))
    assert ref["valid"].any(), "no valid slot: the comparison would be empty"
    _check_frame(got, ref, dtype, "frame 0")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_detect_hands_matches_jax(setup, dtype):
    """The detector stage alone, one frame and the frame batch."""
    _, _, (imgs, hws, _) = setup
    jcfg, tcfg = tiny_configs(dtype)
    params = pipeline_params(jcfg, seed=3)
    jyolo = jax.tree_util.tree_map(jnp.asarray, params["yolo"])
    tyolo = to_port(params)["yolo"]
    ref = np_tree(jax_exact(lambda i, h: jax_detect_hands_batched(jyolo, i, h, jcfg), imgs, hws))
    got = np_tree(detect_hands_batched(tyolo, torch.from_numpy(imgs), torch.from_numpy(hws), tcfg))
    assert ref["valid"].any(), "no valid slot: the comparison would be empty"
    for b in range(B):
        _check_frame({k: v[b] for k, v in got.items()}, {k: v[b] for k, v in ref.items()}, dtype,
                     f"frame {b}")
    ref1 = np_tree(jax_exact(lambda i, h: jax_detect_hands(jyolo, i, h, jcfg), imgs[0], hws[0]))
    got1 = np_tree(detect_hands(tyolo, torch.from_numpy(imgs[0]), torch.from_numpy(hws[0]), tcfg))
    _check_frame(got1, ref1, dtype, "single frame")
