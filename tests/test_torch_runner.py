"""The runner on an image dir: the port's npy dicts against the JAX
process_image_dir on the same images and weights, OBJ files written, and
the port's CLI end to end."""
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from hamer_yolo_tpu.io.writers import load_hand_npy
from hamer_yolo_tpu.pipeline.runner import process_image_dir as jax_process_image_dir
from hamer_yolo_tpu_torch.cli.main import main
from hamer_yolo_tpu_torch.pipeline.runner import process_image_dir
from test_torch_bridge import mano_pair, pipeline_params, tiny_configs, to_port

torch.set_num_threads(1)


@pytest.fixture
def image_dir(tmp_path):
    import cv2

    rng = np.random.default_rng(0)
    d = tmp_path / "imgs"
    d.mkdir()
    for i, (h, w) in enumerate([(100, 120), (90, 130), (130, 70)]):
        cv2.imwrite(str(d / f"f{i}.png"), rng.integers(0, 255, (h, w, 3)).astype(np.uint8))
    return str(d)


def test_process_image_dir_matches_jax(image_dir, tmp_path):
    # f32 detector and backbone: the JAX runner jits with XLA's default
    # excess precision, which only f32 programs are immune to.
    jcfg, tcfg = tiny_configs("float32")
    params = pipeline_params(jcfg, seed=4)
    jm, tm = mano_pair()
    out_j, out_t = str(tmp_path / "jax"), str(tmp_path / "torch")
    sj = jax_process_image_dir(image_dir, out_j, jax.tree_util.tree_map(jnp.asarray, params), jm,
                               jcfg, progress=False)
    st = process_image_dir(image_dir, out_t, to_port(params), tm, tcfg, device="cpu",
                           progress=False)
    assert (st.frames, st.hands, st.skipped) == (sj.frames, sj.hands, sj.skipped) == (3, st.hands, 0)
    assert st.hands > 0, "no hand found: the comparison would be empty"
    for name in sorted(os.listdir(out_j)):
        if not name.endswith(".npy"):
            continue
        a = load_hand_npy(os.path.join(out_j, name))
        b = load_hand_npy(os.path.join(out_t, name))
        assert set(a) == set(b) == {"left", "right"}
        for side in a:
            assert (a[side] is None) == (b[side] is None), f"{name}:{side}"
            if a[side] is None:
                continue
            assert a[side]["is_right"] == b[side]["is_right"]
            for k in ("betas", "theta", "pose_hand", "pose_global", "cam_t"):
                # f32 reassociation only (see test_torch_pipeline)
                np.testing.assert_allclose(b[side][k], a[side][k], rtol=1e-4, atol=1e-4,
                                           err_msg=f"{name}:{side}:{k}")
    objs_j = sorted(os.listdir(os.path.join(out_j, "obj")))
    objs_t = sorted(os.listdir(os.path.join(out_t, "obj")))
    assert objs_t == objs_j and objs_t
    for name in objs_t:
        vj = np.loadtxt([ln for ln in open(os.path.join(out_j, "obj", name)) if ln.startswith("v ")],
                        usecols=(1, 2, 3))
        vt = np.loadtxt([ln for ln in open(os.path.join(out_t, "obj", name)) if ln.startswith("v ")],
                        usecols=(1, 2, 3))
        np.testing.assert_allclose(vt, vj, rtol=1e-4, atol=2e-6)  # 6 decimals written


def test_cli_infer_tiny(image_dir, tmp_path):
    out = str(tmp_path / "out")
    assert main(["infer", "--tiny", "--device", "cpu", "--input", image_dir, "--output", out]) == 0
    npys = sorted(f for f in os.listdir(out) if f.endswith(".npy"))
    assert npys == ["f0.npy", "f1.npy", "f2.npy"]
    results = load_hand_npy(os.path.join(out, npys[0]))
    assert set(results) == {"left", "right"}
