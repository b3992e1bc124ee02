"""Model parity: YOLOv7 (img 64), MANO LBS and HaMeR (tiny) against the JAX
package on numpy-made weights, and the port fed the golden-fixture weights
through the bridge against tests/fixtures/hamer_tiny_golden.npz."""
import os
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from hamer_yolo_tpu.models.hamer import hamer_forward as jax_hamer_forward
from hamer_yolo_tpu.models.hamer import init_hamer as jax_init_hamer
from hamer_yolo_tpu.models.mano import mano_forward_rotmat as jax_mano_forward
from hamer_yolo_tpu.models.yolov7 import init_yolov7 as jax_init_yolov7
from hamer_yolo_tpu.models.yolov7 import yolov7_forward as jax_yolov7_forward
from hamer_yolo_tpu_torch.models.hamer import hamer_forward
from hamer_yolo_tpu_torch.models.mano import mano_forward_rotmat
from hamer_yolo_tpu_torch.models.yolov7.model import yolov7_forward
from test_torch_bridge import jax_exact, mano_pair, numpy_params, tiny_configs, to_port

torch.set_num_threads(1)

TESTS = os.path.dirname(os.path.abspath(__file__))
GOLDEN = os.path.join(TESTS, "fixtures", "hamer_tiny_golden.npz")
HAMER_KEYS = ("pred_cam", "pred_cam_t", "focal_length", "pred_keypoints_3d",
              "pred_vertices", "pred_keypoints_2d", "betas")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_yolov7_forward_matches_jax(dtype):
    jcfg, tcfg = tiny_configs(dtype)
    params = numpy_params(lambda k: jax_init_yolov7(k, jcfg.yolo), seed=5)
    x = np.random.default_rng(5).uniform(0, 1, (2, 64, 64, 3)).astype(np.float32)
    jp = jax.tree_util.tree_map(jnp.asarray, params)
    ref = np.asarray(jax_exact(lambda i: jax_yolov7_forward(jp, i, jcfg.yolo), jnp.asarray(x)))
    got = yolov7_forward(to_port(params), torch.from_numpy(x), tcfg.yolo).numpy()
    assert got.shape == ref.shape == (2, 3 * (8 * 8 + 4 * 4 + 2 * 2), 8)
    # f32: conv sum order only. bf16 trunk: single bf16-ulp flips from the
    # conv accumulation order, carried through ~100 layers into the f32
    # decode; xywh are in pixels (<= 64 at this size), scores in [0, 1].
    tol = 1e-4 if dtype == "float32" else 0.05
    np.testing.assert_allclose(got, ref, rtol=tol, atol=tol)


def test_mano_forward_matches_jax():
    from hamer_yolo_tpu.geometry.rotations import aa_to_rotmat

    jm, tm = mano_pair()
    rng = np.random.default_rng(7)
    rot = np.array(aa_to_rotmat(jnp.asarray(rng.normal(scale=0.5, size=(3, 16, 3))
                                              .astype(np.float32))))
    betas = rng.normal(size=(3, 10)).astype(np.float32)
    ref = jax_mano_forward(jm, jnp.asarray(rot[:, :1]), jnp.asarray(rot[:, 1:]), jnp.asarray(betas))
    got = mano_forward_rotmat(tm, torch.from_numpy(rot[:, :1]), torch.from_numpy(rot[:, 1:]),
                              torch.from_numpy(betas))
    # f32 einsum reassociation only (meters, values ~0.1)
    np.testing.assert_allclose(got.vertices.numpy(), np.asarray(ref.vertices), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(got.joints.numpy(), np.asarray(ref.joints), rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_hamer_forward_matches_jax(dtype):
    jcfg, tcfg = tiny_configs(dtype)
    jm, tm = mano_pair()
    params = numpy_params(lambda k: jax_init_hamer(k, jcfg.hamer), seed=6)
    img = np.random.default_rng(6).normal(size=(3, 64, 64, 3)).astype(np.float32)
    jp = jax.tree_util.tree_map(jnp.asarray, params)
    ref = jax_exact(lambda i: {k: v for k, v in jax_hamer_forward(jp, jm, i, jcfg.hamer).items()
                               if k in HAMER_KEYS}, jnp.asarray(img))
    got = hamer_forward(to_port(params), tm, torch.from_numpy(img), tcfg.hamer)
    for k in HAMER_KEYS:
        r, g = np.asarray(ref[k]), got[k].numpy()
        assert g.shape == r.shape, k
        if dtype == "float32":
            # f32 reassociation and XLA's 1-ulp f32 rsqrt; the crop-space
            # keypoints are in pixels at focal 5000/64
            np.testing.assert_allclose(g, r, rtol=1e-4, atol=1e-4, err_msg=k)
        else:
            # bf16 backbone and head; the JAX package's bf16 tolerance
            # (tests/test_pallas_kernels.py:164-167), relative for pixels
            np.testing.assert_allclose(g, r, rtol=0.05, atol=0.05, err_msg=k)


@pytest.mark.skipif(not os.path.exists(GOLDEN), reason="fixture missing")
def test_hamer_golden_fixture_through_bridge():
    """tools/parity_check.build_hamer(seed=0, tiny=True): its params through
    the bridge, its MANO, the fixture's input -> the fixture's outputs at the
    fixture's own 1e-3 contract."""
    sys.path.insert(0, os.path.join(TESTS, "..", "tools"))
    from parity_check import build_hamer

    from hamer_yolo_tpu.core.mano_assets import load_mano_model, synthetic_mano_model
    from hamer_yolo_tpu_torch.models.hamer import HamerConfig
    from hamer_yolo_tpu_torch.models.mano import ManoModel
    from hamer_yolo_tpu_torch.models.mano_head import ManoHeadConfig
    from hamer_yolo_tpu_torch.models.vit import ViTConfig

    _, jcfg = build_hamer(seed=0, tiny=True)
    params = jax.jit(lambda k: jax_init_hamer(k, jcfg))(jax.random.PRNGKey(0))
    try:
        mano = ManoModel.from_arrays(load_mano_model("right"))
    except Exception:
        mano = ManoModel.from_arrays(synthetic_mano_model())
    v, h = jcfg.vit, jcfg.head
    cfg = HamerConfig(
        image_size=jcfg.image_size, crop_margin=jcfg.crop_margin,
        vit=ViTConfig(img_size=v.img_size, embed_dim=v.embed_dim, depth=v.depth,
                      num_heads=v.num_heads, compute_dtype=v.compute_dtype),
        head=ManoHeadConfig(dim=h.dim, context_dim=h.context_dim, depth=h.depth, heads=h.heads,
                            dim_head=h.dim_head, mlp_dim=h.mlp_dim))
    data = np.load(GOLDEN)
    got = hamer_forward(to_port(params), mano, torch.from_numpy(data["__input__"]), cfg)
    for k in data.files:
        if k == "__input__":
            continue
        np.testing.assert_allclose(got[k].numpy(), data[k], atol=1e-3, rtol=1e-3,
                                   err_msg=f"output {k} drifted from golden fixture")
