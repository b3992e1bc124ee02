"""The RootNet depth branch against the JAX package: batch norm, the
ResNet-34 trunk, the SAR head, RootNet's depth, RootNet's box and k value,
the SAR patch, the depth-refine lift, and the bridge's new leaves.

Weights are numpy-made (test_torch_bridge.numpy_params) with the trunk's BN
stats calibrated on the test's patches (calibrate_sar_bn), at the --tiny SAR
size (input 64, feature map 2x2, heatmaps 8x8; the trunk keeps ResNet-34's
full widths). The JAX side is compiled with XLA's excess precision off
(jax_exact), so both sides round bf16 where the source says.

bf16 tolerances. Batch norm is bit-identical, and each residual block fed the
same bf16 input agrees to one bf16 rounding of its largest value on all but
a few elements (the convolutions sum in another order and may round the
other way). Over the whole trunk those flips are amplified by 36 random
layers: the trunk's output is then held to a noise floor, not an absolute
limit: the port's bf16 trunk must be as accurate as JAX's, within a factor
BF16_ACCURACY_FACTOR: its largest distance over the batch from JAX's f32
trunk at most that many times JAX's bf16 trunk's. Port and JAX in bf16 are
not held to each other: with the same bf16 input and weights, one conv sum
rounded the other way in block 1 can move a random-weight trunk's root
depth by several percent, as far as bf16 itself moves it from f32. The
absolute limits of the JAX package (root depth atol 2e-3,
tests/test_composed_entrypoints.py:213-221; SAR uvd atol 1e-2 rtol 1e-3,
tests/test_golden.py:113-123) are f32 limits and hold the f32 trunk.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from hamer_yolo_tpu.core import nn as jnn
from hamer_yolo_tpu.geometry import boxes as jboxes
from hamer_yolo_tpu.geometry import camera as jcam
from hamer_yolo_tpu.models import resnet as jresnet
from hamer_yolo_tpu.models import sar as jsar
from hamer_yolo_tpu.pipeline.preprocess import sar_patch as jax_sar_patch
from hamer_yolo_tpu_torch.core import nn as tnn
from hamer_yolo_tpu_torch.core.bridge import from_jax_params
from hamer_yolo_tpu_torch.geometry import boxes as tboxes
from hamer_yolo_tpu_torch.geometry import camera as tcam
from hamer_yolo_tpu_torch.models import resnet as tresnet
from hamer_yolo_tpu_torch.models import sar as tsar
from hamer_yolo_tpu_torch.pipeline.preprocess import sar_patch
from test_torch_bridge import calibrate_sar_bn, jax_exact, mano_pair, numpy_params, to_port

torch.set_num_threads(1)

SMALL = dict(input_size=64, feature_hw=2, heatmap_size=8)
BF16_ACCURACY_FACTOR = 2.0  # |port bf16 - JAX f32| <= this x |JAX bf16 - JAX f32|
BLOCK_FRAC_FLIPPED = 0.005  # elements of one block's output that may differ


def _f64(a):
    return np.asarray(a.detach().float() if isinstance(a, torch.Tensor) else
                      jnp.asarray(a).astype(jnp.float32), np.float64)


@pytest.fixture(scope="module")
def sar():
    """numpy SAR weights with calibrated BN stats, eight patches and k values."""
    jm, _ = mano_pair()
    cfg = jsar.SarConfig(**SMALL)
    params = jax.tree_util.tree_map(
        np.asarray, numpy_params(lambda k: jsar.init_sar(k, jm.v_template, cfg), 5))
    rng = np.random.default_rng(1)
    x = rng.normal(size=(8, 64, 64, 3)).astype(np.float32)
    calibrate_sar_bn(params, x)
    k = rng.uniform(0.5, 2.0, 8).astype(np.float32)
    return params, x, k


def _cfgs(dtype):
    return jsar.SarConfig(**SMALL, compute_dtype=dtype), tsar.SarConfig(**SMALL,
                                                                       compute_dtype=dtype)


def _run_both(params, dtype, jfn, tfn, *args):
    """(port, JAX, JAX f32) outputs of the same function and inputs."""
    jc, tc = _cfgs(dtype)
    jp = jax.tree_util.tree_map(jnp.asarray, params)
    ref = _f64(jax_exact(lambda *a: jfn(jp, *a, jc), *args))
    got = _f64(tfn(to_port(params), *(torch.from_numpy(a) for a in args), tc))
    ref32 = _f64(jax_exact(lambda *a: jfn(jp, *a, _cfgs("float32")[0]), *args))
    return got, ref, ref32


def _hold(got, ref, ref32, dtype, atol, rtol=0.0):
    if dtype == "float32":
        np.testing.assert_allclose(got, ref, rtol=rtol, atol=atol)
        return
    floor = np.abs(ref - ref32).max()
    assert floor > 0
    assert np.abs(got - ref32).max() <= BF16_ACCURACY_FACTOR * floor, (
        f"port bf16 vs JAX f32 {np.abs(got - ref32).max():.4g}, JAX bf16 vs f32 {floor:.4g}")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_batch_norm_matches_jax(dtype):
    """Inference BN, every op in x's dtype: bit-identical in bf16."""
    rng = np.random.default_rng(0)
    bn = {"scale": 1 + 0.1 * rng.normal(size=64), "bias": 0.05 * rng.normal(size=64),
          "mean": 0.05 * rng.normal(size=64), "var": rng.uniform(0.5, 1.5, 64)}
    bn = {k: v.astype(np.float32) for k, v in bn.items()}
    x = (3 * rng.normal(size=(2, 8, 8, 64))).astype(np.float32)
    jbn = jax.tree_util.tree_map(jnp.asarray, bn)
    for eps in (1e-5, 1e-3):
        ref = _f64(jax_exact(lambda a: jnn.batch_norm(jbn, a.astype(dtype), eps=eps), x))
        got = _f64(tnn.batch_norm(from_jax_params(bn), torch.from_numpy(x).to(
            getattr(torch, dtype)), eps))
        if dtype == "bfloat16":
            np.testing.assert_array_equal(got, ref)
        else:
            np.testing.assert_allclose(got, ref, rtol=1e-6, atol=1e-6)


def test_avg_pool_global_matches_jax():
    x = np.random.default_rng(0).normal(size=(3, 4, 5, 6)).astype(np.float32)
    np.testing.assert_allclose(tnn.avg_pool_global(torch.from_numpy(x)).numpy(),
                               np.asarray(jnn.avg_pool_global(jnp.asarray(x))), rtol=1e-6,
                               atol=1e-7)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_resnet_blocks_match_jax(sar, dtype):
    """The stem and each residual block on JAX's own input of it: f32 to
    reassociation; bf16 within one rounding of the block's largest value,
    on all but BLOCK_FRAC_FLIPPED of the elements (conv sums in another
    order round the other way)."""
    params, x, _ = sar
    jb = jax.tree_util.tree_map(jnp.asarray, params["backbone"])
    tb = to_port(params)["backbone"]
    dt = getattr(torch, dtype)

    def check(ref, got, where):
        ref, got = _f64(ref), _f64(got)
        if dtype == "float32":
            np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-5, err_msg=where)
            return
        ulp_of_max = 2.0 ** (np.floor(np.log2(np.abs(ref).max())) - 7)
        assert np.abs(got - ref).max() <= ulp_of_max, where
        assert (got != ref).mean() <= BLOCK_FRAC_FLIPPED, where

    y = jnp.asarray(x).astype(dtype)
    stem = jax_exact(lambda a: jnn.max_pool(jax.nn.relu(jnn.batch_norm(
        jb["bn1"], jnn.conv2d(jb["conv1"], a, stride=2, padding=3), eps=1e-5)), 3, 2, padding=1), y)
    t_in = torch.from_numpy(x).to(dt)
    got = tnn.max_pool(torch.relu(tnn.batch_norm(tb["bn1"], tnn.conv2d(tb["conv1"], t_in, 2, 3),
                                                 1e-5)), 3, 2, 1)
    check(stem, got, "stem")
    y = stem
    for si, blocks in enumerate(params["backbone"]["stages"]):
        for bi in range(len(blocks)):
            stride = 2 if (bi == 0 and si > 0) else 1
            blk = jb["stages"][si][bi]
            ref = jax_exact(lambda a: jresnet._basic_block(blk, a, stride), y)
            t_in = torch.from_numpy(np.array(y.astype(jnp.float32))).to(dt)
            check(ref, tresnet._basic_block(tb["stages"][si][bi], t_in, stride), f"{si}.{bi}")
            y = ref


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_resnet34_forward_matches_jax(sar, dtype):
    """The whole trunk (sar_backbone_forward casts to the compute dtype);
    f32 at the JAX package's composed-oracle limit 2e-3."""
    params, x, _ = sar
    got, ref, ref32 = _run_both(params, dtype, jsar.sar_backbone_forward,
                                tsar.sar_backbone_forward, x)
    assert got.shape == (8, 2, 2, 512)
    _hold(got, ref, ref32, dtype, atol=2e-3)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_sar_forward_matches_jax(sar, dtype):
    """Trunk + SAIGB + graph convs + soft-argmax: (B, 799, 3) uvd; f32 at
    tests/test_golden.py's SAR limit."""
    params, x, _ = sar
    got, ref, ref32 = _run_both(params, dtype, jsar.sar_forward, tsar.sar_forward, x)
    assert got.shape == (8, 799, 3) and np.isfinite(got).all()
    _hold(got, ref, ref32, dtype, atol=1e-2, rtol=1e-3)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_estimate_root_depth_matches_jax(sar, dtype):
    """Trunk -> RootNet depth; f32 at the composed-oracle limit 2e-3."""
    params, x, k = sar
    got, ref, ref32 = _run_both(params, dtype, lambda p, a, kk, c: jsar.estimate_root_depth(
        p, a, kk, c), lambda p, a, kk, c: tsar.estimate_root_depth(p, a, kk, c), x, k)
    assert got.shape == (8,)
    _hold(got, ref, ref32, dtype, atol=2e-3)


def test_rootnet_depth_on_the_same_features_matches_jax(sar):
    """RootNet's head alone on JAX's bf16 trunk output: f32 pool and 1x1 conv,
    at the composed-oracle limit."""
    params, x, k = sar
    jc, _ = _cfgs("bfloat16")
    jp = jax.tree_util.tree_map(jnp.asarray, params)
    feats = jax_exact(lambda a: jsar.sar_backbone_forward(jp, a, jc), x)
    ref = np.asarray(jsar.rootnet_depth(jp, feats, jnp.asarray(k)))
    got = tsar.rootnet_depth(to_port(params), torch.from_numpy(
        np.array(feats.astype(jnp.float32))).bfloat16(), torch.from_numpy(k))
    np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=2e-3)


def test_process_bbox_and_k_value_match_jax():
    """RootNet's box (sanitise, aspect, x1.5) and k value, with masked
    slots' zero boxes, boxes past the image and degenerate ones: finite k
    everywhere (the area clamp)."""
    rng = np.random.default_rng(3)
    xywh = np.concatenate([rng.uniform(-20, 150, (12, 2)), rng.uniform(0, 90, (12, 2))], -1)
    xywh[:3] = 0.0  # masked slots
    xywh[3, 2] = 0.0  # zero width
    xywh = xywh.astype(np.float32)
    w, h, fx, fy = np.float32(160), np.float32(120), np.float32(200), np.float32(210)
    rb, rv = jboxes.process_bbox(jnp.asarray(xywh), w, h, (64.0, 64.0), 1.5)
    gb, gv = tboxes.process_bbox(torch.from_numpy(xywh), torch.tensor(w), torch.tensor(h),
                                 (64.0, 64.0), 1.5)
    np.testing.assert_allclose(gb.numpy(), np.asarray(rb), rtol=1e-6, atol=1e-6)
    np.testing.assert_array_equal(gv.numpy(), np.asarray(rv))
    rk = jcam.calculate_k_value(rb[:, 2:4], fx, fy, real_area=0.09)
    gk = tcam.calculate_k_value(gb[:, 2:4], torch.tensor(fx), torch.tensor(fy), real_area=0.09)
    np.testing.assert_allclose(gk.numpy(), np.asarray(rk), rtol=1e-6)
    assert torch.isfinite(gk).all() and not gv[:4].any()


def test_sar_patch_matches_jax():
    """SAR patches for every (frame, slot) at once against JAX's per-slot
    patch, masked zero boxes included; hamer_crop's limits
    (tests/test_torch_preprocess.py)."""
    rng = np.random.default_rng(4)
    imgs = rng.integers(0, 256, (2, 120, 160, 3)).astype(np.float32)
    pb = np.concatenate([rng.uniform(-30, 120, (2, 3, 2)), rng.uniform(5, 140, (2, 3, 2))], -1)
    pb[1, 2] = 0.0
    pb = pb.astype(np.float32)
    got = sar_patch(torch.from_numpy(imgs), torch.from_numpy(pb), 64).numpy()
    assert got.shape == (2, 3, 64, 64, 3) and np.isfinite(got).all()
    for b in range(2):
        for s in range(3):
            ref = jax.jit(lambda i, bb: jax_sar_patch(i, bb, 64))(imgs[b], pb[b, s])
            np.testing.assert_allclose(got[b, s], np.asarray(ref), rtol=1e-6, atol=1e-5)


def test_depth_refine_lift_matches_jax():
    """custom_cam_crop_to_full with depth_refine: tz is the depth, the scale
    is derived back from it; a zero depth stays finite."""
    rng = np.random.default_rng(5)
    n = 6
    cam = rng.normal(size=(n, 3)).astype(np.float32)
    center = rng.uniform(0, 160, (n, 2)).astype(np.float32)
    size = rng.uniform(0, 90, n).astype(np.float32)
    fx, fy, cx, cy = (rng.uniform(150, 250, n).astype(np.float32) for _ in range(4))
    depth = rng.uniform(0.2, 2.0, n).astype(np.float32)
    depth[0] = 0.0
    args = (cam, center, size, fx, fy, cx, cy)
    for refine in (None, depth):
        ref = jcam.custom_cam_crop_to_full(*map(jnp.asarray, args), depth_refine=None if
                                           refine is None else jnp.asarray(refine))
        got = tcam.custom_cam_crop_to_full(*map(torch.from_numpy, args), depth_refine=None if
                                           refine is None else torch.from_numpy(refine))
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-6, atol=1e-6)
        assert torch.isfinite(got).all()
    assert torch.equal(got[:, 2], torch.from_numpy(depth))


def test_bridge_maps_the_sar_tree(sar):
    """Every leaf of the JAX SAR tree has a rule: BN mean / var, the graph
    convs' adjacency, the template, the soft heatmap's beta; values kept."""
    params, _, _ = sar
    port = to_port(params)
    assert len(jax.tree_util.tree_leaves(params)) == len(jax.tree_util.tree_leaves(port))
    bn = params["backbone"]["stages"][1][0]["down_bn"]
    np.testing.assert_array_equal(port["backbone"]["stages"][1][0]["down_bn"]["var"].numpy(),
                                  bn["var"])
    np.testing.assert_array_equal(port["head"]["reg_z1"]["adj"].numpy(),
                                  params["head"]["reg_z1"]["adj"])
    assert tuple(port["head"]["saigb"]["template"].shape) == (778, 3)
    assert tuple(port["head"]["soft_heatmap"]["beta"].shape) == (799,)


@pytest.mark.parametrize("leaf", [
    {"adj": np.zeros((2, 3, 3), np.float32)},
    {"var": np.zeros((2, 2), np.float32)},
    {"beta": np.zeros(3, np.int32)},
], ids=["rank3_adj", "rank2_var", "int_beta"])
def test_bridge_still_refuses_unmapped_sar_leaves(leaf):
    with pytest.raises(KeyError, match="bridge: no mapping"):
        from_jax_params({"head": leaf})


def test_port_init_matches_jax_tree_and_convnext_raises():
    """init_sar makes JAX's tree (keys and shapes) with either backbone: the
    ConvNeXt-base one no longer raises (it is ported, models/convnext.py)."""
    jm, tm = mano_pair()
    gen = torch.Generator().manual_seed(0)
    shapes = lambda t: jax.tree_util.tree_map(lambda a: tuple(a.shape), t)  # noqa: E731
    for backbone in ("resnet34", "convnext"):
        cfg = jsar.SarConfig(**SMALL, backbone=backbone)
        ref = jax.eval_shape(lambda k: jsar.init_sar(k, jm.v_template, cfg),
                             jax.random.PRNGKey(0))
        got = tsar.init_sar(gen, tm.v_template, tsar.SarConfig(**SMALL, backbone=backbone))
        bridged = to_port(jax.tree_util.tree_map(lambda a: np.zeros(a.shape, np.float32), ref))
        assert shapes(bridged) == shapes(got), backbone
