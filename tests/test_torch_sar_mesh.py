"""The ConvNeXt SAR backbone and SAR's full mesh recovery against the JAX
package: ConvNeXt (tiny) and its block, SAR with ConvNeXt-base, the
geometry sar_mesh needs (the patch affine, its inverse, the bilinear
sample, uvd <-> xyz), the uvd decode, and ``sar_full_mesh`` with both
backbones and both root depths (RootNet's k value, a depth image).

Weights are numpy-made (test_torch_bridge.numpy_params) at the --tiny SAR
size (input 64, 2 x 2 features, 8 x 8 heatmaps; the backbones keep their
full widths). ConvNeXt's layer scale ``gamma`` is drawn O(1): JAX's init
puts it at 1e-6, which would leave every block's output out of the sum.
The JAX side is compiled with XLA's excess precision off (jax_exact).

Limits: f32 at the JAX package's own (SAR uvd atol 1e-2 rtol 1e-3,
tests/test_golden.py:113-123; root depth atol 2e-3,
tests/test_composed_entrypoints.py:213-221), the full mesh's pixel uvd and
metric xyz likewise; geometry at f32 rounding. bf16 trunks are held as in
tests/test_torch_sar.py: the port's bf16 output at most
BF16_ACCURACY_FACTOR times as far from JAX's f32 output as JAX's bf16 one.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from hamer_yolo_tpu.geometry import affine as jaff
from hamer_yolo_tpu.geometry import camera as jcam
from hamer_yolo_tpu.models import convnext as jcn
from hamer_yolo_tpu.models import sar as jsar
from hamer_yolo_tpu.pipeline import sar_mesh as jsm
from hamer_yolo_tpu_torch.geometry import affine as taff
from hamer_yolo_tpu_torch.geometry import camera as tcam
from hamer_yolo_tpu_torch.models import convnext as tcn
from hamer_yolo_tpu_torch.models import sar as tsar
from hamer_yolo_tpu_torch.pipeline import sar_mesh as tsm
from test_torch_bridge import calibrate_sar_bn, jax_exact, mano_pair, numpy_params, to_port

torch.set_num_threads(1)

SMALL = dict(input_size=64, feature_hw=2, heatmap_size=8)
BF16_ACCURACY_FACTOR = 2.0


def _f64(a):
    return np.asarray(a.detach().float() if isinstance(a, torch.Tensor) else
                      jnp.asarray(a).astype(jnp.float32), np.float64)


def _hold(got, ref, ref32, dtype, atol, rtol=0.0):
    if dtype == "float32":
        np.testing.assert_allclose(got, ref, rtol=rtol, atol=atol)
        return
    floor = np.abs(ref - ref32).max()
    assert floor > 0
    assert np.abs(got - ref32).max() <= BF16_ACCURACY_FACTOR * floor, (
        f"port bf16 vs JAX f32 {np.abs(got - ref32).max():.4g}, JAX bf16 vs f32 {floor:.4g}")


# ------------------------------------------------------------------- ConvNeXt
@pytest.fixture(scope="module")
def convnext_tiny():
    params = jax.tree_util.tree_map(np.asarray, numpy_params(
        lambda k: jcn.init_convnext(k, "tiny"), 1))
    x = np.random.default_rng(0).normal(size=(2, 64, 64, 3)).astype(np.float32)
    return params, x


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_convnext_tiny_forward_matches_jax(convnext_tiny, dtype):
    """Stem, downsamples and 18 blocks: (B, H/32, W/32, 768); f32 at 2e-3."""
    params, x = convnext_tiny
    jp = jax.tree_util.tree_map(jnp.asarray, params)
    run = lambda dt: _f64(jax_exact(  # noqa: E731
        lambda pp, a: jcn.convnext_forward(pp, a.astype(dt), "tiny"), jp, x))
    ref, ref32 = run(dtype), run("float32")
    got = _f64(tcn.convnext_forward(to_port(params), torch.from_numpy(x).to(
        getattr(torch, dtype))))
    assert got.shape == (2, 2, 2, 768) and np.isfinite(got).all()
    _hold(got, ref, ref32, dtype, atol=2e-3)


def test_convnext_block_matches_jax(convnext_tiny):
    """One block on the same bf16 input: the depthwise conv, LN, pw1, GELU,
    pw2, gamma and the residual round per op in bf16; within one rounding
    of the largest value (the conv and the linears sum in another order)."""
    params, _ = convnext_tiny
    blk = params["stages"][1][0]
    x = (np.random.default_rng(1).normal(size=(2, 8, 8, 192))).astype(np.float32)
    ref = _f64(jax_exact(lambda pp, a: jcn._block(pp, a.astype(jnp.bfloat16), 192),
                         jax.tree_util.tree_map(jnp.asarray, blk), x))
    got = _f64(tcn._block(to_port(blk), torch.from_numpy(x).bfloat16()))
    ulp_of_max = 2.0 ** (np.floor(np.log2(np.abs(ref).max())) - 7)
    assert np.abs(got - ref).max() <= ulp_of_max and (got != ref).mean() <= 0.01


def test_convnext_init_and_bridge():
    """The seeded init makes JAX's tree for every variant (keys and shapes;
    gamma at JAX's 1e-6); the bridge maps JAX's tree with no leaf refused,
    the depthwise (7, 7, 1, C) HWIO weight to (C, 1, 7, 7)."""
    gen = torch.Generator().manual_seed(0)
    shapes = lambda t: jax.tree_util.tree_map(lambda a: tuple(a.shape), t)  # noqa: E731
    for variant in ("tiny", "small"):
        ref = jax.eval_shape(lambda k: jcn.init_convnext(k, variant), jax.random.PRNGKey(0))
        got = tcn.init_convnext(gen, variant)
        bridged = to_port(jax.tree_util.tree_map(lambda a: np.zeros(a.shape, np.float32), ref))
        assert shapes(bridged) == shapes(got), variant
    assert float(got["stages"][0][0]["gamma"][0]) == pytest.approx(1e-6)
    assert tuple(got["stages"][0][0]["dwconv"]["w"].shape) == (96, 1, 7, 7)


# ---------------------------------------------------------------- SAR (base)
@pytest.fixture(scope="module")
def sar_convnext():
    jm, _ = mano_pair()
    cfg = jsar.SarConfig(**SMALL, backbone="convnext")
    params = jax.tree_util.tree_map(np.asarray, numpy_params(
        lambda k: jsar.init_sar(k, jm.v_template, cfg), 2))
    rng = np.random.default_rng(3)
    x = rng.normal(size=(4, 64, 64, 3)).astype(np.float32)
    k = rng.uniform(0.5, 2.0, 4).astype(np.float32)
    return params, x, k


def _cfgs(dtype, backbone="convnext"):
    return (jsar.SarConfig(**SMALL, backbone=backbone, compute_dtype=dtype),
            tsar.SarConfig(**SMALL, backbone=backbone, compute_dtype=dtype))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_sar_convnext_forward_matches_jax(sar_convnext, dtype):
    """ConvNeXt-base (1024 channels) -> SAR head: (B, 799, 3) uvd at
    tests/test_golden.py's SAR limit in f32."""
    params, x, _ = sar_convnext
    jp = jax.tree_util.tree_map(jnp.asarray, params)
    run = lambda dt: _f64(jax_exact(  # noqa: E731
        lambda pp, a: jsar.sar_forward(pp, a, _cfgs(dt)[0]), jp, x))
    ref, ref32 = run(dtype), run("float32")
    got = _f64(tsar.sar_forward(to_port(params), torch.from_numpy(x), _cfgs(dtype)[1]))
    assert got.shape == (4, 799, 3) and np.isfinite(got).all()
    _hold(got, ref, ref32, dtype, atol=1e-2, rtol=1e-3)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_sar_convnext_root_depth_matches_jax(sar_convnext, dtype):
    """ConvNeXt-base -> RootNet depth: the composed-oracle limit 2e-3 in f32."""
    params, x, k = sar_convnext
    jp = jax.tree_util.tree_map(jnp.asarray, params)
    run = lambda dt: _f64(jax_exact(  # noqa: E731
        lambda pp, a, kk: jsar.estimate_root_depth(pp, a, kk, _cfgs(dt)[0]), jp, x, k))
    ref, ref32 = run(dtype), run("float32")
    got = _f64(tsar.estimate_root_depth(to_port(params), torch.from_numpy(x),
                                        torch.from_numpy(k), _cfgs(dtype)[1]))
    assert got.shape == (4,)
    _hold(got, ref, ref32, dtype, atol=2e-3)


# ------------------------------------------------------------------ geometry
def test_patch_affine_and_inverse_match_jax():
    """gen_trans_from_patch (scale and rotation too, and inv) over a batch of
    boxes against JAX's per-box function, and invert_affine."""
    rng = np.random.default_rng(4)
    n = 6
    cx, cy = rng.uniform(0, 200, n).astype(np.float32), rng.uniform(0, 150, n).astype(np.float32)
    w, h = rng.uniform(5, 120, n).astype(np.float32), rng.uniform(5, 120, n).astype(np.float32)
    for scale, rot, inv in ((1.0, 0.0, False), (1.3, 25.0, False), (0.8, -40.0, True)):
        ref = np.stack([np.asarray(jax.jit(lambda a, b, c, d: jaff.gen_trans_from_patch(
            a, b, c, d, 64.0, 48.0, scale, rot, inv))(cx[i], cy[i], w[i], h[i]))
            for i in range(n)])
        got = taff.gen_trans_from_patch(*map(torch.from_numpy, (cx, cy, w, h)), 64.0, 48.0,
                                        scale, rot, inv).numpy()
        np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-4)
        np.testing.assert_allclose(taff.invert_affine(torch.from_numpy(ref)).numpy(),
                                   np.asarray(jax.jit(jaff.invert_affine)(ref)),
                                   rtol=1e-5, atol=1e-4)


def test_bilinear_sample_matches_jax():
    """Taps inside, straddling every edge and wholly outside (the border
    value), at random and integer coordinates."""
    rng = np.random.default_rng(5)
    img = rng.uniform(0, 3, (9, 11, 2)).astype(np.float32)
    xs = np.concatenate([rng.uniform(-2, 13, 40), [0, 10, -1, 10.5, 11]]).astype(np.float32)
    ys = np.concatenate([rng.uniform(-2, 11, 40), [0, 8, 3, -0.5, 9]]).astype(np.float32)
    for border in (0.0, 7.0):
        ref = np.asarray(jax.jit(lambda i, a, b: jaff.bilinear_sample(i, a, b, border))(
            img, xs, ys))
        got = taff.bilinear_sample(torch.from_numpy(img), torch.from_numpy(xs),
                                   torch.from_numpy(ys), border).numpy()
        np.testing.assert_allclose(got, ref, rtol=1e-6, atol=1e-6)


def test_uvd_xyz_match_jax_and_round_trip():
    rng = np.random.default_rng(6)
    uvd = np.concatenate([rng.uniform(0, 300, (2, 5, 2)), rng.uniform(0.3, 2, (2, 5, 1))],
                         -1).astype(np.float32)
    K = np.array([[[310, 0, 150], [0, 300, 120], [0, 0, 1]],
                  [[500, 0, 160], [0, 520, 90], [0, 0, 1]]], np.float32)
    xyz = tcam.uvd2xyz(torch.from_numpy(uvd), torch.from_numpy(K))
    np.testing.assert_allclose(xyz.numpy(), np.asarray(jax.jit(jcam.uvd2xyz)(uvd, K)),
                               rtol=1e-6, atol=1e-7)
    back = tcam.xyz2uvd(xyz, torch.from_numpy(K))
    np.testing.assert_allclose(back.numpy(), np.asarray(jax.jit(jcam.xyz2uvd)(
        np.asarray(xyz), K)), rtol=1e-6, atol=1e-4)
    np.testing.assert_allclose(back.numpy(), uvd, rtol=1e-5, atol=1e-3)


def test_decode_and_depth_sample_match_jax():
    """decode_sar_uvd (the asymmetric (uv + 0.5) * input_size, the inverse
    affine, the de-flip) and the depth image's bilinear root lookup."""
    rng = np.random.default_rng(7)
    coords = rng.uniform(-1, 1, (3, 799, 3)).astype(np.float32)
    root = rng.uniform(0.4, 1.2, 3).astype(np.float32)
    bb2img = np.concatenate([rng.uniform(0.2, 1.5, (3, 2, 2)), rng.uniform(0, 90, (3, 2, 1))],
                            -1).astype(np.float32)
    flip = np.array([0, 1, 0], np.float32)
    ref = jax.jit(lambda *a: jsm.decode_sar_uvd(*a, 0.3, 64))(coords, root, bb2img,
                                                               np.float32(160), flip)
    got = tsm.decode_sar_uvd(*map(torch.from_numpy, (coords, root, bb2img)), 160.0,
                             torch.from_numpy(flip), 0.3, 64)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-6, atol=1e-4)
    depth = rng.uniform(0.3, 1.5, (40, 50)).astype(np.float32)
    uv = np.array([[3.5, 4.25], [49.5, 10.0], [-3.0, 5.0]], np.float32)
    np.testing.assert_allclose(
        tsm.sample_depth_at_root(torch.from_numpy(depth), torch.from_numpy(uv)).numpy(),
        np.asarray(jax.jit(jsm.sample_depth_at_root)(depth, uv)), rtol=1e-6, atol=1e-6)


# ------------------------------------------------------------- sar_full_mesh
@pytest.fixture(scope="module")
def frame():
    rng = np.random.default_rng(8)
    img = rng.uniform(0, 255, (90, 120, 3)).astype(np.float32)
    boxes = np.array([[10, 20, 60, 70], [50, 5, 110, 80], [0, 0, 30, 30], [40, 40, 100, 88]],
                     np.float32)
    K = np.array([[300, 0, 60], [0, 310, 45], [0, 0, 1]], np.float32)
    depth = rng.uniform(0.3, 1.5, (90, 120)).astype(np.float32)
    return img, boxes, np.array([90, 120], np.float32), K, np.array([0, 1, 0, 1], np.float32), \
        depth


@pytest.mark.parametrize("root", ["k_value", "depth_image"])
@pytest.mark.parametrize("backbone", ["resnet34", "convnext"])
def test_sar_full_mesh_matches_jax(frame, backbone, root):
    """Four slots of one frame (two de-flipped, one at the image's corner),
    f32: uvd in pixels at the SAR limit (atol 1e-2, rtol 1e-3), xyz and
    root depth at 2e-3 m."""
    img, boxes, hw, K, flip, depth = frame
    jm, _ = mano_pair()
    jc, tc = _cfgs("float32", backbone)
    params = jax.tree_util.tree_map(np.asarray, numpy_params(
        lambda k: jsar.init_sar(k, jm.v_template, jc), 2))
    if backbone == "resnet34":
        calibrate_sar_bn(params, np.random.default_rng(9).normal(
            size=(8, 64, 64, 3)).astype(np.float32))
    jp = jax.tree_util.tree_map(jnp.asarray, params)
    dimg = depth if root == "depth_image" else None
    args = (img, boxes, hw, K, flip) + ((dimg,) if dimg is not None else ())
    ref = jax_exact(lambda pp, *a: jsm.sar_full_mesh(pp, *a[:4], jc, *a[4:]), jp, *args)
    got = tsm.sar_full_mesh(to_port(params), *map(torch.from_numpy, args[:4]), tc,
                            *map(torch.from_numpy, args[4:]))
    assert set(got) == set(ref)
    assert got["mesh_uvd"].shape == (4, 778, 3) and got["pose_xyz"].shape == (4, 21, 3)
    for key in ("mesh_uvd", "pose_uvd"):
        np.testing.assert_allclose(got[key].numpy(), np.asarray(ref[key]), rtol=1e-3, atol=1e-2,
                                   err_msg=key)
    for key in ("mesh_xyz", "pose_xyz", "root_depth"):
        np.testing.assert_allclose(got[key].numpy(), np.asarray(ref[key]), rtol=0, atol=2e-3,
                                   err_msg=key)
    assert all(torch.isfinite(v).all() for v in got.values())
