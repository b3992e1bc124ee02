"""The JAX package's library functions in the port (ROADMAP Queue 1 item 7)
against the JAX package: the train-to-deploy fusion (core/nn.fold_bn_into_conv,
models/yolov7/blocks.repconv_fuse, a tiny training-form YOLOv7 folded block
by block), core/nn's frequency_embed, adaptive_layer_norm and num_params,
models/mano's sar_joint_regressor and mano_template,
pipeline/preprocess.crop_square_patch, pipeline/reconstruct's
project_overlay and _mano_from_aa_fn, and load_pipeline. Inputs and weights
are made with numpy from a seed and go through core/bridge.py."""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from hamer_yolo_tpu.core import nn as jnn
from hamer_yolo_tpu.models import mano as jmano_mod
from hamer_yolo_tpu.models.yolov7 import blocks as JB
from hamer_yolo_tpu.models.yolov7 import model as JY
from hamer_yolo_tpu_torch.core import nn
from hamer_yolo_tpu_torch.core.bridge import from_jax_params
from hamer_yolo_tpu_torch.models import mano as tmano_mod
from hamer_yolo_tpu_torch.models.yolov7 import blocks as TB
from hamer_yolo_tpu_torch.models.yolov7 import model as TY
from test_torch_bridge import mano_pair, numpy_params

torch.set_num_threads(1)

# f32 leaves computed by the same ops in the same order: equal to an ulp
LEAF_RTOL = 1e-6
# tests/test_yolo.py:53's limit for a RepConv against its fused form
FUSE_ATOL = 1e-4
# the f32 transcendental and rsqrt of the two libraries: a few ulps
F32_TOL = dict(rtol=1e-5, atol=1e-6)
# a tiny training-form YOLOv7: every foldable block (conv + BN, RepConv with
# and without the identity branch, SPPCSPC) and the DET head
FOLD_SPEC = [(-1, "C", (8, 3, 2)), (-1, "C", (16, 3, 2)), (-1, "REP", (16,)),
             (-1, "C", (16, 3, 2)), (-1, "SPP", (16,)), (-1, "MP", ()),
             (-2, "C", (24, 3, 2)), ((-1, -2), "CAT", ()), (-1, "REP", (32,)),
             ((2, 4, 8), "DET", ())]


def _bn(rng, c):
    return {"scale": rng.uniform(0.5, 1.5, c), "bias": rng.normal(size=c),
            "mean": rng.normal(size=c), "var": rng.uniform(0.5, 2.0, c)}


def _f32(tree):
    return jax.tree_util.tree_map(lambda a: np.asarray(a, np.float32), tree)


def _hwio_to_oihw(w):
    return np.asarray(w).transpose(3, 2, 0, 1)


@pytest.mark.parametrize("bias", [False, True])
def test_fold_bn_into_conv_matches_jax(bias):
    """Leaf for leaf against JAX after the HWIO -> OIHW transpose, the scale
    on the output channels (OIHW's dim 0, HWIO's last)."""
    rng = np.random.default_rng(0)
    conv = {"w": rng.normal(size=(3, 3, 5, 7))}
    if bias:
        conv["b"] = rng.normal(size=7)
    conv, bn = _f32(conv), _f32(_bn(rng, 7))
    ref = jnn.fold_bn_into_conv(jax.tree_util.tree_map(jnp.asarray, conv),
                                jax.tree_util.tree_map(jnp.asarray, bn))
    got = nn.fold_bn_into_conv(from_jax_params(conv), from_jax_params(bn))
    assert set(got) == {"w", "b"}
    np.testing.assert_allclose(got["w"].numpy(), _hwio_to_oihw(ref["w"]), rtol=LEAF_RTOL)
    np.testing.assert_allclose(got["b"].numpy(), np.asarray(ref["b"]), rtol=LEAF_RTOL,
                               atol=1e-7)


@pytest.mark.parametrize("c1,c2,s", [(8, 8, 1), (8, 12, 1), (8, 8, 2)],
                         ids=["identity", "widen", "stride2"])
def test_repconv_fuse_matches_jax(c1, c2, s):
    """The fused 3x3 leaf for leaf against JAX's, and the fused conv against
    the three branches in the port at tests/test_yolo.py:53's 1e-4; a tree
    that has ``reparam`` comes back as it is."""
    rng = np.random.default_rng(1)
    p = {"dense": {"w": rng.normal(size=(3, 3, c1, c2)) / 5},
         "1x1": {"w": rng.normal(size=(1, 1, c1, c2)) / 3},
         "dense_bn": _bn(rng, c2), "1x1_bn": _bn(rng, c2)}
    if c1 == c2 and s == 1:
        p["id_bn"] = _bn(rng, c1)
    p = _f32(p)
    ref = JB.repconv_fuse(jax.tree_util.tree_map(jnp.asarray, p))["reparam"]
    tp = from_jax_params(p)
    fused = TB.repconv_fuse(tp)
    np.testing.assert_allclose(fused["reparam"]["w"].numpy(), _hwio_to_oihw(ref["w"]),
                               rtol=LEAF_RTOL, atol=1e-7)
    np.testing.assert_allclose(fused["reparam"]["b"].numpy(), np.asarray(ref["b"]),
                               rtol=LEAF_RTOL, atol=1e-7)
    x = torch.from_numpy(rng.normal(size=(2, 16, 16, c1)).astype(np.float32))
    np.testing.assert_allclose(TB.repconv(fused, x, s).numpy(), TB.repconv(tp, x, s).numpy(),
                               atol=FUSE_ATOL)
    assert TB.repconv_fuse(fused) is fused


def fold_yolo_tree(tree):
    """chip_smoke.fold_yolo_tree: every conv + BN folded, every RepConv fused
    (the walk over blocks is the caller's, as in JAX)."""
    if isinstance(tree, dict):
        if "dense" in tree:
            return TB.repconv_fuse(tree)
        if "conv" in tree and "bn" in tree:
            rest = {k: fold_yolo_tree(v) for k, v in tree.items() if k not in ("conv", "bn")}
            return {**rest, "conv": nn.fold_bn_into_conv(tree["conv"], tree["bn"])}
        return {k: fold_yolo_tree(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(fold_yolo_tree(v) for v in tree)
    return tree


def test_folded_training_yolo_matches_jax_training_form():
    """A tiny training-form YOLOv7 (numpy weights and BN stats), folded block
    by block into the deploy form, against JAX's training-form forward with
    BN in inference form: the head maps at tests/test_yolo.py:53's 1e-4."""
    jcfg = JY.YoloConfig(nc=3, img_size=64, compute_dtype="float32")
    tcfg = TY.YoloConfig(nc=3, img_size=64, compute_dtype="float32")
    params = jax.tree_util.tree_map(np.asarray, numpy_params(
        lambda k: JY.init_yolov7(k, jcfg, deploy=False, spec=FOLD_SPEC), 5))
    x = np.random.default_rng(6).uniform(size=(2, 64, 64, 3)).astype(np.float32)
    ref = jax.jit(lambda p, xx: JY.yolov7_backbone_forward(p, xx, jcfg, spec=FOLD_SPEC))(
        jax.tree_util.tree_map(jnp.asarray, params), jnp.asarray(x))
    train = from_jax_params(params)
    deploy = fold_yolo_tree(train)
    assert "reparam" in deploy["layers"][2] and "bn" not in deploy["layers"][0]
    with torch.no_grad():
        got = TY.yolov7_backbone_forward(deploy, torch.from_numpy(x), tcfg, FOLD_SPEC)
        again = TY.yolov7_backbone_forward(train, torch.from_numpy(x), tcfg, FOLD_SPEC)
    for g, a, r in zip(got, again, ref, strict=True):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), atol=FUSE_ATOL)
        np.testing.assert_allclose(g.numpy(), a.numpy(), atol=FUSE_ATOL)


def test_frequency_embed_matches_jax():
    x = np.random.default_rng(2).normal(size=(2, 5, 3)).astype(np.float32)
    for nf, mx in ((3, None), (4, 6)):
        ref = np.asarray(jnn.frequency_embed(jnp.asarray(x), nf, mx))
        got = nn.frequency_embed(torch.from_numpy(x), nf, mx).numpy()
        assert got.shape == ref.shape == (2, 5, 3 * (2 * nf + 1))
        np.testing.assert_allclose(got, ref, **F32_TOL)


def test_adaptive_layer_norm_matches_jax():
    """Weights through the bridge; the conditioning changes the output, as
    tests/test_misc.py checks JAX's."""
    p = _f32(numpy_params(lambda k: jnn.adaptive_layer_norm_init(k, 8, 4), 3))
    rng = np.random.default_rng(4)
    x = rng.normal(size=(2, 6, 8)).astype(np.float32)
    c1, c2 = (rng.normal(size=(2, 4)).astype(np.float32) for _ in range(2))
    tp = from_jax_params(p)
    for c in (c1, c2):
        ref = np.asarray(jnn.adaptive_layer_norm(jax.tree_util.tree_map(jnp.asarray, p),
                                                 jnp.asarray(x), jnp.asarray(c)))
        got = nn.adaptive_layer_norm(tp, torch.from_numpy(x), torch.from_numpy(c)).numpy()
        np.testing.assert_allclose(got, ref, **F32_TOL)
    assert set(nn.adaptive_layer_norm_init(torch.Generator().manual_seed(0), 8, 4)
               ["to_scale_shift"]) == {"w", "b"}
    assert not np.allclose(nn.adaptive_layer_norm(tp, torch.from_numpy(x), torch.from_numpy(c1)),
                           nn.adaptive_layer_norm(tp, torch.from_numpy(x), torch.from_numpy(c2)))


def test_num_params_counts_the_bridged_tree_as_jax():
    """The same count on the deploy YOLOv7 tree in both layouts (JAX's
    34-38 M, tests/test_yolo.py), and derived caches are not parameters."""
    jcfg = JY.YoloConfig(nc=3)
    shapes = jax.eval_shape(lambda k: JY.init_yolov7(k, jcfg), jax.random.PRNGKey(0))
    jtree = jax.tree_util.tree_map(lambda s: np.zeros(s.shape, np.float32), shapes)
    n = jnn.num_params(jtree)
    tree = from_jax_params(jtree)
    assert nn.num_params(tree) == n and 34e6 < n < 38e6
    nn.cast_weight(tree["layers"][0]["conv"]["w"], torch.bfloat16)  # a derived copy
    assert nn.num_params(tree) == n
    assert nn.num_params({"a": None, "b": [np.zeros(3), 2.0], "c": torch.zeros(2, 2)}) == 7


def test_sar_joint_regressor_and_template_match_jax():
    """The 21 x 778 regressor (fingertip one-hots with the reference's 445,
    the OpenPose order) and the template, against JAX's (tests/test_mano.py)."""
    jm, tm = mano_pair()
    ref = np.asarray(jmano_mod.sar_joint_regressor(jm))
    got = tmano_mod.sar_joint_regressor(tm).numpy()
    assert got.shape == (21, 778)
    np.testing.assert_array_equal(got, ref)
    assert got[4, 745] == 1.0 and got[12, 445] == 1.0  # thumb and middle tips, OpenPose order
    np.testing.assert_array_equal(tmano_mod.mano_template(tm).numpy(),
                                  np.asarray(jmano_mod.mano_template(jm)))


@pytest.mark.parametrize("box", [(40.0, 30.0, 33.0, 21.0), (5.5, 60.25, 80.0, 80.0)],
                         ids=["inside", "over-the-edge"])
def test_crop_square_patch_matches_jax(box):
    """One frame's crop through the banded-matmul warp (JAX's default
    WARP_IMPL "matmul"), uint8-rounded: equal to JAX's."""
    from hamer_yolo_tpu.pipeline import preprocess as jpre
    from hamer_yolo_tpu_torch.pipeline import preprocess as tpre

    img = np.random.default_rng(7).integers(0, 256, (64, 96, 3)).astype(np.float32)
    center, size = np.float32(box[:2]), np.float32(box[2:])
    ref = np.asarray(jax.jit(lambda i, c, s: jpre.crop_square_patch(i, c, s, (24, 32)))(
        jnp.asarray(img), jnp.asarray(center), jnp.asarray(size)))
    got = tpre.crop_square_patch(torch.from_numpy(img), torch.from_numpy(center),
                                 torch.from_numpy(size), (24, 32)).numpy()
    assert got.shape == (24, 32, 3)
    np.testing.assert_array_equal(got, ref)


def test_project_overlay_matches_jax():
    """The painter's overlay of a MANO mesh in front of a camera: the same
    pixels as JAX's (numpy + cv2.fillPoly on both sides)."""
    pytest.importorskip("cv2")
    from hamer_yolo_tpu.pipeline.reconstruct import project_overlay as jproject
    from hamer_yolo_tpu_torch.pipeline.reconstruct import project_overlay

    jm, tm = mano_pair()
    verts = np.asarray(tm.v_template, np.float64) + np.array([0.0, 0.0, 0.6])
    K = np.array([[500.0, 0, 64], [0, 500.0, 48], [0, 0, 1]])
    img = np.random.default_rng(8).integers(0, 256, (96, 128, 3)).astype(np.uint8)
    before = img.copy()
    got = project_overlay(img, verts, tm.faces, K)
    np.testing.assert_array_equal(got, jproject(img, verts, np.asarray(jm.faces), K))
    assert (got != img).any() and np.array_equal(img, before)  # drawn on a copy


def test_mano_from_aa_fn_matches_jax_and_is_cached():
    """(theta, betas) -> model-frame vertices, one function per model, against
    JAX's jitted one (f32 through aa_to_rotmat and LBS)."""
    from hamer_yolo_tpu.pipeline.reconstruct import _mano_from_aa_fn as jfn
    from hamer_yolo_tpu_torch.pipeline.reconstruct import _mano_from_aa_fn

    jm, tm = mano_pair()
    rng = np.random.default_rng(9)
    theta = (0.3 * rng.normal(size=48)).astype(np.float32)
    betas = rng.normal(size=10).astype(np.float32)
    fn = _mano_from_aa_fn(tm)
    assert _mano_from_aa_fn(tm) is fn
    ref = np.asarray(jfn(jm)(jnp.asarray(theta), jnp.asarray(betas)))
    got = fn(torch.from_numpy(theta), torch.from_numpy(betas)).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-6)


def test_load_pipeline_on_the_cpu(tmp_path):
    """load_pipeline(device="cpu") at a tiny override: JAX's contract
    (program, params, mano, cfg); the program runs a frame; a port
    checkpoint is read where it exists, the seeded init where it does not."""
    import hamer_yolo_tpu_torch
    from hamer_yolo_tpu_torch.core.checkpoint import save_checkpoint
    from hamer_yolo_tpu_torch.pipeline.frame import PipelineConfig
    from hamer_yolo_tpu_torch.pipeline.runner import FrameProgram, default_intrinsics
    from test_torch_bridge import tiny_configs
    from test_torch_state_dicts import port_tree_to_numpy

    _, tcfg = tiny_configs("float32")
    over = {"det_size": 64, "crop_size": 64, "yolo": tcfg.yolo, "hamer": tcfg.hamer,
            "sar": tcfg.sar}
    program, params, mano, cfg = hamer_yolo_tpu_torch.load_pipeline(max_hands=2, device="cpu",
                                                                    **over)
    assert isinstance(program, FrameProgram) and isinstance(cfg, PipelineConfig)
    assert cfg.max_hands == 2 and cfg.hamer.vit.depth == 2 and set(params) == {"yolo", "hamer",
                                                                              "sar"}
    frame = np.random.default_rng(10).integers(0, 256, (48, 80, 3)).astype(np.uint8)
    out = program(frame.astype(np.float32), default_intrinsics(frame.shape))
    assert out["vertices"].shape == (2, 778, 3) and np.isfinite(out["vertices"]).all()
    path = str(tmp_path / "p.npz")
    save_checkpoint(path, port_tree_to_numpy(params))
    _, again, _, _ = hamer_yolo_tpu_torch.load_pipeline(path, max_hands=2, device="cpu", **over)
    w = params["hamer"]["backbone"]["blocks"][0]["attn"]["qkv"]["w"]
    assert torch.equal(again["hamer"]["backbone"]["blocks"][0]["attn"]["qkv"]["w"], w)
    _, fresh, _, _ = hamer_yolo_tpu_torch.load_pipeline(str(tmp_path / "missing.npz"),
                                                        max_hands=2, device="cpu", **over)
    assert torch.equal(fresh["hamer"]["backbone"]["blocks"][0]["attn"]["qkv"]["w"], w)
