"""The port's converters (hamer_yolo_tpu_torch/core/convert.py) against the
JAX package's (hamer_yolo_tpu/core/convert.py) on the same torch-layout state
dicts, made from numpy trees in JAX layout (tests/test_torch_state_dicts.py):
every output leaf equal, dtype and bits. resize_pos_embed against JAX's
jax.image bicubic resize within 1e-6. KPFusion's converters (the RGB-D
branch) at a small config: the UNets are ResNet-18 whatever the config."""
import os

import numpy as np
import pytest
import torch

import jax

from hamer_yolo_tpu.core import convert as jcv
from hamer_yolo_tpu.models.yolov7 import model as JM
from hamer_yolo_tpu_torch.core import convert as tcv
from test_torch_bridge import mano_pair, numpy_params, tiny_configs
from test_torch_state_dicts import (assert_leaf_equal, centernet_state_dict, hamer_state_dict,
                                    kpfusion_state_dict, sar_state_dicts, write_kpfusion_file,
                                    write_reference_files, yolo_state_dict)
from test_torch_yolo_family import family_spec

torch.set_num_threads(1)


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


@pytest.fixture(scope="module")
def yolo_trees():
    """The full-width deploy yolov7 and its training form (BN, RepConv
    branches), numpy weights."""
    cfg = JM.YoloConfig(nc=3)
    deploy = _np_tree(numpy_params(lambda k: JM.init_yolov7(k, cfg), seed=1))
    train = _np_tree(numpy_params(lambda k: JM.init_yolov7(k, cfg, deploy=False), seed=2))
    return deploy, train


def test_yolov7_deploy_every_layer(yolo_trees):
    deploy, _ = yolo_trees
    sd = yolo_state_dict(deploy)
    got = tcv.convert_yolov7_state_dict(sd)
    assert_leaf_equal(got, jcv.convert_yolov7_state_dict(sd))
    assert_leaf_equal(got, deploy)  # and the round trip


def test_yolov7_training_form(yolo_trees):
    """Conv + BN folded, RepConv's 3x3 and 1x1 branches fused (the identity
    branch: test_variant_converters), IDetect's ImplicitA / ImplicitM fused
    into the head convs."""
    _, train = yolo_trees
    sd = yolo_state_dict(train, implicit_seed=3)
    assert "model.102.rbr_1x1.1.running_var" in sd and "model.105.ia.0.implicit" in sd
    assert_leaf_equal(tcv.convert_yolov7_state_dict(sd), jcv.convert_yolov7_state_dict(sd))


@pytest.mark.parametrize("head", ["DET", "BIN", "KPT"])
def test_variant_converters(head):
    """The family spec's training form: Ghost*, Stem, GhostStem, Swin,
    STCSP*, RepConv; its heads with implicits; KPT's keypoint convs."""
    spec = family_spec(head)
    cfg = JM.YoloConfig(nc=3, bin_count=5, nkpt=2)
    train = _np_tree(numpy_params(lambda k: JM.init_yolov7(k, cfg, deploy=False, spec=spec),
                                  seed=4))
    sd = yolo_state_dict(train, spec, implicit_seed=5)
    assert "model.25.rbr_identity.running_var" in sd
    got = tcv.convert_yolov7_state_dict(sd, spec)
    assert_leaf_equal(got, jcv.convert_yolov7_state_dict(sd, spec))
    assert got["layers"][19]["layers"][1]["attn"]["rpb"].shape == (15 * 15, 2)


def _orepa_sd(rng, prefix, cin, cout, idconv, identity):
    """A RepConv_OREPA's training-form keys (the reference's common.py:1076
    OREPA_3x3_RepConv inside RepConv_OREPA) with random values."""
    r = lambda *s: rng.normal(size=s).astype(np.float32)  # noqa: E731
    d = f"{prefix}.rbr_dense"
    sd = {f"{d}.vector": r(5, cout), f"{d}.weight_rbr_origin": r(cout, cin, 3, 3),
          f"{d}.weight_rbr_avg_conv": r(cout, cin, 1, 1), f"{d}.weight_rbr_avg_avg": r(3, 3),
          f"{d}.weight_rbr_pfir_conv": r(cout, cin, 1, 1), f"{d}.weight_rbr_prior": r(cout, 3, 3),
          f"{d}.weight_rbr_1x1_kxk_conv2": r(cout, cin, 3, 3),
          f"{d}.weight_rbr_gconv_dw": r(cin * 8, 1, 3, 3),
          f"{d}.weight_rbr_gconv_pw": r(cout, cin * 8, 1, 1),
          f"{prefix}.rbr_1x1.conv.weight": r(cout, cin, 1, 1)}
    if idconv:
        sd[f"{d}.weight_rbr_1x1_kxk_idconv1"] = r(cin, cin, 1, 1)
        sd[f"{d}.id_tensor"] = np.eye(cin, dtype=np.float32)[:, :, None, None]
    else:
        sd[f"{d}.weight_rbr_1x1_kxk_conv1"] = r(cin, cin, 1, 1)
    bns = [f"{d}.bn", f"{prefix}.rbr_1x1.bn"] + ([f"{prefix}.rbr_identity"] if identity else [])
    for bn in bns:
        sd[f"{bn}.weight"], sd[f"{bn}.bias"] = 1 + 0.1 * r(cout), 0.1 * r(cout)
        sd[f"{bn}.running_mean"] = 0.1 * r(cout)
        sd[f"{bn}.running_var"] = rng.uniform(0.5, 1.5, cout).astype(np.float32)
    return sd


@pytest.mark.parametrize("idconv,identity", [(True, True), (False, False)])
def test_orepa_converter(idconv, identity):
    spec = [(-1, "C", (8, 3, 1)), (-1, "REP", (8,)), ((1,), "DET", ())]
    rng = np.random.default_rng(6)
    sd = {"model.0.conv.weight": rng.normal(size=(8, 3, 3, 3)).astype(np.float32),
          "model.0.conv.bias": rng.normal(size=8).astype(np.float32),
          "model.2.m.0.weight": rng.normal(size=(24, 8, 1, 1)).astype(np.float32),
          "model.2.m.0.bias": rng.normal(size=24).astype(np.float32),
          **_orepa_sd(rng, "model.1", 8, 8, idconv, identity)}
    got = tcv.convert_yolov7_state_dict(sd, spec)
    assert_leaf_equal(got, jcv.convert_yolov7_state_dict(sd, spec))
    assert got["layers"][1]["reparam"]["w"].shape == (3, 3, 8, 8)


@pytest.fixture(scope="module")
def pipeline_tree():
    """The tiny pipeline's numpy weights with SAR (2 ViT blocks, a 2-layer
    MANO head, ResNet-34), JAX layout, and the MANO template."""
    from hamer_yolo_tpu.core.checkpoint import init_pipeline_params

    jcfg, _ = tiny_configs("float32")
    jm, _ = mano_pair()
    tree = _np_tree(numpy_params(lambda k: init_pipeline_params(
        k, jm, yolo_cfg=jcfg.yolo, hamer_cfg=jcfg.hamer, sar_cfg=jcfg.sar), seed=7))
    template = np.asarray(jm.v_template, np.float32)
    tree["sar"]["head"]["saigb"]["template"] = template  # the converters take it as given
    return tree, template


@pytest.mark.parametrize("grid_hw", [None, (4, 3)])
def test_vit_and_mano_head(pipeline_tree, grid_hw):
    tree, _ = pipeline_tree
    sd = hamer_state_dict(tree["hamer"])
    if grid_hw is not None:  # a square 4 x 4 pretraining grid, resized to the tiny ViT's
        sd["backbone.pos_embed"] = np.random.default_rng(10).normal(
            size=(1, 17, 64)).astype(np.float32)
    got = tcv.convert_vit_state_dict(sd, depth=2, grid_hw=grid_hw)
    ref = jcv.convert_vit_state_dict(sd, depth=2, grid_hw=grid_hw)
    if grid_hw is not None:  # resized: held to 1e-6, not bit for bit
        np.testing.assert_allclose(got.pop("pos_embed"), ref.pop("pos_embed"), rtol=1e-6,
                                   atol=1e-6)
    assert_leaf_equal(got, ref)
    assert_leaf_equal(tcv.convert_mano_head_state_dict(sd, depth=2),
                      jcv.convert_mano_head_state_dict(sd, depth=2))


@pytest.mark.parametrize("layout", ["torchvision", "sar"])
def test_sar_resnet34_both_layouts(pipeline_tree, layout):
    tree, template = pipeline_tree
    net, _ = sar_state_dicts(tree["sar"], layout, module_prefix=False)
    got = tcv.convert_sar_resnet34(net, prefix="backbone.")
    assert_leaf_equal(got, jcv.convert_sar_resnet34(net, prefix="backbone."))
    assert_leaf_equal(tcv._convert_sar_head(net, template), jcv._convert_sar_head(net, template))


@pytest.mark.parametrize("src,dst", [
    ((4, 4), (8, 6)),      # upscale, and a mixed one
    ((14, 14), (12, 12)),  # downscale: the kernel widened by 14 / 12
    ((14, 14), (16, 12)),  # the mixed case: rows up, columns down
    ((3, 3), (7, 2)),
], ids=["up", "down", "mixed", "odd"])
def test_resize_pos_embed_matches_jax(src, dst):
    rng = np.random.default_rng(8)
    pos = (0.02 * rng.normal(size=(1, 1 + src[0] * src[1], 16))).astype(np.float32)
    got = tcv.resize_pos_embed(pos, dst)
    ref = jcv.resize_pos_embed(pos, dst)
    assert got.dtype == ref.dtype == np.float32 and got.shape == ref.shape
    np.testing.assert_array_equal(got[:, :1], pos[:, :1])  # the cls slot passes through
    np.testing.assert_allclose(got, ref, rtol=1e-6, atol=1e-6)


def test_resize_pos_embed_same_grid_and_bad_grid():
    pos = np.random.default_rng(9).normal(size=(1, 1 + 12 * 16, 8)).astype(np.float32)
    same = tcv.resize_pos_embed(pos, (16, 12))
    np.testing.assert_array_equal(same, jcv.resize_pos_embed(pos, (16, 12)))
    assert same is pos
    with pytest.raises(ValueError, match="source grid"):
        tcv.resize_pos_embed(pos[:, :11], (4, 4))


def test_convert_pipeline_checkpoints_from_files(pipeline_tree, tmp_path):
    """The three reference files written with torch.save (a pickled module
    tree with an "ema" entry, a Lightning {'state_dict'} and SAR's {'network',
    'rootnet'} with module. prefixes): the port's tree equals JAX's, leaf for
    leaf, and the weights that went in (the EMA's, not the model's)."""
    tree, template = pipeline_tree
    full = dict(tree)
    # the converter reads 32 ViT blocks and 6 head layers: write a HaMeR of that depth
    blocks = full["hamer"]["backbone"]["blocks"]
    layers = full["hamer"]["mano_head"]["layers"]
    full["hamer"] = {"backbone": {**full["hamer"]["backbone"], "blocks": blocks * 16},
                     "mano_head": {**full["hamer"]["mano_head"], "layers": layers * 3}}
    paths = write_reference_files(str(tmp_path), full)
    assert all(os.path.getsize(p) > 0 for p in paths)
    got = tcv.convert_pipeline_checkpoints(*paths, template=template)
    ref = jcv.convert_pipeline_checkpoints(*paths, template=template)
    assert_leaf_equal(got, ref)
    assert_leaf_equal(got, full)


def test_kpfusion_and_centernet_converters(tmp_path):
    """KPFusion's state dict (every equal-width hourglass Residual with the
    unused skip_layer the module carries) and its .pth file ({'model'},
    module. prefixes): the port's trees equal JAX's and the tree that went
    in, leaf for leaf; the same for the centerNet head."""
    from hamer_yolo_tpu.models.kpfusion_rgbd.centernet import centernet_init
    from hamer_yolo_tpu.models.kpfusion_rgbd.model import KPFusionConfig, init_kpfusion

    cfg = KPFusionConfig(dim=32, img_size=64, feature_size=16, sample_num=128)
    tree = _np_tree(numpy_params(lambda k: init_kpfusion(k, cfg), seed=11))
    sd = kpfusion_state_dict(tree)
    assert "backbone_d.skip_layer4.skip_layer.conv.weight" in sd
    got = tcv.convert_kpfusion_state_dict(sd)
    assert_leaf_equal(got, jcv.convert_kpfusion_state_dict(sd))
    assert_leaf_equal(got, tree)
    assert "skip" not in got["backbone_d"]["skip4"] and "skip" in got["backbone_d"]["fuse4"]
    path = str(tmp_path / "kpfusion.pth")
    write_kpfusion_file(path, tree)
    assert_leaf_equal(tcv.convert_kpfusion_checkpoint(path), jcv.convert_kpfusion_checkpoint(path))
    cn = _np_tree(numpy_params(lambda k: centernet_init(k, 21), seed=12))
    csd = centernet_state_dict(cn)
    got = tcv.convert_centernet(csd, "net")
    assert_leaf_equal(got, jcv.convert_centernet(csd, "net"))
    assert_leaf_equal(got, cn)
