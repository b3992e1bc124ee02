"""The JAX -> torch parameter bridge, the port's import hygiene, and the
helpers the other test_torch_* files share.

Inputs are made with numpy from a seed and handed to both packages; both
sides run on the CPU (JAX in interpret mode where it reaches a Pallas
kernel, the port through each kernel's plain twin).
"""
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax

from hamer_yolo_tpu_torch.core.bridge import from_jax_params

torch.set_num_threads(1)  # tier-1 runs 6 xdist workers on 8 cores

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def to_port(tree):
    """JAX parameter pytree -> port parameters (through numpy)."""
    return from_jax_params(jax.tree_util.tree_map(np.asarray, tree))


def numpy_params(init_fn, seed: int = 0):
    """Weights for both packages, made with numpy in the structure of a JAX
    init function (traced by eval_shape: nothing is compiled). Weights follow
    the JAX initialisers' distributions; biases, LN affines and the head's
    mean parameters get small random values so every term is exercised."""
    rng = np.random.default_rng(seed)
    shapes = jax.eval_shape(init_fn, jax.random.PRNGKey(0))

    def leaf(path, s):
        key, shape = path[-1].key, s.shape
        if key == "w":
            fan_in = int(np.prod(shape[:-1]))
            bound = np.sqrt(6.0 / fan_in)
            v = rng.uniform(-bound, bound, shape)
        elif key == "scale":
            v = 1.0 + 0.1 * rng.normal(size=shape)
        elif key in ("b", "bias", "init_betas"):
            v = 0.05 * rng.normal(size=shape)
        elif key == "pos_embed":
            v = 0.02 * rng.normal(size=shape)
        elif key == "init_hand_pose":
            v = np.tile([1.0, 0, 0, 0, 1, 0], shape[1] // 6)[None] + 0.05 * rng.normal(size=shape)
        elif key == "init_cam":
            v = np.array([[0.9, 0.0, 0.0]]) + 0.01 * rng.normal(size=shape)
        elif key in ("mean", "template"):  # BN running means; SAR's MANO template
            v = 0.05 * rng.normal(size=shape)
        elif key == "var":
            v = rng.uniform(0.5, 1.5, shape)
        elif key == "adj":  # SAR's learned adjacency: JAX's identity init, perturbed
            v = np.eye(shape[0]) + 0.02 * rng.uniform(size=shape)
        elif key == "beta":
            v = 1.0 + 0.1 * rng.normal(size=shape)
        elif key == "rpb":  # Swin's relative position bias table
            v = 0.02 * rng.normal(size=shape)
        elif key == "in_proj_w":  # KPFusion's decoders: the fused (in, 3 out) in_proj
            bound = np.sqrt(6.0 / shape[0])
            v = rng.uniform(-bound, bound, shape)
        elif key == "in_proj_b":
            v = 0.05 * rng.normal(size=shape)
        elif key in ("self_posembed", "cross_posembed"):  # learned per-joint embeddings
            v = 0.02 * rng.normal(size=shape)
        elif key == "weight_dis":  # KPFusion's GAM / spatial gate logit
            v = rng.normal(size=shape)
        elif key == "gamma":  # ConvNeXt's layer scale: O(1), where JAX's 1e-6 init
            v = rng.uniform(0.5, 1.0, shape)  # would hide every block
        else:
            raise KeyError(path)
        return v.astype(np.float32)

    return jax.tree_util.tree_map_with_path(leaf, shapes)


def pipeline_params(jcfg, seed: int = 0, with_sar: bool = False):
    """numpy weights for the tiny detector + HaMeR (+ SAR with ``with_sar``),
    JAX layout."""
    from hamer_yolo_tpu.core.checkpoint import init_pipeline_params

    jmano, _ = mano_pair()
    return numpy_params(lambda k: init_pipeline_params(
        k, jmano, yolo_cfg=jcfg.yolo, hamer_cfg=jcfg.hamer, sar_cfg=jcfg.sar,
        with_sar=with_sar), seed)


def calibrate_sar_bn(sar, x):
    """Set the BN running stats of a SAR tree (numpy leaves, JAX layout) to
    the f32 batch statistics of each BN's input on the patches ``x``
    (B, H, W, 3), as training leaves them. With numpy_params' stats the
    random trunk's activations grow ~1000x over its 36 convolutions (no BN
    normalises anything); with these they stay O(1), as in a trained trunk.
    The stats are computed with the port's f32 layers. Returns ``sar``."""
    from hamer_yolo_tpu_torch.core import nn as tnn

    def conv_bn(conv, bn, y, stride, pad):
        z = tnn.conv2d(from_jax_params(conv), y, stride, pad)
        bn["mean"] = z.mean((0, 1, 2)).numpy().astype(np.float32)
        bn["var"] = z.var((0, 1, 2)).numpy().astype(np.float32)
        return tnn.batch_norm(from_jax_params(bn), z, 1e-5)

    b = sar["backbone"]
    with torch.no_grad():
        y = torch.relu(conv_bn(b["conv1"], b["bn1"], torch.from_numpy(x), 2, 3))
        y = tnn.max_pool(y, 3, 2, 1)
        for si, blocks in enumerate(b["stages"]):
            for bi, blk in enumerate(blocks):
                stride = 2 if (bi == 0 and si > 0) else 1
                z = torch.relu(conv_bn(blk["conv1"], blk["bn1"], y, stride, 1))
                z = conv_bn(blk["conv2"], blk["bn2"], z, 1, 1)
                if "down" in blk:
                    y = conv_bn(blk["down"], blk["down_bn"], y, stride, 0)
                y = torch.relu(y + z)
    return sar


def sar_pipeline_params(jcfg, seed: int = 0):
    """pipeline_params with SAR, its BN stats calibrated (calibrate_sar_bn)
    on numpy-made normalised patches at the SAR input size."""
    params = jax.tree_util.tree_map(np.asarray, pipeline_params(jcfg, seed, with_sar=True))
    x = np.random.default_rng(seed + 100).normal(
        size=(8, jcfg.sar.input_size, jcfg.sar.input_size, 3)).astype(np.float32)
    calibrate_sar_bn(params["sar"], x)
    return params


def jax_exact(fn, *args):
    """Run ``fn`` jitted with XLA's excess precision off, so that every bf16
    op rounds where the JAX source says, as the port's ops do (with it on,
    XLA keeps fused intermediates in f32 at places no other program can
    follow). f32 programs are unaffected."""
    compiled = jax.jit(fn).lower(*args).compile(
        compiler_options={"xla_allow_excess_precision": False})
    return compiled(*args)


def np_tree(tree):
    """Dict of arrays/tensors -> dict of float64/bool numpy arrays."""
    out = {}
    for k, v in tree.items():
        a = v.detach().cpu().numpy() if isinstance(v, torch.Tensor) else np.asarray(v)
        out[k] = a if a.dtype == bool else a.astype(np.float64)
    return out


def tiny_configs(dtype: str = "bfloat16", max_hands: int = 2, depth_refine: bool = False):
    """The --tiny pipeline config (hamer_yolo_tpu/cli/main.py:47-61) in both
    packages, at one compute dtype for detector, ViT and SAR."""
    from hamer_yolo_tpu.models.hamer import HamerConfig as JH
    from hamer_yolo_tpu.models.mano_head import ManoHeadConfig as JM
    from hamer_yolo_tpu.models.sar import SarConfig as JS
    from hamer_yolo_tpu.models.vit import ViTConfig as JV
    from hamer_yolo_tpu.models.yolov7 import YoloConfig as JY
    from hamer_yolo_tpu.pipeline.frame import PipelineConfig as JP
    from hamer_yolo_tpu_torch.models.hamer import HamerConfig as TH
    from hamer_yolo_tpu_torch.models.mano_head import ManoHeadConfig as TM
    from hamer_yolo_tpu_torch.models.sar import SarConfig as TS
    from hamer_yolo_tpu_torch.models.vit import ViTConfig as TV
    from hamer_yolo_tpu_torch.models.yolov7.model import YoloConfig as TY
    from hamer_yolo_tpu_torch.pipeline.frame import PipelineConfig as TP

    def build(P, Y, H, V, M, S):
        return P(max_hands=max_hands, det_size=64, crop_size=64, use_depth_refine=depth_refine,
                 yolo=Y(nc=3, img_size=64, compute_dtype=dtype),
                 hamer=H(image_size=64, crop_margin=8,
                         vit=V(img_size=(64, 48), embed_dim=64, depth=2, num_heads=4,
                               compute_dtype=dtype),
                         head=M(dim=32, context_dim=64, depth=2, heads=2, dim_head=8,
                                mlp_dim=32)),
                 sar=S(backbone="resnet34", input_size=64, feature_hw=2, heatmap_size=8,
                       compute_dtype=dtype))

    return build(JP, JY, JH, JV, JM, JS), build(TP, TY, TH, TV, TM, TS)


def mano_pair():
    """The same MANO arrays as a JAX ManoModel and a port ManoModel."""
    from hamer_yolo_tpu.core.mano_assets import load_mano_model, synthetic_mano_model
    from hamer_yolo_tpu.models.mano import ManoModel as JMano
    from hamer_yolo_tpu_torch.models.mano import ManoModel as TMano

    try:
        data = load_mano_model("right")
    except Exception:
        data = synthetic_mano_model()
    return JMano.from_arrays(data), TMano.from_arrays(data)


class TestBridge:
    def test_layouts(self):
        rng = np.random.default_rng(0)
        tree = {"conv": {"w": rng.normal(size=(3, 5, 2, 7)).astype(np.float32),
                         "b": np.zeros(7, np.float32)},
                "layers": [None, {"w": rng.normal(size=(4, 6)).astype(np.float32)}],
                "pos_embed": np.ones((1, 3, 4), np.float32)}
        out = from_jax_params(tree)
        np.testing.assert_array_equal(out["conv"]["w"].numpy(),
                                      tree["conv"]["w"].transpose(3, 2, 0, 1))
        assert out["layers"][0] is None
        np.testing.assert_array_equal(out["layers"][1]["w"].numpy(), tree["layers"][1]["w"])
        assert out["pos_embed"].shape == (1, 3, 4)

    @pytest.mark.parametrize("leaf", [
        {"w": {"q": np.zeros((4, 4), np.int8), "scale": np.ones(4, np.float32)}},
        {"bn": {"mean": np.zeros((4, 4), np.float32)}},
        {"w": np.zeros((2, 2, 2), np.float32)},
        {"attn": {"in_proj_w": np.zeros((1, 4, 12), np.float32)}},
        {"weight_dis": np.zeros((1, 1), np.float32)},
        {"unknown": np.zeros(3, np.float32)},
    ], ids=["int8_weight", "batchnorm_stats", "rank3_weight", "rank3_in_proj",
            "rank2_weight_dis", "unknown_key"])
    def test_unmapped_leaf_raises(self, leaf):
        with pytest.raises(KeyError, match="bridge: no mapping"):
            from_jax_params({"layer": leaf})

    def test_full_jax_tiny_pipeline_maps(self):
        """Every leaf of the JAX tiny detector + HaMeR tree has a rule, and
        the conv / linear leaves land in the port's layouts."""
        jcfg, _ = tiny_configs()
        params = pipeline_params(jcfg)
        port = to_port(params)
        n_jax = len(jax.tree_util.tree_leaves(params))
        n_port = len([x for x in jax.tree_util.tree_leaves(port) if isinstance(x, torch.Tensor)])
        assert n_jax == n_port
        w = params["yolo"]["layers"][0]["conv"]["w"]
        assert tuple(port["yolo"]["layers"][0]["conv"]["w"].shape) == (
            w.shape[3], w.shape[2], w.shape[0], w.shape[1])
        q = params["hamer"]["backbone"]["blocks"][0]["attn"]["qkv"]["w"]
        assert tuple(port["hamer"]["backbone"]["blocks"][0]["attn"]["qkv"]["w"].shape) == q.shape


    def test_kpfusion_tree_maps(self):
        """Every leaf of the JAX KPFusion tree has a rule: the decoders' fused
        in_proj, the learned per-joint embeddings, BERT's rank-2 position
        table and the gate logit keep their shapes; convs go to OIHW."""
        from hamer_yolo_tpu.models.kpfusion_rgbd.model import KPFusionConfig, init_kpfusion

        cfg = KPFusionConfig(dim=32, img_size=64, feature_size=16, sample_num=128)
        params = numpy_params(lambda k: init_kpfusion(k, cfg))
        port = to_port(params)
        n_port = len([x for x in jax.tree_util.tree_leaves(port) if isinstance(x, torch.Tensor)])
        assert n_port == len(jax.tree_util.tree_leaves(params))
        blk, pblk = params["blocks"][0], port["blocks"][0]
        layer = blk["crossTR"]["layers"][0]
        for key, shape in (("in_proj_w", (32, 96)), ("in_proj_b", (96,))):
            assert tuple(pblk["crossTR"]["layers"][0]["attn"][key].shape) == shape
            np.testing.assert_array_equal(pblk["crossTR"]["layers"][0]["attn"][key].numpy(),
                                          layer["attn"][key])
        for key in ("self_posembed", "cross_posembed"):
            assert tuple(pblk["crossTR"]["layers"][0][key].shape) == (21, 32)
        assert tuple(pblk["init_TR"]["bert"]["pos_embed"].shape) == (512, 32)
        assert tuple(pblk["weight_dis"].shape) == (1,)
        w = params["backbone_d"]["backbone"]["conv1"]["w"]
        assert tuple(port["backbone_d"]["backbone"]["conv1"]["w"].shape) == (64, 1, 7, 7) \
            and w.shape == (7, 7, 1, 64)


class TestMano:
    def test_synthetic_model_byte_identical(self):
        from hamer_yolo_tpu.core.mano_assets import synthetic_mano_model as jsyn
        from hamer_yolo_tpu_torch.core.mano_assets import synthetic_mano_model as tsyn

        a, b = jsyn(3), tsyn(3)
        assert a.keys() == b.keys()
        for k in a:
            assert a[k].dtype == b[k].dtype and a[k].tobytes() == b[k].tobytes(), k


def test_port_imports_without_jax():
    """Every port module imports with jax made unimportable, and none of
    them pulls in the JAX package."""
    code = (
        "import sys, pkgutil, importlib\n"
        "sys.modules['jax'] = None\n"
        "import hamer_yolo_tpu_torch as p\n"
        "mods = [m.name for m in pkgutil.walk_packages(p.__path__, p.__name__ + '.')]\n"
        "for m in mods: importlib.import_module(m)\n"
        "bad = [m for m in sys.modules if m == 'hamer_yolo_tpu' or m.startswith('hamer_yolo_tpu.')]\n"
        "assert not bad, bad\n"
        "print(' '.join(mods))\n"
    )
    env = dict(os.environ, PYTHONPATH=REPO)
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    mods = set(res.stdout.split())
    assert len(mods) >= 48
    assert {f"hamer_yolo_tpu_torch.{m}" for m in (
        "models.resnet", "models.sar", "models.tome", "pipeline.serving", "pipeline.sar_mesh",
        "utils.profiling", "parallel.mesh", "utils.downloads", "tools.eval_fastpaths",
        "tools.eval_hamer", "tools.eval_detector", "tools.parity_check")} <= mods
