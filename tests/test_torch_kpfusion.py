"""The port's KeypointFusion modules (hamer_yolo_tpu_torch/models/kpfusion_rgbd/)
against the JAX package's (hamer_yolo_tpu/models/kpfusion_rgbd/) on the same
numpy-made weights and inputs, at a small config: dim 32, 64 x 64 crops, 16 x
16 feature maps, 128 points, two stages (the UNets are ResNet-18 whatever the
config). KPFusion is f32 throughout, so the JAX side needs no special
compilation. Tolerances are the JAX package's own (tests/test_kpfusion_rgbd.py):
resunet 2e-4 / 1e-4, geometry, BERT and decoders 1e-4 / 1e-3, DESA 2e-4 /
1e-3, the full forward 5e-4 / 1e-3; indices exactly equal.

Weights follow the JAX initialisers' distributions (test_torch_bridge.
numpy_params), and each BN's running variance is then set to its input's
mean square by one port forward (test_torch_state_dicts.
calibrating_batch_norm), so activations stay O(1) as in a trained model.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hamer_yolo_tpu.models.kpfusion_rgbd import bert as JB
from hamer_yolo_tpu.models.kpfusion_rgbd import centernet as JCN
from hamer_yolo_tpu.models.kpfusion_rgbd import desa as JD
from hamer_yolo_tpu.models.kpfusion_rgbd import geometry as JG
from hamer_yolo_tpu.models.kpfusion_rgbd import layers as JL
from hamer_yolo_tpu.models.kpfusion_rgbd import mano_head as JMH
from hamer_yolo_tpu.models.kpfusion_rgbd import model as JM
from hamer_yolo_tpu.models.kpfusion_rgbd import resunet as JR
from hamer_yolo_tpu.models.kpfusion_rgbd import transfusion as JT
from hamer_yolo_tpu_torch.core.bridge import from_jax_params
from hamer_yolo_tpu_torch.models.kpfusion_rgbd import bert as TB
from hamer_yolo_tpu_torch.models.kpfusion_rgbd import centernet as TCN
from hamer_yolo_tpu_torch.models.kpfusion_rgbd import desa as TD
from hamer_yolo_tpu_torch.models.kpfusion_rgbd import geometry as TG
from hamer_yolo_tpu_torch.models.kpfusion_rgbd import layers as TL
from hamer_yolo_tpu_torch.models.kpfusion_rgbd import mano_head as TMH
from hamer_yolo_tpu_torch.models.kpfusion_rgbd import model as TM
from hamer_yolo_tpu_torch.models.kpfusion_rgbd import resunet as TR
from hamer_yolo_tpu_torch.models.kpfusion_rgbd import transfusion as TT
from test_torch_bridge import mano_pair, numpy_params
from test_torch_state_dicts import calibrating_batch_norm, port_tree_to_numpy

torch.set_num_threads(1)

SMALL = dict(dim=32, img_size=64, feature_size=16, sample_num=128, num_stages=2)
J = 21
CAM = (906.96, 906.79, 956.75, 547.23)


def np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def jnp_tree(tree):
    return jax.tree_util.tree_map(jnp.asarray, tree)


def calibrated(init_fn, seed, run):
    """numpy weights in the structure of the JAX ``init_fn``, BN stats set
    by ``run(port_params)``, a port forward under calibrating_batch_norm.
    -> the tree as numpy, JAX layout."""
    port = from_jax_params(np_tree(numpy_params(init_fn, seed)))
    with torch.no_grad(), calibrating_batch_norm():
        run(port)
    return port_tree_to_numpy(port)


def t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def close(got, ref, atol, rtol, what=""):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    np.testing.assert_allclose(got, np.asarray(ref), atol=atol, rtol=rtol, err_msg=what)


def crop_geometry(seed=0, B=1):
    """center (metric mm), M (a crop scale + shift), cube, camera."""
    rng = np.random.default_rng(seed)
    center = np.stack([rng.uniform(-60, 60, B), rng.uniform(-40, 40, B),
                       rng.uniform(450, 600, B)], -1).astype(np.float32)
    M = np.tile(np.eye(3, dtype=np.float32), (B, 1, 1))
    M[:, 0, 0] = M[:, 1, 1] = 0.25
    M[:, 0, 2] = -220.0
    M[:, 1, 2] = -120.0
    cube = np.tile(np.float32([250.0] * 3), (B, 1))
    cam = np.tile(np.float32(CAM), (B, 1))
    return center, M, cube, cam


def kpf_inputs(seed=0, S=64, N=128):
    """A crop pair and cloud like the runtime's: depth in [-1, 1) on a disk,
    background 1 (outside the cube); the cloud in [-0.8, 0.8]."""
    rng = np.random.default_rng(seed)
    img_rgb = rng.uniform(0, 1, (1, 3, S, S)).astype(np.float32)
    yy, xx = np.mgrid[0:S, 0:S]
    disk = (xx - S / 2) ** 2 + (yy - S / 2) ** 2 < (S / 2.6) ** 2
    img = np.where(disk, 0.4 * np.sin(xx / 5.0) * np.cos(yy / 4.0)
                   + 0.1 * rng.uniform(-1, 1, (S, S)), 1.0)[None, None].astype(np.float32)
    pcl = rng.uniform(-0.8, 0.8, (1, N, 3)).astype(np.float32)
    return (img_rgb, img, pcl) + crop_geometry(seed)


# --- resunet -------------------------------------------------------------------

def test_up2x_bilinear_is_jax_image_resize():
    """F.interpolate(bilinear, align_corners=False) at 2x equals
    jax.image.resize(bilinear), edges included."""
    x = np.random.default_rng(0).normal(size=(2, 5, 7, 3)).astype(np.float32)
    got = TR._up2x_bilinear(t(x)).numpy()
    ref = np.asarray(jax.image.resize(jnp.asarray(x), (2, 10, 14, 3), method="bilinear"))
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-6)


@pytest.mark.parametrize("in_ch", [1, 3])
def test_unet_forward(in_ch):
    x = np.random.default_rng(in_ch).uniform(-1, 1, (1, 64, 64, in_ch)).astype(np.float32)
    tree = calibrated(lambda k: JR.unet_init(k, J, in_ch, 32), in_ch,
                      lambda p: TR.unet_forward(p, t(x)))
    with torch.inference_mode():
        res, feat = TR.unet_forward(from_jax_params(tree), t(x))
    ref_res, ref_feat = jax.jit(JR.unet_forward)(jnp_tree(tree), jnp.asarray(x))
    assert res.shape == (1, 16, 16, 5 * J) and feat.shape == (1, 16, 16, 32)
    assert 0.05 < float(feat.abs().mean()) < 20.0  # calibrated: O(1) activations
    close(feat, ref_feat, 2e-4, 1e-4, "feat")
    close(res, ref_res, 2e-4, 1e-4, "res")


def test_centernet_forward():
    x = np.random.default_rng(9).uniform(-1, 1, (2, 64, 64, 1)).astype(np.float32)
    tree = calibrated(lambda k: JCN.centernet_init(k, J), 9,
                      lambda p: TCN.centernet_forward(p, t(x)))
    with torch.inference_mode():
        got = TCN.centernet_forward(from_jax_params(tree), t(x))
    close(got, jax.jit(JCN.centernet_forward)(jnp_tree(tree), jnp.asarray(x)), 2e-4, 1e-3)


# --- geometry ------------------------------------------------------------------

def test_uvd_xyz_round_trip():
    center, M, cube, cam = crop_geometry(1, B=2)
    uvd = np.random.default_rng(1).uniform(-1, 1, (2, J, 3)).astype(np.float32)
    args = [center, M, cube, cam]
    xyz = TG.uvd_nl2xyznl(t(uvd), *map(t, args), 64)
    ref = jax.jit(JG.uvd_nl2xyznl, static_argnums=5)(jnp.asarray(uvd), *args, 64)
    close(xyz, ref, 1e-4, 1e-3, "uvd_nl2xyznl")
    metric = TG.uvd_nl2xyznl(t(uvd), *map(t, args), 64, normalize=False)
    close(metric, JG.uvd_nl2xyznl(jnp.asarray(uvd), *args, 64, normalize=False), 1e-4, 1e-3)
    back = TG.xyz_nl2uvdnl(xyz, *map(t, args), 64)
    close(back, jax.jit(JG.xyz_nl2uvdnl, static_argnums=5)(ref, *args, 64), 1e-4, 1e-3,
          "xyz_nl2uvdnl")
    close(back, uvd, 1e-4, 1e-3, "round trip")
    close(TG.inv3x3(t(M)), np.linalg.inv(M), 1e-7, 1e-6, "inv3x3")


def test_img2pcl_index_exact():
    """The 4 nearest pixels of each point: the same indices in the same
    order as JAX's lax.top_k; closeness within 1e-4 / 1e-3."""
    img_rgb, img, pcl, center, M, cube, cam = kpf_inputs(2)
    img_down = TG._resize_nearest_torch(t(img), 16).permute(0, 2, 3, 1)
    cl, idx = TG.img2pcl_index(t(pcl), img_down, *map(t, (center, M, cube, cam)), 64)
    jdown = jnp.transpose(JG._resize_nearest_torch(jnp.asarray(img), 16), (0, 2, 3, 1))
    rcl, ridx = jax.jit(JG.img2pcl_index, static_argnums=6)(
        jnp.asarray(pcl), jdown, center, M, cube, cam, 64)
    np.testing.assert_array_equal(img_down.numpy(), np.asarray(jdown))
    np.testing.assert_array_equal(idx.numpy(), np.asarray(ridx))
    close(cl, rcl, 1e-4, 1e-3)


def test_img2anchor_dis():
    _, img, _, center, M, cube, cam = kpf_inputs(3)
    joint = np.random.default_rng(3).uniform(-0.9, 0.9, (1, J, 3)).astype(np.float32)
    img_down = img[:, :, ::4, ::4].transpose(0, 2, 3, 1)
    got = TG.img2anchor_dis(t(joint), t(img_down), *map(t, (center, M, cube, cam)), 64)
    ref = jax.jit(JG.img2anchor_dis, static_argnums=6)(jnp.asarray(joint), jnp.asarray(img_down),
                                                       center, M, cube, cam, 64)
    assert got.shape == (1, J, 16, 16)
    close(got, ref, 1e-4, 1e-3)


def test_offset_maps():
    """joint2offset, then offset2joint_weight on it (with random weight
    channels and the -1e8 mask), pcl_joint2offset and joint2heatmap."""
    rng = np.random.default_rng(4)
    _, img, pcl, *_ = kpf_inputs(4)
    joint = rng.uniform(-0.7, 0.7, (1, J, 3)).astype(np.float32)
    weights = rng.normal(size=(1, J, 16, 16)).astype(np.float32)

    def maps(m):
        off = m.joint2offset(joint, img, 0.8, 16)
        cat = torch.cat if m is TG else jnp.concatenate
        return (off, m.offset2joint_weight(cat([off, weights], 1), img, 0.8),
                m.pcl_joint2offset(joint, pcl, 0.8), m.joint2heatmap(joint, 0.8, 16, sigma=1.0))

    arrays = (joint, img, pcl, weights)
    joint, img, pcl, weights = map(t, arrays)
    got = maps(TG)
    joint, img, pcl, weights = map(jnp.asarray, arrays)
    ref = jax.jit(lambda: maps(JG))()
    for name, g, r in zip(("joint2offset", "offset2joint_weight", "pcl_joint2offset",
                           "joint2heatmap"), got, ref):
        close(g, r, 1e-4, 1e-3, name)


@pytest.mark.parametrize("H,fs", [(64, 16), (128, 32), (50, 16)])
def test_resize_nearest_index_rule(H, fs):
    x = np.random.default_rng(H).normal(size=(1, 2, H, H)).astype(np.float32)
    np.testing.assert_array_equal(TG._resize_nearest_torch(t(x), fs).numpy(),
                                  np.asarray(JG._resize_nearest_torch(jnp.asarray(x), fs)))


# --- BERT, decoders, DESA ------------------------------------------------------

@pytest.mark.parametrize("img_dim", [32, 35])
def test_kp_interaction(img_dim):
    """init_TR (image features of dim) and final_TR (dim + 3)."""
    x = np.random.default_rng(img_dim).normal(size=(1, J, img_dim)).astype(np.float32)
    tree = np_tree(numpy_params(lambda k: JB.kp_interaction_init(k, img_dim, hidden=32), 5))
    seq, pred = TB.kp_interaction(from_jax_params(tree), t(x), 4)
    rseq, rpred = jax.jit(JB.kp_interaction, static_argnums=2)(jnp_tree(tree), jnp.asarray(x), 4)
    close(seq, rseq, 1e-4, 1e-3, "sequence")
    close(pred, rpred, 1e-4, 1e-3, "pred")


@pytest.mark.parametrize("variant", ["detr", "updated", "spatial"])
def test_decoder(variant):
    rng = np.random.default_rng(6)
    joints = rng.normal(size=(1, J, 32)).astype(np.float32)
    grid = rng.normal(size=(1, 16 * 16, 32)).astype(np.float32)
    q, k = {"detr": (joints, grid), "updated": (joints, joints[:, ::-1]),
            "spatial": (grid, joints)}[variant]
    tree = np_tree(numpy_params(lambda key: JT.decoder_init(key, variant, J, 32, 32, 4), 7))
    got = TT.decoder_forward(from_jax_params(tree), variant, t(q), t(k), 4, (16, 16))
    ref = jax.jit(lambda p, a, b: JT.decoder_forward(p, variant, a, b, 4, (16, 16)))(
        jnp_tree(tree), q, k)
    assert got.shape == q.shape
    close(got, ref, 1e-4, 1e-3)


def test_desa():
    """Nodes near the cloud's points, so every radius groups several."""
    rng = np.random.default_rng(8)
    pcl_xyz = rng.uniform(-0.5, 0.5, (1, 128, 3)).astype(np.float32)
    node_xyz = (pcl_xyz[:, :J] + 0.03 * rng.normal(size=(1, J, 3))).astype(np.float32)
    pcl_feat = rng.normal(size=(1, 128, 32)).astype(np.float32)
    node_feat = rng.normal(size=(1, J, 32)).astype(np.float32)
    args = [t(a) for a in (pcl_feat, node_feat, pcl_xyz, node_xyz)]
    tree = calibrated(lambda k: JD.desa_init(k, 32, (32, 32)), 8,
                      lambda p: TD.desa_forward(p, *args))
    with torch.inference_mode():
        got = TD.desa_forward(from_jax_params(tree), *args)
    ref = jax.jit(JD.desa_forward)(jnp_tree(tree), pcl_feat, node_feat, pcl_xyz, node_xyz)
    close(got, ref, 2e-4, 1e-3)


# --- the full forward ----------------------------------------------------------

def kpf_tree(cfg, seed, inputs):
    """Calibrated numpy weights of the whole model at ``cfg`` (JAX layout)."""
    jcfg = JM.KPFusionConfig(**dataclass_fields(cfg))
    return calibrated(lambda k: JM.init_kpfusion(k, jcfg), seed,
                      lambda p: TM.kpfusion_forward(p, *map(t, inputs), cfg))


def dataclass_fields(cfg):
    return {f: getattr(cfg, f) for f in cfg.__dataclass_fields__}


def test_full_forward():
    """Every result (both offset maps, each stage's refined_3d and
    refined_2d), the initial joints and the spatial weights at 5e-4 / 1e-3."""
    cfg = TM.KPFusionConfig(**SMALL)
    inputs = kpf_inputs(10)
    tree = kpf_tree(cfg, 10, inputs)
    with torch.inference_mode():
        got = TM.kpfusion_forward(from_jax_params(tree), *map(t, inputs), cfg)
    jcfg = JM.KPFusionConfig(**SMALL)
    ref = jax.jit(lambda p, *a: JM.kpfusion_forward(p, *a, cfg=jcfg))(jnp_tree(tree), *inputs)
    names = ["off_d", "off_rgb", "s1_3d", "s1_2d", "s2_3d", "s2_2d"]
    for name, g, r in zip(names, got["results"], ref["results"]):
        close(g, r, 5e-4, 1e-3, name)
    for g, r in zip(got["spatial_weights"], ref["spatial_weights"]):
        close(g, r, 5e-4, 1e-3, "spatial_weights")
    close(got["joint_uvd_init"], ref["joint_uvd_init"], 5e-4, 1e-3, "joint_uvd_init")
    close(got["joints"], ref["joints"], 5e-4, 1e-3, "joints")
    # the joints are O(0.1-1), not the init's near-zero heads
    assert 0.05 < float(got["joints"].abs().mean()) < 5.0


# --- the rest of the family: layers, MANO head ---------------------------------

def test_cbam_and_rgbd_fusion():
    rng = np.random.default_rng(11)
    rgb, depth = (rng.normal(size=(2, 9, 7, 32)).astype(np.float32) for _ in range(2))
    tree = np_tree(numpy_params(lambda k: JL.rgbd_fusion_init(k, 32), 11))
    p = from_jax_params(tree)
    close(TL.cbam(p["cbam"], t(rgb)), jax.jit(JL.cbam)(jnp_tree(tree["cbam"]), rgb),
          1e-4, 1e-3, "cbam")
    close(TL.rgbd_fusion(p, t(rgb), t(depth)),
          jax.jit(JL.rgbd_fusion)(jnp_tree(tree), rgb, depth), 1e-4, 1e-3)


@pytest.mark.parametrize("hw", [(16, 16), (13, 11)])
def test_hourglass(hw):
    x = np.random.default_rng(12).normal(size=(1, *hw, 16)).astype(np.float32)
    tree = np_tree(numpy_params(lambda k: JL.hourglass_init(k, 16, 3), 12))
    got = TL.hourglass(from_jax_params(tree), t(x))
    assert got.shape == x.shape
    close(got, jax.jit(JL.hourglass)(jnp_tree(tree), x), 1e-4, 1e-3)


def test_depth_to_pointcloud():
    rng = np.random.default_rng(13)
    depth = rng.uniform(0.0, 2.5, (24, 32)).astype(np.float32)
    K = np.float32([[300, 0, 16], [0, 300, 12], [0, 0, 1]])
    for n in (50, 250):  # fewer and more slots than valid pixels
        close(TL.depth_to_pointcloud(t(depth), t(K), n),
              jax.jit(JL.depth_to_pointcloud, static_argnums=2)(depth, K, n), 1e-6, 1e-6)


@pytest.mark.parametrize("use_pca,flat,extra", [(False, True, None), (True, False, "trans"),
                                                (False, False, "center"), (True, True, "palm")])
def test_mano_forward_manopth(use_pca, flat, extra):
    jmano, tmano = mano_pair()
    rng = np.random.default_rng(14)
    B, ncomps = 3, 12 if use_pca else 45
    pose = (0.4 * rng.normal(size=(B, 3 + ncomps))).astype(np.float32)
    betas = rng.normal(size=(B, 10)).astype(np.float32)
    trans = rng.normal(size=(B, 3)).astype(np.float32)
    kw = dict(use_pca=use_pca, ncomps=ncomps, flat_hand_mean=flat,
              center_idx=9 if extra == "center" else None, root_palm=extra == "palm")
    from hamer_yolo_tpu.models.mano import mano_forward_manopth as jfwd
    from hamer_yolo_tpu_torch.models.mano import mano_forward_manopth as tfwd

    got = tfwd(tmano, t(pose), t(betas), t(trans) if extra == "trans" else None, **kw)
    ref = jax.jit(lambda p, b, tr: jfwd(jmano, p, b, tr, **kw))(
        pose, betas, trans if extra == "trans" else None)
    close(got.vertices, ref.vertices, 1e-3, 1e-5, "vertices mm")
    close(got.joints, ref.joints, 1e-3, 1e-5, "joints mm")


def test_mano_reg_head():
    jmano, tmano = mano_pair()
    cfg = JMH.ManoRegConfig(feature_size=64, neurons=(48, 32))
    feats = np.random.default_rng(15).normal(size=(2, 64)).astype(np.float32)
    tree = np_tree(numpy_params(lambda k: JMH.init_mano_reg(k, cfg), 15))
    got = TMH.mano_reg_forward(from_jax_params(tree), t(feats), tmano,
                               TMH.ManoRegConfig(feature_size=64, neurons=(48, 32)))
    ref = jax.jit(lambda p, f: JMH.mano_reg_forward(p, f, jmano, cfg))(jnp_tree(tree), feats)
    for k in ("mano_shape", "mano_pose", "mano_pose_aa"):
        close(got[k], ref[k], 1e-5, 1e-5, k)
    for k in ("verts3d", "joints3d"):
        close(got[k], ref[k], 1e-3, 1e-5, k)
