"""The opt-in kernel paths end to end at the --tiny config: the int8 ViT under
HYT_ATTN / HYT_INT8_MLP and HaMeR with ``fused_mano`` against the JAX package
under the same switches (its Pallas kernels in interpret mode), and
``infer_frames`` on the opt-in path against the port's default kernel path."""
import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from hamer_yolo_tpu.core import quant as jquant
from hamer_yolo_tpu.models.hamer import hamer_forward as jax_hamer_forward
from hamer_yolo_tpu.ops import attention_pallas as jap
from hamer_yolo_tpu.ops import mano_pallas as jmp
from hamer_yolo_tpu_torch.core import quant
from hamer_yolo_tpu_torch.models.hamer import HamerConfig, hamer_forward
from hamer_yolo_tpu_torch.ops import mano_lbs
from hamer_yolo_tpu_torch.pipeline.frame import infer_frames
from test_torch_bridge import jax_exact, mano_pair, np_tree, tiny_configs, to_port
from test_torch_int8_slice import _int8
from test_torch_optin_kernels import spy  # noqa: F401  (a fixture)
from test_torch_pipeline import _inputs

torch.set_num_threads(1)

OPTIN = {"static": {"HYT_ATTN": "megakernel", "HYT_INT8_MLP": "megakernel1"},
         "dynamic": {"HYT_ATTN": "pallas_fusedqkv"}}
REACHED = {"static": {"K6": 2, "K10": 2, "prequant": 2}, "dynamic": {"K5": 8, "K8": 2}}


@pytest.fixture
def jax_interpret(monkeypatch):
    """JAX's opt-in arms on the CPU: its int8 ViT takes the kernels
    (fused=True) in interpret mode, and the two kernels that its callers
    reach without handing ``interpret`` on (K8 from _attn_math, K9 from
    mano_forward_rotmat) get it here. Nothing in the package changes."""
    k8, k9, vit = jap.fused_qkv_attention, jmp.mano_lbs_fused, jquant.vit_forward_int8
    monkeypatch.setattr(jap, "fused_qkv_attention",
                        lambda x, h, interpret=False, **kw: k8(x, h, interpret=True, **kw))
    monkeypatch.setattr(jmp, "mano_lbs_fused", lambda m, b, r: k9(m, b, r, interpret=True))
    monkeypatch.setattr(jquant, "vit_forward_int8", lambda p, x, cfg, **kw:
                        vit(p, x, cfg, fused=True, interpret=True))


def _drop_scales(backbone):
    for blk in backbone["blocks"]:
        for lin in (*blk["attn"].values(), *blk["mlp"].values()):
            del lin["sx"]


def _setup(scales, seed, monkeypatch):
    jcfg, tcfg = tiny_configs("float32")
    params, jcfg, tcfg = _int8(jcfg, tcfg, seed=seed)
    jparams, port = params, to_port(params)
    if scales == "dynamic":
        jparams = jax.tree_util.tree_map(lambda x: x, params)  # a copy of the containers
        _drop_scales(jparams["hamer"]["backbone"])
        _drop_scales(port["hamer"]["backbone"])
    for k, v in OPTIN[scales].items():
        monkeypatch.setenv(k, v)
    fused = lambda cfg: dataclasses.replace(cfg, hamer=dataclasses.replace(  # noqa: E731
        cfg.hamer, fused_mano=True, vit=dataclasses.replace(cfg.hamer.vit, fused_attn=True)))
    return jparams, port, dataclasses.replace(
        jcfg, hamer=dataclasses.replace(jcfg.hamer, fused_mano=True)), fused(tcfg)


@pytest.mark.parametrize("scales", ["static", "dynamic"])
def test_vit_int8_optin_matches_jax(scales, spy, jax_interpret, monkeypatch):  # noqa: F811
    """The 2-block int8 ViT: K6 + K10 (static scales, megakernel +
    megakernel1) and K5 + K8 (no scales, pallas_fusedqkv), at the JAX
    package's tolerance for its fused int8 ViT (tests/test_int8_fused.py:509-510)."""
    jparams, port, jcfg, tcfg = _setup(scales, 3, monkeypatch)
    x = np.random.default_rng(3).normal(size=(3, *tcfg.hamer.vit.img_size, 3)).astype(np.float32)
    ref = jax_exact(lambda p, xx: jquant.vit_forward_int8(p, xx, jcfg.hamer.vit),
                    jparams["hamer"]["backbone"], jnp.asarray(x))
    got = quant.vit_forward_int8(port["hamer"]["backbone"], torch.from_numpy(x), tcfg.hamer.vit)
    assert spy == REACHED[scales]
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=0.05, atol=0.05)


def test_hamer_forward_optin_matches_jax(spy, jax_interpret, monkeypatch):  # noqa: F811
    """HaMeR at the tiny config with the int8 backbone on K6 + K10 and the
    fused MANO LBS (K9), both packages on the same switches. The backbones
    agree to the fused int8 ViT's tolerance; the mesh and joints are compared
    at it too (metres, the hand about 0.1 across)."""
    jparams, port, jcfg, tcfg = _setup("static", 4, monkeypatch)
    jm, tm = mano_pair()
    img = np.random.default_rng(4).normal(size=(3, 64, 64, 3)).astype(np.float32)
    keys = ("pred_vertices", "pred_keypoints_3d")
    ref = jax_exact(lambda i: {k: v for k, v in jax_hamer_forward(
        jparams["hamer"], jm, i, jcfg.hamer).items() if k in keys}, jnp.asarray(img))
    calls = []
    real = mano_lbs.mano_lbs_fused
    monkeypatch.setattr(mano_lbs, "mano_lbs_fused", lambda *a: calls.append(1) or real(*a))
    got = hamer_forward(port["hamer"], tm, torch.from_numpy(img), tcfg.hamer)
    assert spy == REACHED["static"] and len(calls) == 1
    for k in keys:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(ref[k]), rtol=0.05, atol=0.05,
                                   err_msg=k)


def test_fused_mano_defaults_off_and_matches_einsum_lbs():
    assert HamerConfig().fused_mano is False
    _, tcfg = tiny_configs("float32")
    _, tm = mano_pair()
    from hamer_yolo_tpu_torch.models.hamer import init_hamer

    params = init_hamer(torch.Generator().manual_seed(0), tcfg.hamer)
    img = torch.from_numpy(np.random.default_rng(5).normal(size=(2, 64, 64, 3)).astype(np.float32))
    ref = hamer_forward(params, tm, img, tcfg.hamer)
    got = hamer_forward(params, tm, img, dataclasses.replace(tcfg.hamer, fused_mano=True))
    for k in ("pred_vertices", "pred_keypoints_3d", "pred_keypoints_2d"):
        # K9's plain version against the einsum LBS: f32 sums in another order
        torch.testing.assert_close(got[k], ref[k], rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("scales", ["static", "dynamic"])
def test_infer_frames_optin_path_matches_default_kernels(scales, spy, monkeypatch):  # noqa: F811
    """infer_frames on the opt-in path (the switches of OPTIN, fused_mano)
    against the same frames on the default kernel path (K3 + K4, or K5 + K7):
    the two quantize at the same points with the same rounding, so the mesh
    and joints agree far inside the fused int8 ViT's tolerance."""
    _, tm = mano_pair()
    imgs, hws, Ks = (torch.from_numpy(a) for a in _inputs())
    _, port, _, tcfg = _setup(scales, 2, monkeypatch)
    got = np_tree(infer_frames(port, tm, imgs, hws, Ks, tcfg))
    reached = dict(spy)
    for k in OPTIN[scales]:
        monkeypatch.delenv(k)
    ref = np_tree(infer_frames(port, tm, imgs, hws, Ks, dataclasses.replace(
        tcfg, hamer=dataclasses.replace(tcfg.hamer, fused_mano=False))))
    assert reached == REACHED[scales]
    assert ref["valid"].any() and (ref["valid"] == got["valid"]).all()
    for k in ("keypoints_3d", "vertices"):
        np.testing.assert_allclose(got[k][ref["valid"]], ref[k][ref["valid"]], rtol=0.05,
                                   atol=0.05, err_msg=k)
