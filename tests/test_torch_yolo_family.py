"""The rest of the YOLOv7 family against the JAX package on the CPU: each
Ghost / Stem / Swin variant block, a mini spec that runs every deploy op
with each of the three heads (DET, BIN, KPT), yaml dicts (the mini yaml of
tests/test_yaml_models.py and a P6-shaped one with ReOrg and DownC), TTA,
Merge-NMS, the keypoint NMS and the ensemble. numpy-made weights through the
bridge; f32 at tests/test_torch_models.py's 1e-4, bf16 at its 0.05."""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from hamer_yolo_tpu.models.yolov7 import model as JM
from hamer_yolo_tpu.models.yolov7 import variants as JV
from hamer_yolo_tpu.models.yolov7.tta import yolov7_forward_tta as jax_forward_tta
from hamer_yolo_tpu.models.yolov7.yaml_spec import spec_from_yaml as jax_spec_from_yaml
from hamer_yolo_tpu.ops import nms as jnms
from hamer_yolo_tpu_torch.models.yolov7 import model as TM
from hamer_yolo_tpu_torch.models.yolov7 import variants as TV
from hamer_yolo_tpu_torch.models.yolov7.tta import yolov7_forward_tta
from hamer_yolo_tpu_torch.models.yolov7.yaml_spec import make_divisible, spec_from_yaml
from hamer_yolo_tpu_torch.ops import nms as tnms
from test_torch_bridge import jax_exact, numpy_params, to_port
from test_yaml_models import MINI_YAML

torch.set_num_threads(1)

TOL = {"float32": 1e-4, "bfloat16": 0.05}
# A block's bf16 output (values up to ~20 on random weights) is held by its
# accuracy: |port bf16 - JAX f32| <= this x |JAX bf16 - JAX f32|, as
# tests/test_torch_sar.py holds RootNet; one bf16 rounding the other way in
# an early conv reaches most outputs of the block's later convs.
BF16_ACCURACY_FACTOR = 2.0


def family_spec(head: str = "DET"):
    """A 29-layer spec at 8-64 channels that runs every deploy op once or
    more: REORG, C, STEM, GSTEM, GHOSTC, GHOST (stride 1 and 2), CAT,
    GCSPA/B/C, SP_, ADD, DOWNC, GSPP, STCSPA/B/C, SWINB (two layers: the
    shifted windows too), SPP, UP, MP, REP and the head ``head`` (DET, BIN
    or KPT, with 2 keypoints) over 3 levels (strides 8, 16, 32)."""
    return [
        (-1, "REORG", ()), (-1, "C", (16, 3, 2)), (-1, "GSTEM", (16,)),   # 0-2
        (1, "STEM", (16,)), (1, "C", (16, 3, 2)),                         # 3-4
        (-1, "GHOSTC", (16, 3, 1)), (-1, "GHOST", (16, 3, 1)),            # 5-6: P3
        (-1, "GHOST", (32, 3, 2)), ((-1, 2, 3), "CAT", ()),               # 7-8
        (-1, "GCSPA", (32, 1)), (-1, "GCSPB", (32, 1)), (-1, "GCSPC", (32, 1)),  # 9-11
        (-1, "SP_", (3,)), ((-1, -2), "ADD", ()),                         # 12-13: P4
        (-1, "DOWNC", (32,)), (-1, "GSPP", (32,)),                        # 14-15
        (-1, "STCSPA", (64, 1)), (-1, "STCSPB", (32, 1)), (-1, "STCSPC", (64, 1)),  # 16-18
        (-1, "SWINB", (32, 2, 2)), (-1, "SPP", (32,)),                    # 19-20: P5
        (-1, "C", (16, 1, 1)), (-1, "UP", ()), ((-1, 13), "CAT", ()), (-1, "MP", ()),  # 21-24
        (6, "REP", (16,)), (23, "REP", (32,)), (20, "REP", (32,)),        # 25-27
        ((25, 26, 27), head, (2,) if head == "KPT" else ()),              # 28
    ]


def family_cfgs(dtype: str = "float32", head: str = "DET"):
    """YoloConfig of the JAX package and of the port for family_spec."""
    kw = dict(nc=3, img_size=64, compute_dtype=dtype, bin_count=5, nkpt=2)
    return JM.YoloConfig(**kw), TM.YoloConfig(**kw)


def _np(x):
    return np.asarray(x.detach().float() if isinstance(x, torch.Tensor) else
                      jnp.asarray(x).astype(jnp.float32), np.float64)


def _close(got, ref, dtype, what):
    np.testing.assert_allclose(_np(got), _np(ref), rtol=TOL[dtype], atol=TOL[dtype],
                               err_msg=what)


VARIANT_CASES = [  # (op, c1, args, input H x W)
    ("GHOSTC", 16, (16, 3, 1), (16, 24)), ("GHOSTC", 16, (32, 3, 2), (16, 24)),
    ("GHOST", 16, (16, 3, 1), (16, 24)), ("GHOST", 16, (32, 3, 2), (16, 24)),
    ("GCSPA", 16, (32, 1), (16, 24)), ("GCSPB", 16, (32, 2), (16, 24)),
    ("GCSPC", 16, (32, 1), (16, 24)), ("GSPP", 16, (32,), (16, 24)),
    ("STEM", 8, (32,), (16, 24)), ("GSTEM", 8, (32,), (16, 24)),
    # Swin: 2 x 3 windows of 8, and 12 x 20 padded to whole windows; 2 layers
    # run the shifted windows and their mask
    ("SWINB", 16, (32, 2, 2), (16, 24)), ("SWINB", 32, (32, 1, 2), (12, 20)),
    ("STCSPA", 16, (64, 2), (16, 24)), ("STCSPB", 16, (32, 2), (16, 24)),
    ("STCSPC", 16, (64, 1), (16, 24)),
]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("op,c1,args,hw", VARIANT_CASES,
                         ids=[f"{c[0]}-{'x'.join(map(str, c[2]))}-{c[3][1]}" for c in VARIANT_CASES])
def test_variant_block_matches_jax(op, c1, args, hw, dtype):
    params = numpy_params(lambda k: JV.init_variant(op, k, c1, args), seed=len(op) + c1)
    x = np.random.default_rng(1).normal(size=(2,) + hw + (c1,)).astype(np.float32)
    jp = jax.tree_util.tree_map(jnp.asarray, params)
    jd = jnp.dtype(dtype)
    ref = jax_exact(lambda i: JV.apply_variant(op, jp, i.astype(jd), args), jnp.asarray(x))
    got = TV.apply_variant(op, to_port(params), torch.from_numpy(x).to(getattr(torch, dtype)),
                           args)
    assert tuple(got.shape) == ref.shape and got.dtype == getattr(torch, str(ref.dtype))
    if dtype == "float32":
        _close(got, ref, dtype, op)
        return
    ref32 = _np(jax_exact(lambda i: JV.apply_variant(op, jp, i, args), jnp.asarray(x)))
    floor = np.abs(_np(ref) - ref32).max()
    err = np.abs(_np(got) - ref32).max()
    assert 0 < floor and err <= BF16_ACCURACY_FACTOR * floor, (op, err, floor)


def test_swin_tables_match_jax():
    """The relative position index and the shift mask, element for element."""
    for ws in (4, 8):
        np.testing.assert_array_equal(TV.relative_position_index(ws),
                                      JV.relative_position_index(ws))
        for H, W in ((8, 8), (16, 24)):
            np.testing.assert_array_equal(TV.shift_mask(H, W, ws, ws // 2),
                                          JV._shift_mask(H, W, ws, ws // 2))


def _family_pair(head, seed, dtype, spec=None, jcfg=None, tcfg=None):
    spec = spec if spec is not None else family_spec(head)
    if jcfg is None:
        jcfg, tcfg = family_cfgs(dtype, head)
    params = numpy_params(lambda k: JM.init_yolov7(k, jcfg, spec=spec), seed=seed)
    return spec, jcfg, tcfg, params


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("head", ["DET", "BIN", "KPT"])
def test_family_spec_matches_jax(head, dtype):
    """f32: the decoded output. bf16: the trunk's raw head maps, and the f32
    decode of JAX's maps (BIN's argmax over near-tied bins and KPT's raw
    keypoint logits times the stride would turn a bf16 rounding into a jump
    of a bin or of pixels)."""
    spec, jcfg, tcfg, params = _family_pair(head, 11, dtype)
    x = np.random.default_rng(2).uniform(0, 1, (2, 64, 64, 3)).astype(np.float32)
    jp = jax.tree_util.tree_map(jnp.asarray, params)
    tp = to_port(params)
    width = {"DET": 8, "BIN": 8, "KPT": 8 + 3 * 2}[head]
    if dtype == "float32":
        ref = jax_exact(lambda i: JM.yolov7_forward(jp, i, jcfg, spec=spec), jnp.asarray(x))
        got = TM.yolov7_forward(tp, torch.from_numpy(x), tcfg, spec=spec)
        assert tuple(got.shape) == ref.shape == (2, 3 * (64 + 16 + 4), width)
        _close(got, ref, dtype, head)
    else:
        ref = jax_exact(lambda i: JM.yolov7_backbone_forward(jp, i, jcfg, spec=spec),
                        jnp.asarray(x))
        got = TM.yolov7_backbone_forward(tp, torch.from_numpy(x), tcfg, spec=spec)
        assert len(got) == len(ref) == 3
        for lvl, (g, r) in enumerate(zip(got, ref)):
            assert tuple(g.shape) == r.shape
            _close(g, r, dtype, f"{head} map {lvl}")
        maps = [np.asarray(r.astype(jnp.float32)) for r in ref]
        from hamer_yolo_tpu.models.yolov7 import heads as JH
        from hamer_yolo_tpu_torch.models.yolov7 import heads as TH

        jdec, tdec = {
            "DET": (JM.decode_detections, TM.decode_detections),
            "BIN": (lambda m, c: JH.decode_bin_detections(m, c, c.bin_count),
                    lambda m, c: TH.decode_bin_detections(m, c, c.bin_count)),
            "KPT": (lambda m, c: JH.decode_keypoint_detections(m, c, c.nkpt),
                    lambda m, c: TH.decode_keypoint_detections(m, c, c.nkpt))}[head]
        _close(tdec([torch.from_numpy(m) for m in maps], tcfg),
               jax_exact(lambda *ms: jdec(list(ms), jcfg), *maps), "float32", f"{head} decode")
    # init walks the same spec to the same structure and shapes
    mine = TM.init_yolov7(torch.Generator().manual_seed(0), tcfg, spec=spec)
    assert jax.tree_util.tree_structure(jax.tree_util.tree_map(lambda t: 0, mine)) == \
        jax.tree_util.tree_structure(jax.tree_util.tree_map(lambda t: 0, tp))
    for a, b in zip(jax.tree_util.tree_leaves(mine), jax.tree_util.tree_leaves(tp)):
        assert a.shape == b.shape


def test_sigmoid_bin_decode_matches_jax():
    from hamer_yolo_tpu.models.yolov7.heads import sigmoid_bin_decode as jdec
    from hamer_yolo_tpu_torch.models.yolov7.heads import sigmoid_bin_decode as tdec

    y = np.random.default_rng(3).uniform(0, 1, (4, 7, 22)).astype(np.float32)
    np.testing.assert_array_equal(tdec(torch.from_numpy(y)).numpy(), np.asarray(jdec(y)))


P6_YAML = {  # the w6 family's shape: ReOrg stem, DownC downsampling, 4 levels
    "nc": 2, "depth_multiple": 1.0, "width_multiple": 0.5,
    "anchors": [[19, 27, 44, 40], [38, 94, 96, 68], [86, 152, 180, 137], [140, 301, 303, 264]],
    "backbone": [                           # spec index: what, at a 128 input
        [-1, 1, "ReOrg", []],               # 0: 64 x 64 x 12
        [-1, 1, "Conv", [32, 3, 1]],        # 1
        [-1, 1, "DownC", [64]],             # 2: /4
        [-1, 2, "Conv", [64, 3, 1]],        # 3, 4: a repeat is two spec entries
        [-1, 1, "DownC", [64]],             # 5: /8
        [-1, 1, "Conv", [64, 1, 1]],        # 6
        [-1, 1, "DownC", [96]],             # 7: /16
        [-1, 1, "DownC", [128]],            # 8: /32
        [-1, 1, "DownC", [128]],            # 9: /64
        [-1, 1, "SPPCSPC", [64]],           # 10
    ],
    "head": [
        [9, 1, "Conv", [64, 1, 1]],         # 11
        [[-1, 10], 1, "Shortcut", []],      # 12
        [-1, 1, "nn.Upsample", [None, 2, "nearest"]],  # 13
        [[-1, 8], 1, "Concat", [1]],        # 14
        [6, 1, "SP", [5]],                  # 15: P3
        [7, 1, "RepConv", [64, 3, 1]],      # 16: P4
        [14, 1, "Conv", [64, 1, 1]],        # 17: P5
        [12, 1, "Conv", [64, 1, 1]],        # 18: P6
        [[15, 16, 17, 18, 15, 16, 17, 18], 1, "IAuxDetect", ["nc", "anchors"]],
    ],
}


@pytest.mark.parametrize("cfg_dict", [MINI_YAML, P6_YAML], ids=["mini", "p6"])
def test_spec_from_yaml_matches_jax(cfg_dict):
    spec, tcfg = spec_from_yaml(cfg_dict)
    jspec, jcfg = jax_spec_from_yaml(cfg_dict)
    assert spec == jspec
    assert (tcfg.nc, tcfg.anchors, tcfg.strides) == (jcfg.nc, jcfg.anchors, jcfg.strides)
    assert make_divisible(100 * 1.25) == 128 and make_divisible(3) == 8
    params = numpy_params(lambda k: JM.init_yolov7(k, jcfg, spec=spec), seed=12)
    size = 128 if len(tcfg.strides) == 4 else 64
    x = np.random.default_rng(4).uniform(0, 1, (1, size, size, 3)).astype(np.float32)
    jcfg32 = JM.YoloConfig(nc=jcfg.nc, anchors=jcfg.anchors, strides=jcfg.strides,
                           compute_dtype="float32")
    tcfg32 = TM.YoloConfig(nc=tcfg.nc, anchors=tcfg.anchors, strides=tcfg.strides,
                           compute_dtype="float32")
    jp = jax.tree_util.tree_map(jnp.asarray, params)
    ref = jax_exact(lambda i: JM.yolov7_forward(jp, i, jcfg32, spec=spec), jnp.asarray(x))
    got = TM.yolov7_forward(to_port(params), torch.from_numpy(x), tcfg32, spec=spec)
    _close(got, ref, "float32", "yaml")


@pytest.fixture(scope="module")
def tiny_yolo():
    jcfg = JM.YoloConfig(nc=3, img_size=64, compute_dtype="float32")
    tcfg = TM.YoloConfig(nc=3, img_size=64, compute_dtype="float32")
    return jcfg, tcfg, [numpy_params(lambda k: JM.init_yolov7(k, jcfg), seed=s) for s in (5, 6)]


def test_tta_matches_jax(tiny_yolo):
    """3 scales + the flip at 64 x 64 (53 and 42 px, padded to 64) and at
    64 x 96 (79 and 64 px wide, padded to 96 and 64: the pads' ceilings
    taken of the float products)."""
    jcfg, tcfg, (params, _) = tiny_yolo
    jp = jax.tree_util.tree_map(jnp.asarray, params)
    tp = to_port(params)
    for hw in ((64, 64), (64, 96)):
        x = np.random.default_rng(5).uniform(0, 1, (2,) + hw + (3,)).astype(np.float32)
        ref = jax_exact(lambda i: jax_forward_tta(jp, i, jcfg), jnp.asarray(x))
        got = yolov7_forward_tta(tp, torch.from_numpy(x), tcfg)
        assert tuple(got.shape) == ref.shape
        _close(got, ref, "float32", f"tta {hw}")


def test_ensemble_matches_jax(tiny_yolo):
    jcfg, tcfg, params = tiny_yolo
    x = np.random.default_rng(6).uniform(0, 1, (1, 64, 64, 3)).astype(np.float32)
    jps = [jax.tree_util.tree_map(jnp.asarray, p) for p in params]
    ref = jax_exact(lambda i: JM.yolov7_ensemble_forward(jps, i, jcfg), jnp.asarray(x))
    got = TM.yolov7_ensemble_forward([to_port(p) for p in params], torch.from_numpy(x), tcfg)
    assert tuple(got.shape) == ref.shape == (1, 2 * 252, 8)
    _close(got, ref, "float32", "ensemble")


def _clustered_prediction(seed, B=2, N=300, nc=3, extra=0):
    """Decoded predictions with boxes in clusters (so that merges happen),
    scores spread over the threshold, ``extra`` trailing columns."""
    rng = np.random.default_rng(seed)
    centres = rng.uniform(20, 200, (B, 12, 2))
    pick = rng.integers(0, 12, (B, N))
    xy = np.take_along_axis(centres, pick[..., None], axis=1) + rng.normal(0, 3, (B, N, 2))
    wh = rng.uniform(20, 40, (B, N, 2))
    obj = rng.uniform(0, 1, (B, N, 1))
    cls = rng.uniform(0, 1, (B, N, nc))
    more = rng.normal(0, 50, (B, N, extra))
    return np.concatenate([xy, wh, obj, cls, more], axis=-1).astype(np.float32)


def _same_keep(got, ref, box_tol):
    np.testing.assert_array_equal(got.valid.numpy(), np.asarray(ref.valid))
    np.testing.assert_array_equal(got.classes.numpy(), np.asarray(ref.classes))
    np.testing.assert_array_equal(got.scores.numpy(), np.asarray(ref.scores))  # the keep set
    np.testing.assert_allclose(got.boxes.numpy(), np.asarray(ref.boxes), rtol=box_tol,
                               atol=box_tol)


@pytest.mark.parametrize("agnostic", [True, False])
@pytest.mark.parametrize("redundant", [True, False])
def test_merge_nms_matches_jax(redundant, agnostic):
    pred = _clustered_prediction(7)
    kw = dict(conf_thres=0.25, iou_thres=0.45, classes=None, agnostic=agnostic, max_det=40,
              max_nms_static=256)
    ref = jnms.non_max_suppression(jnp.asarray(pred), merge=True, redundant=redundant,
                                   use_pallas=False, **kw)
    got = tnms.non_max_suppression(torch.from_numpy(pred), merge=True, redundant=redundant, **kw)
    assert np.asarray(ref.valid).sum() > 4
    _same_keep(got, ref, 1e-5)  # merged boxes (pixels): f32 sums in another order
    plain = tnms.non_max_suppression(torch.from_numpy(pred), **kw)
    assert not torch.equal(plain.boxes[got.valid], got.boxes[got.valid]), "no box merged"


@pytest.mark.parametrize("nc", [1, 3])
def test_nms_kpt_matches_jax(nc):
    pred = _clustered_prediction(8, nc=nc, extra=3 * 4)
    kw = dict(conf_thres=0.2, iou_thres=0.45, nc=nc, max_det=30, max_nms_static=256)
    ref = jnms.non_max_suppression_kpt(jnp.asarray(pred), use_pallas=False, **kw)
    got = tnms.non_max_suppression_kpt(torch.from_numpy(pred), **kw)
    assert np.asarray(ref.valid).sum() > 4
    _same_keep(got, ref, 0.0)
    np.testing.assert_array_equal(got.kpts.numpy(), np.asarray(ref.kpts))


# ReOrg then a 3x3 stride-1 conv, the peephole's pattern, then three stride-2
# convs to the head's levels (strides 8, 16, 32 at 64 px)
REORG_SPEC = [(-1, "REORG", ()), (-1, "C", (16, 3, 1)), (-1, "C", (16, 3, 2)),
              (-1, "C", (24, 3, 2)), (-1, "C", (32, 3, 2)), (-1, "C", (32, 3, 2)),
              ((3, 4, 5), "DET", ())]


@pytest.mark.parametrize("knob", ["1", "0", "auto"])
def test_reorg_fusion_matches_jax(knob, monkeypatch):
    """HYT_FUSE_REORG: "1" fuses the ReOrg into the conv after it (one 6x6
    stride-2 conv on the raw input) in both packages, "0" and "auto" (on a
    TPU only) leave it apart; the decoded output at the f32 1e-4 of JAX's
    own case (tests/test_yolo.py), and the fused weight equal to JAX's."""
    from hamer_yolo_tpu.models.yolov7 import blocks as JB
    from hamer_yolo_tpu_torch.models.yolov7 import blocks as TB

    monkeypatch.setenv("HYT_FUSE_REORG", knob)
    spec, jcfg, tcfg, params = _family_pair("DET", 5, "float32", spec=REORG_SPEC)
    x = np.random.default_rng(6).uniform(0, 1, (2, 64, 64, 3)).astype(np.float32)
    jp = jax.tree_util.tree_map(jnp.asarray, params)
    ref = jax_exact(lambda i: JM.yolov7_forward(jp, i, jcfg, spec=spec), jnp.asarray(x))
    fused = []
    block = TB.reorg_conv_block
    monkeypatch.setattr(TB, "reorg_conv_block", lambda *a: fused.append(1) or block(*a))
    tp = to_port(params)
    got = TM.yolov7_forward(tp, torch.from_numpy(x), tcfg, spec)
    assert len(fused) == (knob == "1")
    _close(got, ref, "float32", f"HYT_FUSE_REORG={knob}")
    w6 = np.asarray(JB.reorg_conv_weight(jp["layers"][1]["conv"]["w"]))  # (6, 6, C, O)
    np.testing.assert_array_equal(TB.reorg_conv_weight(tp["layers"][1]["conv"]["w"]).numpy(),
                                  w6.transpose(3, 2, 0, 1))
