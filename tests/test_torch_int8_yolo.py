"""The W8A8 detector (``--int8-yolo``) against the JAX package: the int8
conv routes of core/nn.conv2d, quantize_yolo_params, the calibration, the
bridge's int8 conv leaves, the int8 detector, the calibration frames with
cv2's resize in numpy, and ``detect --int8-yolo`` through both CLIs.

Inputs are numpy-made from seeds; the JAX side is compiled with XLA's
excess precision off (jax_exact), with the weights passed as arguments, as
JAX's programs take them (closed over, a static "sx" would be a constant,
and XLA turns x / sx into x times its reciprocal), except JAX's
calibration, which runs eagerly as the JAX package runs it.

Limits. Each int8 conv route is bit-equal to JAX's: int32 sums are exact
and the quantize and dequantize follow JAX's op order, so no flip is
allowed. The quantized trees are leaf-equal. The calibrated scales are held
within 1 f32 ulp where every op before each conv is exact in both packages
(f32 activations, every conv int8); with spatial convs left in floating
point ("1x1") the conv sums round in another order, and in bf16 torch's
sigmoid rounds once where XLA's expansion rounds four times (1116 of the
34192 finite bf16 inputs below 100 differ by one bf16 step), so a flipped
int8 step upstream moves a conv's input absmax: there the scales are held
within CALIB_REL (measured 2.0% at most, a few bf16 steps). The detector's
decoded output is held as the bf16 trunks of test_torch_sar are: the
port's int8 detector must be as accurate as JAX's against JAX's f32 float
detector on the same weights, within INT8_ACCURACY_FACTOR.
"""
import functools
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from hamer_yolo_tpu.core import checkpoint as jck
from hamer_yolo_tpu.core import nn as jnn
from hamer_yolo_tpu.core import quant as jq
from hamer_yolo_tpu.models.yolov7 import model as jy
from hamer_yolo_tpu_torch.cli.main import calibration_frames, main
from hamer_yolo_tpu_torch.core import checkpoint as tck
from hamer_yolo_tpu_torch.core import nn as tnn
from hamer_yolo_tpu_torch.core import quant as tq
from hamer_yolo_tpu_torch.core.bridge import from_jax_params
from hamer_yolo_tpu_torch.core.int8_conv import record_conv_absmax
from hamer_yolo_tpu_torch.io.images import letterbox_centered, resize_linear
from hamer_yolo_tpu_torch.models.yolov7 import model as ty
from test_torch_bridge import REPO, jax_exact, mano_pair, numpy_params

torch.set_num_threads(1)

CALIB_REL = 0.03
INT8_ACCURACY_FACTOR = 2.0  # |port int8 - JAX f32| <= this x |JAX int8 - JAX f32|
SCORE_ATOL = 2e-3  # detect --int8-yolo scores, port against JAX (measured 3e-4)


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


# --------------------------------------------------------------- conv routes
ROUTES = [
    # (kernel, c_in, c_out, stride, padding, groups)
    (1, 16, 24, 1, 0, 1), (1, 16, 24, 2, 0, 1), (1, 16, 24, 1, "SAME", 1),
    (3, 16, 24, 1, 1, 1), (3, 16, 24, 1, "SAME", 1), (3, 16, 24, 1, "VALID", 1),
    (3, 16, 24, 1, ((1, 2), (0, 1)), 1), (3, 16, 24, 2, 1, 1), (3, 16, 24, 2, "SAME", 1),
    (3, 16, 24, 2, "VALID", 1), (3, 16, 24, 2, ((1, 2), (0, 1)), 1), (3, 16, 24, 1, 1, 4),
    (5, 16, 16, 2, 2, 16), (3, 3, 32, 2, 1, 1),
]


@pytest.mark.parametrize("static", [True, False], ids=["sx", "dynamic"])
@pytest.mark.parametrize("k,cin,cout,stride,padding,groups", ROUTES)
def test_int8_conv_route_matches_jax_bit_for_bit(k, cin, cout, stride, padding, groups, static):
    """1x1 (static and per-pixel scales), spatial with "sx" (shifted GEMMs,
    every padding form, strides 1 and 2), and the per-tensor route (grouped
    convs, "sx" ignored as JAX ignores it; spatial without "sx"), bf16
    activations: bit-equal, no flip."""
    rng = np.random.default_rng(k * 100 + cin + stride)
    w = rng.uniform(-0.3, 0.3, (k, k, cin // groups, cout)).astype(np.float32)
    x = (2 * rng.normal(size=(2, 11, 13, cin))).astype(np.float32)
    p = {"w": _np(jax.jit(jq.quantize_conv_weight)(w)),
         "b": (0.1 * rng.normal(size=cout)).astype(np.float32)}
    if static:
        p["sx"] = np.float32(np.abs(x).max() * 0.9 / 127)
    jp = jax.tree_util.tree_map(jnp.asarray, p)
    ref = np.asarray(jax_exact(lambda pp, a: jnn.conv2d(pp, a.astype(jnp.bfloat16),
                                                        stride=stride, padding=padding,
                                                        groups=groups), jp, x)
                     .astype(jnp.float32))
    got = tnn.conv2d(from_jax_params(p), torch.from_numpy(x).bfloat16(), stride=stride,
                     padding=padding, groups=groups)
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(got.float().numpy(), ref)


def test_float_conv_takes_jax_padding_forms():
    """The floating-point conv takes "SAME", "VALID" and explicit pairs as
    JAX's does (f32, sum order only)."""
    rng = np.random.default_rng(3)
    p = {"w": rng.normal(size=(3, 3, 4, 5)).astype(np.float32)}
    x = rng.normal(size=(1, 9, 10, 4)).astype(np.float32)
    for stride in (1, 2):
        for padding in ("SAME", "VALID", ((2, 0), (1, 2))):
            ref = np.asarray(jnn.conv2d(jax.tree_util.tree_map(jnp.asarray, p), jnp.asarray(x),
                                        stride=stride, padding=padding))
            got = tnn.conv2d(from_jax_params(p), torch.from_numpy(x), stride, padding).numpy()
            np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-5)


# ------------------------------------------------------------ quantize trees
@pytest.fixture(scope="module")
def yolo_params():
    jc = jy.YoloConfig(nc=3, img_size=64)
    return _np(numpy_params(lambda k: jy.init_yolov7(k, jc), 3))


MODES = {"1x1": dict(only_1x1=True), "all": dict(only_1x1=False),
         "all_detect": dict(only_1x1=False, quant_detect=True)}


@pytest.mark.parametrize("mode", list(MODES))
def test_quantize_yolo_params_leaf_equal(yolo_params, mode):
    """The int8 q, per-channel scales and the f32 leaves left as they were,
    leaf for leaf (q in the port's OIHW layout); the head keeps f32 weights
    unless quant_detect."""
    ref = _np(jax.jit(functools.partial(jq.quantize_yolo_params, **MODES[mode]))(yolo_params))
    got = tq.quantize_yolo_params(from_jax_params(yolo_params), **MODES[mode])
    ref_port = from_jax_params(ref)
    flat_ref = jax.tree_util.tree_flatten_with_path(ref_port)[0]
    flat_got = jax.tree_util.tree_flatten_with_path(got)[0]
    assert [p for p, _ in flat_ref] == [p for p, _ in flat_got]
    n_q = 0
    for (path, r), (_, g) in zip(flat_ref, flat_got):
        assert r.dtype == g.dtype and torch.equal(r, g), jax.tree_util.keystr(path)
        n_q += r.dtype == torch.int8
    head = got["layers"][-1]["m"][0]["w"]
    assert isinstance(head, dict) == (mode == "all_detect") and n_q > 0


CALIB_FRAMES = list(np.random.default_rng(2).random((2, 64, 64, 3)).astype(np.float32))


@functools.lru_cache(maxsize=None)
def jax_calibrated(dtype: str, mode: str):
    """(JAX's quantize_yolo_params tree, its calibrate_yolo_act_scales tree
    on CALIB_FRAMES), numpy leaves; made once per (dtype, mode): JAX's eager
    calibration takes seconds."""
    params = _np(numpy_params(lambda k: jy.init_yolov7(k, jy.YoloConfig(nc=3, img_size=64)), 3))
    jc = jy.YoloConfig(nc=3, img_size=64, compute_dtype=dtype)
    q = jax.jit(functools.partial(jq.quantize_yolo_params, only_1x1=mode == "1x1"))(params)
    return _np(q), _np(jq.calibrate_yolo_act_scales(q, CALIB_FRAMES, jc))


@pytest.mark.parametrize("mode", ["1x1", "all"])
def test_bridge_loads_jax_calibrated_trees(mode):
    """JAX's quantize_yolo_params + calibrate_yolo_act_scales tree loads
    through the bridge with no leaf refused: int8 q HWIO -> OIHW, f32
    per-channel scales, f32 scalar sx."""
    tree = jax_calibrated("bfloat16", mode)[1]
    port = from_jax_params(tree)
    n_leaves = len(jax.tree_util.tree_leaves(tree))
    assert n_leaves == len([t for t in jax.tree_util.tree_leaves(port)
                            if isinstance(t, torch.Tensor)])
    conv = port["layers"][0]["conv"] if mode == "all" else port["layers"][4]["conv"]
    jconv = tree["layers"][0]["conv"] if mode == "all" else tree["layers"][4]["conv"]
    assert conv["w"]["q"].dtype == torch.int8 and conv["sx"].shape == ()
    np.testing.assert_array_equal(conv["w"]["q"].numpy(), jconv["w"]["q"].transpose(3, 2, 0, 1))


# ---------------------------------------------------------------- calibration
def _sx(tree):
    return np.array([np.float32(np.asarray(leaf.detach().cpu() if isinstance(leaf, torch.Tensor)
                                           else leaf))
                     for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]
                     if getattr(path[-1], "key", None) == "sx"])


@pytest.mark.parametrize("dtype,mode", [("float32", "all"), ("float32", "1x1"),
                                        ("bfloat16", "all"), ("bfloat16", "1x1")])
def test_calibrate_yolo_act_scales_matches_jax(dtype, mode):
    """sx on every int8 conv, on two frames: within 1 f32 ulp where the
    forward before each conv is exact in both (f32, all), else within
    CALIB_REL (module docstring)."""
    tc = ty.YoloConfig(nc=3, img_size=64, compute_dtype=dtype)
    q, calibrated = jax_calibrated(dtype, mode)
    ref = _sx(calibrated)
    got = _sx(tq.calibrate_yolo_act_scales(from_jax_params(q), CALIB_FRAMES, tc))
    assert len(got) == len(ref) > 0 and np.all(ref > 0)
    if (dtype, mode) == ("float32", "all"):
        np.testing.assert_array_max_ulp(got, ref, maxulp=1)
    else:
        np.testing.assert_allclose(got, ref, rtol=CALIB_REL, atol=0)


def test_calibrate_raises_without_an_int8_conv(yolo_params):
    with pytest.raises(RuntimeError, match="no quantized conv"):
        tq.calibrate_yolo_act_scales(from_jax_params(yolo_params),
                                     [np.zeros((64, 64, 3), np.float32)],
                                     ty.YoloConfig(nc=3, img_size=64))


def test_record_conv_absmax_keys_by_weight_tensor(yolo_params):
    """The recorder holds the running max |x| of each int8 conv's input over
    calls, keyed by its int8 weight tensor, and records nothing outside."""
    tree = tq.quantize_yolo_params(from_jax_params(yolo_params), only_1x1=False)
    cfg = ty.YoloConfig(nc=3, img_size=64)
    x = torch.from_numpy(np.random.default_rng(0).random((1, 64, 64, 3)).astype(np.float32))
    with record_conv_absmax() as once:
        ty.yolov7_forward(tree, x, cfg)
    with record_conv_absmax() as twice:
        ty.yolov7_forward(tree, x * 0.5, cfg)
        ty.yolov7_forward(tree, x, cfg)
    q0 = tree["layers"][0]["conv"]["w"]["q"]
    assert q0 in once and once[q0] == float(x.bfloat16().abs().max())
    assert set(once) == set(twice) and all(twice[k] >= once[k] * 0.999 for k in once)
    ty.yolov7_forward(tree, x, cfg)  # no recorder: nothing recorded, nothing raised


# ------------------------------------------------------------------- detector
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("mode", ["1x1", "all"])
def test_int8_detector_matches_jax(yolo_params, dtype, mode):
    """yolov7_forward on JAX's calibrated tree: decoded (B, N, 8), the
    port's int8 error against JAX's f32 float detector within
    INT8_ACCURACY_FACTOR of JAX's own."""
    jc = jy.YoloConfig(nc=3, img_size=64, compute_dtype=dtype)
    tc = ty.YoloConfig(nc=3, img_size=64, compute_dtype=dtype)
    x = np.random.default_rng(4).random((2, 64, 64, 3)).astype(np.float32)
    jpf = jax.tree_util.tree_map(jnp.asarray, yolo_params)
    ref32 = np.asarray(jax_exact(lambda pp, a: jy.yolov7_forward(
        pp, a, jy.YoloConfig(nc=3, img_size=64, compute_dtype="float32")), jpf, x))
    tree = jax_calibrated(dtype, mode)[1]
    jp = jax.tree_util.tree_map(jnp.asarray, tree)
    ref = np.asarray(jax_exact(lambda pp, a: jy.yolov7_forward(pp, a, jc), jp, x))
    got = ty.yolov7_forward(from_jax_params(tree), torch.from_numpy(x), tc).numpy()
    assert got.shape == ref.shape and np.isfinite(got).all()
    floor = np.abs(ref - ref32).max()
    assert floor > 0
    assert np.abs(got - ref32).max() <= INT8_ACCURACY_FACTOR * floor, (
        f"port int8 vs JAX f32 {np.abs(got - ref32).max():.4g}, JAX int8 vs f32 {floor:.4g}")


# ------------------------------------------------------- calibration frames
def _cv2_shapes():
    rng = np.random.default_rng(1)
    shapes = [(int(rng.integers(2, 300)), int(rng.integers(2, 300))) for _ in range(60)]
    return shapes + [(128, 128), (100, 120), (90, 130), (130, 70), (720, 1280), (2, 3)]


def test_resize_linear_matches_cv2():
    """io/images.resize_linear is cv2.resize(INTER_LINEAR) byte for byte on
    uint8 images: downscales, upscales, exact 2x (cv2's INTER_AREA), one-row
    and one-column targets, at the letterbox's sizes for 64 and 640."""
    import cv2

    rng = np.random.default_rng(0)
    for h, w in _cv2_shapes():
        img = rng.integers(0, 256, (h, w, 3)).astype(np.uint8)
        for size in (64, 640):
            r = min(size / h, size / w)
            nw, nh = int(round(w * r)), int(round(h * r))
            np.testing.assert_array_equal(resize_linear(img, (nw, nh)),
                                          cv2.resize(img, (nw, nh)), err_msg=f"{h}x{w}->{size}")
    img = rng.integers(0, 256, (37, 53, 3)).astype(np.uint8)
    for size_wh in ((1, 9), (9, 1), (53, 37), (200, 17)):
        np.testing.assert_array_equal(resize_linear(img, size_wh), cv2.resize(img, size_wh))


@pytest.fixture
def image_dir(tmp_path):
    import cv2

    rng = np.random.default_rng(0)
    d = tmp_path / "imgs"
    d.mkdir()
    for i, (h, w) in enumerate([(100, 120), (90, 130), (130, 70)]):
        cv2.imwrite(str(d / f"f{i}.png"), rng.integers(0, 255, (h, w, 3)).astype(np.uint8))
    return str(d)


def test_calibration_frames_match_jax(image_dir, tmp_path):
    """The first two images of the dir, letterboxed and centred as the JAX
    CLI's _calibration_frames makes them (cv2's resize there); noise seeded
    with 2 where the dir holds no image."""
    from hamer_yolo_tpu.cli.main import _calibration_frames

    for d in (image_dir, str(tmp_path), None):
        for size in (64, 640):
            ref, got = _calibration_frames(d, size), calibration_frames(d, size)
            assert len(got) == len(ref) == 2
            for a, b in zip(got, ref):
                assert a.dtype == b.dtype == np.float32
                np.testing.assert_array_equal(a, b)
    img = np.full((10, 30, 3), 7, np.uint8)
    canvas = letterbox_centered(img, 64)
    assert (canvas[:21] == 114).all() and (canvas[21:42] == 7).all() and (canvas[42:] == 114).all()


# ------------------------------------------------------------------- the CLI
@pytest.fixture(scope="module")
def checkpoints(tmp_path_factory):
    """The JAX CLI's --tiny weights (numpy-made) as an orbax directory and as
    the port's .npz."""
    from hamer_yolo_tpu.cli.main import _load_runtime

    class Args:
        tiny, mano_dir, max_hands, checkpoint = True, None, 2, None

    _, _, jcfg = _load_runtime(Args())
    jm, _ = mano_pair()
    tree = _np(numpy_params(lambda k: jck.init_pipeline_params(
        k, jm, yolo_cfg=jcfg.yolo, hamer_cfg=jcfg.hamer, sar_cfg=jcfg.sar), seed=8))
    d = tmp_path_factory.mktemp("ckpt")
    orbax, npz = str(d / "orbax"), str(d / "ckpt.npz")
    jck.save_checkpoint(orbax, jax.tree_util.tree_map(jnp.asarray, tree))
    tck.save_checkpoint(npz, tree)
    return orbax, npz


def jax_cli(args):
    """The JAX CLI in a process of its own with XLA's excess precision off
    (ROADMAP F6): its stdout."""
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=REPO,
               XLA_FLAGS=os.environ.get("XLA_FLAGS", "") + " --xla_allow_excess_precision=false")
    res = subprocess.run([sys.executable, "-m", "hamer_yolo_tpu.cli.main"] + args, env=env,
                         cwd=REPO, capture_output=True, text=True, timeout=600)
    assert res.returncode == 0, res.stderr[-2000:]
    return res.stdout


@pytest.mark.parametrize("mode", ["1x1", "all"])
def test_cli_detect_int8_yolo_matches_jax_cli(checkpoints, image_dir, capsys, mode):
    """``detect --tiny --int8-yolo`` from the same weights, calibrated on the
    same two images: the same detections in the same order, labels, classes
    and (integer) boxes equal, scores within SCORE_ATOL."""
    orbax, npz = checkpoints
    args = ["detect", "--tiny", "--max-hands", "2", "--input", image_dir, "--int8-yolo", mode]
    ref = [json.loads(ln) for ln in jax_cli(args + ["--checkpoint", orbax]).splitlines()]
    assert main(args + ["--device", "cpu", "--checkpoint", npz]) == 0
    got = [json.loads(ln) for ln in capsys.readouterr().out.strip().splitlines()]
    assert [r["image"] for r in got] == [r["image"] for r in ref] == ["f0.png", "f1.png", "f2.png"]
    n = 0
    for g, r in zip(got, ref):
        assert len(g["detections"]) == len(r["detections"]), g["image"]
        for a, b in zip(g["detections"], r["detections"]):
            assert (a["label"], a["class"], a["box"]) == (b["label"], b["class"], b["box"])
            assert abs(a["score"] - b["score"]) <= SCORE_ATOL
            n += 1
    assert n, "no detection: the comparison would be empty"


def test_int8_yolo_on_every_subcommand(image_dir, tmp_path, capsys):
    """--int8-yolo parses on every subcommand but rgbd (JAX's common()), and
    the tiny runs of infer, serve and depth take it; reconstruct loads no
    detector, so the flag changes nothing there."""
    from hamer_yolo_tpu_torch.cli.main import build_parser

    parser = build_parser()
    for cmd, extra in (("infer", ["--output", "o"]), ("serve", []), ("serve-http", []),
                       ("detect", []), ("depth", []), ("reconstruct", ["--output", "o"])):
        base = [cmd] + (["--input", "i"] if cmd != "serve-http" else []) + extra
        assert parser.parse_args(base).int8_yolo == "off"
        assert parser.parse_args(base + ["--int8-yolo", "all"]).int8_yolo == "all"
    with pytest.raises(SystemExit):
        parser.parse_args(["detect", "--input", "i", "--int8-yolo", "4bit"])
    tiny = ["--tiny", "--device", "cpu", "--int8-yolo", "all"]
    out = str(tmp_path / "out")
    assert main(["infer", "--input", image_dir, "--output", out, "--no-obj"] + tiny) == 0
    assert main(["depth", "--input", image_dir] + tiny) == 0
    assert main(["serve", "--input", image_dir, "--batch", "2"] + tiny) == 0
    said = capsys.readouterr().out
    assert "processed 3 frames" in said and said.count("root_depths") == 3 and "3 frames in" in said
