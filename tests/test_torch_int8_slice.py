"""The int8 slice end to end at the --tiny config: infer_frames with the int8
backbone and calibrated static scales against the JAX package, the
kernel-math path against the port's own unfused path, the calibration tool,
and the CLI's ``--fast-path int8 --calib-scales``."""
import dataclasses
import inspect
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from hamer_yolo_tpu.core import quant as jquant
from hamer_yolo_tpu.pipeline.frame import infer_frames as jax_infer_frames
from hamer_yolo_tpu_torch.cli.main import build_parser, main
from hamer_yolo_tpu_torch.core import quant
from hamer_yolo_tpu_torch.core.checkpoint import init_pipeline_params
from hamer_yolo_tpu_torch.io.writers import load_hand_npy
from hamer_yolo_tpu_torch.pipeline.frame import infer_frames
from hamer_yolo_tpu_torch.pipeline.runner import FrameProgram, process_image_dir
from hamer_yolo_tpu_torch.tools import calibrate_int8
from test_torch_bridge import jax_exact, mano_pair, np_tree, pipeline_params, tiny_configs, to_port
from test_torch_pipeline import _check_frame, _inputs

torch.set_num_threads(1)


def _int8(jcfg, tcfg, seed):
    """Tiny-config weights with the backbone quantized and calibrated by the
    JAX package (compiled), in both packages, and both configs with the int8
    backbone on."""
    params = jax.tree_util.tree_map(jnp.asarray, pipeline_params(jcfg, seed=seed))
    vit = jcfg.hamer.vit
    pq = jax.jit(jquant.quantize_vit_params)(params["hamer"]["backbone"])
    crops = np.random.default_rng(seed).normal(size=(4, *vit.img_size, 3)).astype(np.float32)
    stats = jax_exact(lambda p, x: jquant.collect_vit_act_stats(p, x, vit), pq, jnp.asarray(crops))
    params["hamer"]["backbone"] = jax.jit(jquant.attach_static_act_scales)(pq, stats)

    def on(cfg):
        return dataclasses.replace(cfg, hamer=dataclasses.replace(cfg.hamer, int8_backbone=True))
    return params, on(jcfg), on(tcfg)


def test_infer_frames_int8_matches_jax():
    """The port's unfused int8 slice (its default on the CPU, as JAX's) at the
    CLI's bf16 against JAX compiled with excess precision off. The two
    quantize the same values by the same rule and part only where a value
    sits within an ulp of an int8 rounding midpoint (see
    tests/test_torch_int8_vit.py); on these frames none does, so the limit
    is the one the port's bf16 slice meets against JAX
    (tests/test_torch_pipeline.py, 8e-3)."""
    jm, tm = mano_pair()
    imgs, hws, Ks = _inputs()
    jcfg, tcfg = tiny_configs("bfloat16")
    params, jcfg, tcfg = _int8(jcfg, tcfg, seed=1)
    ref = np_tree(jax_exact(lambda i, h, k: jax_infer_frames(params, jm, i, h, k, jcfg),
                            imgs, hws, Ks))
    got = np_tree(infer_frames(to_port(params), tm, torch.from_numpy(imgs), torch.from_numpy(hws),
                               torch.from_numpy(Ks), tcfg))
    assert ref["valid"].any(), "no valid slot: the comparison would be empty"
    for b in range(imgs.shape[0]):
        _check_frame({k: v[b] for k, v in got.items()}, {k: v[b] for k, v in ref.items()},
                     "bfloat16", f"frame {b}")


@pytest.mark.parametrize("scales", ["static", "dynamic"])
def test_infer_frames_kernel_math_matches_unfused(scales):
    """The kernel path (fused=True: K3 + K4, or K5 + K7 + K5 and K5 twice,
    through their plain versions) against the port's own unfused path, at
    the JAX package's tolerance for its fused int8 ViT
    (tests/test_int8_fused.py:509-510): the backbone on the slice's own
    crops, and the mesh and joints the slice writes. The two paths quantize
    at other points (K3 rounds qkv to bf16, the kernels' prologues run in
    f32), so the backbones differ by a few hundredths; the random-weight
    MANO head amplifies that in betas and the camera (by up to ~5x here),
    so those fields are compared through the mesh they produce."""
    _, tm = mano_pair()
    np_imgs, np_hws, np_Ks = _inputs()
    imgs, hws, Ks = (torch.from_numpy(a) for a in (np_imgs, np_hws, np_Ks))
    jcfg, tcfg = tiny_configs("float32")
    params, _, tcfg = _int8(jcfg, tcfg, seed=2)
    port = to_port(params)
    if scales == "dynamic":
        for blk in port["hamer"]["backbone"]["blocks"]:
            for lin in (*blk["attn"].values(), *blk["mlp"].values()):
                del lin["sx"]

    def run(fused):
        cfg = dataclasses.replace(tcfg, hamer=dataclasses.replace(
            tcfg.hamer, vit=dataclasses.replace(tcfg.hamer.vit, fused_attn=fused)))
        return np_tree(infer_frames(port, tm, imgs, hws, Ks, cfg))

    ref, got = run(False), run(True)
    assert ref["valid"].any() and (ref["valid"] == got["valid"]).all()
    for k in ("keypoints_3d", "vertices"):
        np.testing.assert_allclose(got[k][ref["valid"]], ref[k][ref["valid"]], rtol=0.05,
                                   atol=0.05, err_msg=k)
    crops = torch.cat([calibrate_int8.frame_crops(port["yolo"], f, tcfg, "cpu") for f in np_imgs])
    vit = port["hamer"]["backbone"]
    ref = quant.vit_forward_int8(vit, crops, tcfg.hamer.vit, fused=False)
    got = quant.vit_forward_int8(vit, crops, tcfg.hamer.vit, fused=True)
    torch.testing.assert_close(got, ref, rtol=0.05, atol=0.05)


@pytest.fixture
def image_dir(tmp_path):
    import cv2

    rng = np.random.default_rng(0)
    d = tmp_path / "imgs"
    d.mkdir()
    for i, (h, w) in enumerate([(100, 120), (90, 130), (130, 70)]):
        cv2.imwrite(str(d / f"f{i}.png"), rng.integers(0, 255, (h, w, 3)).astype(np.uint8))
    return str(d)


def test_calibrate_then_cli_int8(image_dir, tmp_path):
    """The calibration tool writes the stats file, and ``infer --tiny
    --fast-path int8 --calib-scales`` on the CPU writes the npy and OBJ
    files."""
    scales = str(tmp_path / "scales.npz")
    assert calibrate_int8.main(["--input", image_dir, "--out", scales, "--tiny",
                                "--device", "cpu", "--batch", "2"]) == 0
    z = np.load(scales)
    assert sorted(z.files) == sorted(f"blk{i:02d}_{k}" for i in range(2)
                                     for k in ("qkv", "proj", "fc1", "fc2"))
    assert all(float(z[k]) > 0 for k in z.files)
    out = str(tmp_path / "out")
    assert main(["infer", "--tiny", "--device", "cpu", "--fast-path", "int8", "--calib-scales",
                 scales, "--input", image_dir, "--output", out]) == 0
    npys = sorted(f for f in os.listdir(out) if f.endswith(".npy"))
    assert npys == ["f0.npy", "f1.npy", "f2.npy"]
    assert os.listdir(os.path.join(out, "obj"))
    results = load_hand_npy(os.path.join(out, "f0.npy"))
    assert set(results) == {"left", "right"}
    assert any(v is not None for v in results.values())


def test_calibrate_frames_matches_collect(image_dir):
    """calibrate_frames max-reduces over its batches: the stats of one pass
    over all crops equal the max over batches of two."""
    import cv2

    from hamer_yolo_tpu_torch.cli.main import load_mano, pipeline_config

    cfg = pipeline_config(tiny=True)
    params = init_pipeline_params(0, load_mano(None, "cpu"), cfg.yolo, cfg.hamer,
                                  with_sar=False, device="cpu")
    frames = [cv2.imread(os.path.join(image_dir, f)) for f in sorted(os.listdir(image_dir))]
    stats, n = calibrate_int8.calibrate_frames(params, frames, cfg, "cpu", batch=2)
    crops = torch.cat([calibrate_int8.frame_crops(params["yolo"], f, cfg, "cpu") for f in frames])
    assert n == crops.shape[0] > 2
    one = quant.collect_vit_act_stats(quant.quantize_vit_params(params["hamer"]["backbone"]),
                                      crops, cfg.hamer.vit)
    for a, b in zip(stats["blocks"], one["blocks"]):
        for k in a:
            torch.testing.assert_close(a[k], b[k], rtol=1e-5, atol=0)


def test_entry_points_default_to_the_card():
    args = build_parser().parse_args(["infer", "--input", "a", "--output", "b"])
    assert args.device == "cuda" and args.fast_path == "none"
    assert inspect.signature(FrameProgram).parameters["device"].default == "cuda"
    assert inspect.signature(process_image_dir).parameters["device"].default == "cuda"
    assert inspect.signature(init_pipeline_params).parameters["device"].default == "cuda"
    assert build_parser().parse_args(["infer", "--input", "a", "--output", "b", "--device",
                                      "cpu"]).device == "cpu"
