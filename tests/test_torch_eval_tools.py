"""The port's evaluation tools (hamer_yolo_tpu_torch/tools: eval_fastpaths,
eval_hamer, eval_detector, parity_check) against the JAX package: the fast
path arms at a tiny config against the same arms composed from JAX
functions on the same (bridged) weights and crops; eval_hamer's two modes
against JAX's tool and functions; eval_detector on a small labelled folder;
parity_check's round trip and an npz written by JAX's tool."""
import argparse
import dataclasses
import importlib.util
import json
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from hamer_yolo_tpu_torch.tools import eval_fastpaths as E
from test_torch_bridge import REPO, mano_pair, numpy_params, tiny_configs, to_port

torch.set_num_threads(1)

# f32 arms (the f32 ViT, ToMe, the K2 arm off the card): the same f32 ops on
# both sides, a few ulps through two blocks, the head and MANO
F32_TOL = dict(rtol=1e-4, atol=1e-5)
# int8 arms: tests/test_torch_int8_vit.py's limits for the unfused int8 ViT in
# f32 (an LN output within an ulp of an int8 rounding midpoint moves one row by
# one step): 1e-3 on all but 1% of the elements, 0.05 on every one
INT8_CLOSE, INT8_SHARE, INT8_ALL = 1e-3, 0.99, 0.05
# JAX's tiny arms: ToMe at r 2 and 4 (12 tokens, 2 blocks: r 8 would merge
# more tokens than there are)
TINY_ARMS = tuple(a for a in E.ARMS if a != "tome_r8")


def _jax_tool(name):
    spec = importlib.util.spec_from_file_location(f"jax_{name}",
                                                  os.path.join(REPO, "tools", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def fastpaths():
    """Tiny f32 HaMeR weights and crops; every arm's outputs in the port,
    and JAX's arms composed from its own functions (quantize, calibrate on
    the held-out crops, ToMe, the int8 backbone; JAX's tool pins its static
    arm to the unfused composition, HYT_INT8_FUSED=0)."""
    from hamer_yolo_tpu.core import quant as jquant
    from hamer_yolo_tpu.models.hamer import hamer_forward as jforward
    from hamer_yolo_tpu.models.hamer import init_hamer as jinit

    jcfg, tcfg = (c.hamer for c in tiny_configs("float32"))
    jm, tm = mano_pair()
    params = numpy_params(lambda k: jinit(k, jcfg), 30)
    crops, calib = E.inputs("cpu", 4, 64, (64, 48))
    trees = E.arm_weights(to_port(params), tcfg, calib)
    port = {arm: E.run_arm(arm, trees, tm, tcfg, crops) for arm in (None,) + TINY_ARMS}

    jp = jax.tree_util.tree_map(jnp.asarray, params)
    q = jax.jit(jquant.quantize_vit_params)(jp["backbone"])
    stats = jax.jit(lambda p, x: jquant.collect_vit_act_stats(p, x, jcfg.vit))(
        q, jnp.asarray(calib.numpy()))
    s = jax.jit(jquant.attach_static_act_scales)(q, stats)
    jtrees = {"plain": jp, "dynamic": {**jp, "backbone": q}, "static": {**jp, "backbone": s}}

    runs = {}

    def jrun(weights, **changes):
        key = (weights, tuple(sorted(changes.items())))
        if key not in runs:  # the mega arms share the static arm's arithmetic
            c = dataclasses.replace(jcfg, **changes)
            out = jax.jit(lambda p, x: jforward(p, jm, x, c))(jtrees[weights],
                                                            jnp.asarray(crops.numpy()))
            runs[key] = {k: np.asarray(out[k], np.float64) for k in E.OUTPUTS}
        return runs[key]

    os.environ["HYT_INT8_FUSED"] = "0"
    try:
        ref = {None: jrun("plain")}
        for arm in TINY_ARMS:
            weights, ch = E.ARMS[arm][1], E.ARMS[arm][2]
            ref[arm] = jrun(weights, int8_backbone=bool(ch.get("int8")),
                            tome_r=ch.get("tome_r", 0))
    finally:
        del os.environ["HYT_INT8_FUSED"]
    return port, ref


@pytest.mark.parametrize("arm", [None, *TINY_ARMS])
def test_fastpath_arm_matches_jax(fastpaths, arm):
    """Each arm's HaMeR outputs against JAX's same arm (the mega arms and
    megaproj against JAX's static arm: the same static-scale arithmetic,
    K3 + K4 = K6 + proj + K10), and its deltas against JAX's deltas."""
    port, ref = fastpaths
    got, want = port[arm], ref[arm]
    if arm is not None and E.ARMS[arm][2].get("int8"):
        for k in E.OUTPUTS:
            assert np.isclose(got[k], want[k], rtol=INT8_CLOSE, atol=INT8_CLOSE).mean() \
                >= INT8_SHARE, k
            np.testing.assert_allclose(got[k], want[k], rtol=INT8_ALL, atol=INT8_ALL, err_msg=k)
    else:
        for k in E.OUTPUTS:
            np.testing.assert_allclose(got[k], want[k], err_msg=k, **F32_TOL)
    if arm is not None:
        d, dj = E.delta(port[None], got), E.delta(ref[None], want)
        assert set(d) == {"mpvpe_mm", "kp3d_mm", "cam_maxd"}
        tol = INT8_ALL * 1e3 if E.ARMS[arm][2].get("int8") else 0.05
        assert abs(d["mpvpe_mm"] - dj["mpvpe_mm"]) <= tol, (d, dj)


def test_fastpath_tool_main_on_the_cpu(monkeypatch, capsys):
    """The tool's main end to end at a tiny size (its full-size config
    swapped for the tiny one): the GELU line, one line an arm, the JSON."""
    tiny = tiny_configs("float32")[1].hamer
    monkeypatch.setattr(E, "HamerConfig", lambda: tiny)
    monkeypatch.setattr(E, "ARMS", {k: E.ARMS[k] for k in ("int8", "tome_r2", "bf16_mega")})
    real_inputs = E.inputs
    monkeypatch.setattr(E, "inputs", lambda dev: real_inputs(dev, 2, 64, (64, 48)))
    monkeypatch.setattr(E, "TIME_ITERS", 2)
    assert E.main(["--device", "cpu"]) == 0
    out = capsys.readouterr().out.splitlines()
    assert out[0] == "int8 MLP GELU: gelu (cpu)"
    res = json.loads(out[-1])
    assert set(res) == {"int8", "tome_r2", "bf16_mega"}
    assert set(json.loads(out[-2])["p50_ms"]) == set(res)


def _hand(rng, is_right):
    return {"theta": (0.3 * rng.normal(size=48)).astype(np.float32),
            "betas": rng.normal(size=10).astype(np.float32),
            "cam_t": np.array([0.01, -0.02, 0.5], np.float32) + 0.01 * rng.normal(size=3)
            .astype(np.float32), "is_right": np.float32(is_right)}


def test_eval_hamer_npz_matches_jax_tool(tmp_path, capsys):
    from hamer_yolo_tpu_torch.tools import eval_hamer

    rng = np.random.default_rng(40)
    gt = {"joints": rng.normal(size=(5, 21, 3)), "vertices": rng.normal(size=(5, 778, 3))}
    pred = {k: v + 0.01 * rng.normal(size=v.shape) for k, v in gt.items()}
    np.savez(tmp_path / "pred.npz", **pred)
    np.savez(tmp_path / "gt.npz", **gt)
    args = argparse.Namespace(pred=str(tmp_path / "pred.npz"), ref=str(tmp_path / "gt.npz"))
    assert _jax_tool("eval_hamer").cmd_npz(args) == 0
    ref = capsys.readouterr().out
    assert eval_hamer.main(["npz", "--pred", args.pred, "--ref", args.ref]) == 0
    got = capsys.readouterr().out
    assert got == ref and "mpvpe_mm" in got


def test_eval_hamer_npy_matches_jax_functions(tmp_path, capsys):
    """npy mode over two dirs of hand dicts: the largest parameter
    differences and the MPVPE of the meshes (MANO + cam_t) against the same
    composition of JAX's functions. JAX's own npy mode hands cam_t to its
    two-argument MANO function and raises a TypeError (held here)."""
    from hamer_yolo_tpu.pipeline.reconstruct import _mano_from_aa_fn
    from hamer_yolo_tpu.utils.metrics import mpvpe
    from hamer_yolo_tpu_torch.tools import eval_hamer

    rng = np.random.default_rng(41)
    for d in ("pred", "ref"):
        (tmp_path / d).mkdir()
    hands = []
    for i in range(3):
        ref = {"right": _hand(rng, 1.0), "left": _hand(rng, 0.0) if i != 1 else None}
        pred = {s: None if h is None else {k: v + np.float32(2e-3) * rng.normal(size=np.shape(v))
                                           .astype(np.float32) if k != "is_right" else v
                                           for k, v in h.items()} for s, h in ref.items()}
        np.save(tmp_path / "ref" / f"f{i}.npy", ref, allow_pickle=True)
        np.save(tmp_path / "pred" / f"f{i}.npy", pred, allow_pickle=True)
        hands += [(pred[s], ref[s]) for s in ("left", "right") if ref[s] is not None]
    jm, _ = mano_pair()
    fn = _mano_from_aa_fn(jm)

    def mesh(h):
        return np.asarray(fn(jnp.asarray(h["theta"]), jnp.asarray(h["betas"]))) + h["cam_t"]

    mm = float(np.concatenate([mpvpe(mesh(p)[None], mesh(r)[None]) for p, r in hands])
               .mean() * 1000.0)
    rc = eval_hamer.main(["npy", "--pred", str(tmp_path / "pred"), "--ref", str(tmp_path / "ref"),
                          "--mpvpe-mm", "100", "--device", "cpu"])
    out = capsys.readouterr().out
    assert rc == 0 and f"hands compared: {len(hands)}" in out
    assert f"MPVPE: {mm:.3f} mm  (PASS @ 100.0 mm)" in out
    theta = max(np.abs(p["theta"] - r["theta"]).max() for p, r in hands)
    assert f"max |dtheta|: {theta:.5f}" in out
    with pytest.raises(TypeError):
        _jax_tool("eval_hamer").cmd_npy(argparse.Namespace(
            pred=str(tmp_path / "pred"), ref=str(tmp_path / "ref"), mpvpe_mm=100.0))


def test_eval_detector_on_a_labelled_folder(tmp_path, capsys):
    """The tool on 3 labelled frames with a port checkpoint of seeded
    detector weights (64 px): its mAP line is utils/detect_eval.detector_map's
    on the same weights, and --save-json writes test.py's schema."""
    from hamer_yolo_tpu_torch.core.checkpoint import save_checkpoint
    from hamer_yolo_tpu_torch.io.datasets import image_label_pairs
    from hamer_yolo_tpu_torch.models.yolov7.model import YoloConfig, init_yolov7
    from hamer_yolo_tpu_torch.tools import eval_detector
    from hamer_yolo_tpu_torch.utils.detect_eval import detector_map
    from test_torch_datasets import write_labelled_folder
    from test_torch_state_dicts import port_tree_to_numpy

    folder = write_labelled_folder(tmp_path / "d", 3, [(96, 128), (120, 90)], 42)
    cfg = YoloConfig(nc=3, img_size=64)
    params = init_yolov7(torch.Generator().manual_seed(3), cfg)
    ckpt = str(tmp_path / "yolo.npz")
    save_checkpoint(ckpt, port_tree_to_numpy(params))
    js = str(tmp_path / "preds.json")
    assert eval_detector.main(["--data", folder, "--checkpoint", ckpt, "--img-size", "64",
                               "--save-json", js, "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    _, _, map50, mmap = detector_map(params, cfg, image_label_pairs(folder), img_size=64)
    assert f"images: 3  mAP@0.5: {map50:.4f}  mAP@0.5:0.95: {mmap:.4f}" in out
    with open(js) as f:
        preds = json.load(f)
    assert preds and all(set(p) == {"image_id", "category_id", "bbox", "score"} for p in preds)
    assert {p["image_id"] for p in preds} <= {"im000", "im001", "im002"}
    assert all(len(p["bbox"]) == 4 and p["bbox"][2] >= 0 for p in preds)


def test_parity_check_round_trip_and_a_jax_capture(tmp_path, capsys, monkeypatch):
    """capture / compare on the CPU; and an npz written by JAX's tool at --tiny (its forward
    jitted here, its seeded weights read from its closure), compared by the
    port's on those weights bridged, at the tool's 1e-3."""
    from hamer_yolo_tpu_torch.tools import parity_check

    path = str(tmp_path / "port.npz")
    assert parity_check.main(["capture", path, "--tiny", "--device", "cpu", "--batch", "2"]) == 0
    assert parity_check.main(["compare", path, "--tiny", "--device", "cpu"]) == 0
    assert sorted(np.load(path).files) == sorted(("__input__",) + parity_check.HAMER_OUTPUT_NAMES)
    jtool = _jax_tool("parity_check")
    build, seen = jtool.build_hamer, {}

    def jitted_build(seed=0, tiny=False):
        fn, cfg = build(seed, tiny)
        cells = dict(zip(fn.__code__.co_freevars, (c.cell_contents for c in fn.__closure__)))
        seen["params"] = cells["params"]
        return jax.jit(fn), cfg

    monkeypatch.setattr(jtool, "build_hamer", jitted_build)
    jpath = str(tmp_path / "jax.npz")
    assert jtool.cmd_capture(argparse.Namespace(path=jpath, seed=0, tiny=True, batch=2)) == 0
    fn, _ = parity_check.build_hamer(0, True, "cpu", params=to_port(seen["params"]))
    capsys.readouterr()
    assert parity_check.compare(jpath, fn) == 0
    assert "all outputs within tolerance" in capsys.readouterr().out
