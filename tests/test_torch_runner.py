"""The runner on an image dir: the port's npy dicts against the JAX
process_image_dir on the same images and weights, OBJ files written, and
the port's CLI end to end."""
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from hamer_yolo_tpu.io.writers import load_hand_npy
from hamer_yolo_tpu.pipeline.runner import process_image_dir as jax_process_image_dir
from hamer_yolo_tpu_torch.cli.main import main
from hamer_yolo_tpu_torch.pipeline.runner import process_image_dir
from test_torch_bridge import mano_pair, pipeline_params, tiny_configs, to_port

torch.set_num_threads(1)


@pytest.fixture
def image_dir(tmp_path):
    import cv2

    rng = np.random.default_rng(0)
    d = tmp_path / "imgs"
    d.mkdir()
    for i, (h, w) in enumerate([(100, 120), (90, 130), (130, 70)]):
        cv2.imwrite(str(d / f"f{i}.png"), rng.integers(0, 255, (h, w, 3)).astype(np.uint8))
    return str(d)


def test_process_image_dir_matches_jax(image_dir, tmp_path):
    # f32 detector and backbone: the JAX runner jits with XLA's default
    # excess precision, which only f32 programs are immune to.
    jcfg, tcfg = tiny_configs("float32")
    params = pipeline_params(jcfg, seed=4)
    jm, tm = mano_pair()
    out_j, out_t = str(tmp_path / "jax"), str(tmp_path / "torch")
    sj = jax_process_image_dir(image_dir, out_j, jax.tree_util.tree_map(jnp.asarray, params), jm,
                               jcfg, progress=False)
    st = process_image_dir(image_dir, out_t, to_port(params), tm, tcfg, device="cpu",
                           progress=False)
    assert (st.frames, st.hands, st.skipped) == (sj.frames, sj.hands, sj.skipped) == (3, st.hands, 0)
    assert st.hands > 0, "no hand found: the comparison would be empty"
    for name in sorted(os.listdir(out_j)):
        if not name.endswith(".npy"):
            continue
        a = load_hand_npy(os.path.join(out_j, name))
        b = load_hand_npy(os.path.join(out_t, name))
        assert set(a) == set(b) == {"left", "right"}
        for side in a:
            assert (a[side] is None) == (b[side] is None), f"{name}:{side}"
            if a[side] is None:
                continue
            assert a[side]["is_right"] == b[side]["is_right"]
            for k in ("betas", "theta", "pose_hand", "pose_global", "cam_t"):
                # f32 reassociation only (see test_torch_pipeline)
                np.testing.assert_allclose(b[side][k], a[side][k], rtol=1e-4, atol=1e-4,
                                           err_msg=f"{name}:{side}:{k}")
    objs_j = sorted(os.listdir(os.path.join(out_j, "obj")))
    objs_t = sorted(os.listdir(os.path.join(out_t, "obj")))
    assert objs_t == objs_j and objs_t
    for name in objs_t:
        vj = np.loadtxt([ln for ln in open(os.path.join(out_j, "obj", name)) if ln.startswith("v ")],
                        usecols=(1, 2, 3))
        vt = np.loadtxt([ln for ln in open(os.path.join(out_t, "obj", name)) if ln.startswith("v ")],
                        usecols=(1, 2, 3))
        np.testing.assert_allclose(vt, vj, rtol=1e-4, atol=2e-6)  # 6 decimals written


def test_cli_infer_tiny(image_dir, tmp_path):
    out = str(tmp_path / "out")
    assert main(["infer", "--tiny", "--device", "cpu", "--input", image_dir, "--output", out]) == 0
    npys = sorted(f for f in os.listdir(out) if f.endswith(".npy"))
    assert npys == ["f0.npy", "f1.npy", "f2.npy"]
    results = load_hand_npy(os.path.join(out, npys[0]))
    assert set(results) == {"left", "right"}


def _cli(args, capsys=None):
    assert main(args + ["--tiny", "--device", "cpu"]) == 0
    return capsys.readouterr().out if capsys is not None else None


def _npys(d):
    return sorted(f for f in os.listdir(d) if f.endswith(".npy"))


def test_cli_infer_batch_depth_refine_and_int8_tome(image_dir, tmp_path):
    """infer --batch 2 writes a file per image with the hands --batch 1
    finds (test_torch_serving holds the values); --depth-refine moves every
    hand's cam_t (to RootNet's depth); --fast-path tome and int8-tome run."""
    outs = {}
    for name, extra in (("one", []), ("batch", ["--batch", "2"]),
                        ("refine", ["--depth-refine"]),
                        ("int8_tome", ["--fast-path", "int8-tome", "--tome-r", "2"]),
                        ("tome", ["--fast-path", "tome"])):
        out = str(tmp_path / name)
        _cli(["infer", "--input", image_dir, "--output", out] + extra)
        assert _npys(out) == ["f0.npy", "f1.npy", "f2.npy"], name
        outs[name] = out
    for f in _npys(outs["one"]):
        a, b = load_hand_npy(os.path.join(outs["one"], f)), load_hand_npy(
            os.path.join(outs["batch"], f))
        assert {s: v is None for s, v in a.items()} == {s: v is None for s, v in b.items()}
    refined = [load_hand_npy(os.path.join(outs["refine"], f)) for f in _npys(outs["refine"])]
    plain = [load_hand_npy(os.path.join(outs["one"], f)) for f in _npys(outs["one"])]
    moved = [not np.allclose(r[s]["cam_t"], p[s]["cam_t"]) for r, p in zip(refined, plain)
             for s in r if r[s] is not None]
    assert moved and all(moved)


def test_cli_infer_mask_dir_and_profile(image_dir, tmp_path):
    masks = tmp_path / "masks"
    masks.mkdir()
    m = np.zeros((100, 120), np.uint8)
    m[10:60, 20:90] = 5
    np.save(str(masks / "f0.npy"), m)
    out, prof = str(tmp_path / "out"), str(tmp_path / "prof")
    _cli(["infer", "--input", image_dir, "--output", out, "--mask-dir", str(masks),
          "--mask-value", "5", "--mask-hand", "left", "--profile", prof])
    assert _npys(out) == ["f0.npy"]
    res = load_hand_npy(os.path.join(out, "f0.npy"))
    assert res["right"] is None and res["left"] is not None and not res["left"]["is_right"]
    assert os.path.getsize(os.path.join(prof, "trace.json")) > 0


def test_cli_detect_depth_reconstruct(image_dir, tmp_path, capsys):
    import json

    txt = str(tmp_path / "txt")
    lines = _cli(["detect", "--input", image_dir, "--save-txt", txt, "--save-conf"],
                 capsys).strip().splitlines()
    recs = [json.loads(ln) for ln in lines]
    assert [r["image"] for r in recs] == ["f0.png", "f1.png", "f2.png"]
    for r in recs:
        rows = open(os.path.join(txt, r["image"].replace(".png", ".txt"))).read().split("\n")
        rows = [ln for ln in rows if ln]
        assert len(rows) == len(r["detections"])
        for row, d in zip(rows, r["detections"]):
            vals = [float(v) for v in row.split()]
            assert len(vals) == 6 and int(vals[0]) == d["class"] and vals[5] == pytest.approx(
                d["score"], rel=1e-5)
            assert all(0.0 <= v <= 1.0 for v in vals[1:5])
    depths = [json.loads(ln) for ln in _cli(["depth", "--input", image_dir],
                                            capsys).strip().splitlines()]
    assert [d["image"] for d in depths] == ["f0.png", "f1.png", "f2.png"]
    assert [len(d["root_depths"]) for d in depths] == [len(r["detections"]) for r in recs]
    assert all(np.isfinite(d["root_depths"]).all() for d in depths)
    out, objs = str(tmp_path / "out"), str(tmp_path / "objs")
    _cli(["infer", "--input", image_dir, "--output", out, "--no-obj"])
    said = _cli(["reconstruct", "--input", out, "--output", objs], capsys)
    n = len(os.listdir(objs))
    assert f"wrote {n} OBJ files" in said and n == sum(
        any(v is not None for v in load_hand_npy(os.path.join(out, f)).values())
        for f in _npys(out))


def test_yolo_label_lines_format():
    """detect --save-txt rows: cls x_c y_c w h [conf], normalised, '%g'."""
    from hamer_yolo_tpu_torch.cli.main import yolo_label_lines

    dets = [{"class": 1, "box": [10.0, 20.0, 30.0, 60.0], "score": 0.5}]
    assert yolo_label_lines(dets, 100, 200) == ["1 0.1 0.4 0.1 0.4"]
    assert yolo_label_lines(dets, 100, 200, save_conf=True) == ["1 0.1 0.4 0.1 0.4 0.5"]
