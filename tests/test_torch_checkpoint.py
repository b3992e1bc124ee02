"""The port's checkpoint file (core/checkpoint.py) and ``--checkpoint``: the
.npz round trip, a leaf without a bridge rule, an orbax checkpoint of the
JAX package turned into a port checkpoint, and the CLI's ``infer --tiny``
from it against the JAX CLI's from the orbax directory."""
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax

from hamer_yolo_tpu.core import checkpoint as jck
from hamer_yolo_tpu.io.writers import load_hand_npy
from hamer_yolo_tpu_torch.cli.main import main
from hamer_yolo_tpu_torch.core import checkpoint as tck
from hamer_yolo_tpu_torch.core.bridge import from_jax_params
from test_torch_bridge import REPO, mano_pair, numpy_params
from test_torch_state_dicts import assert_leaf_equal, leaves

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def tiny_tree():
    """numpy weights of the JAX CLI's --tiny pipeline (its config, with SAR),
    in JAX layout."""
    from hamer_yolo_tpu.cli.main import _load_runtime

    class Args:
        tiny, mano_dir, max_hands, checkpoint = True, None, 2, None

    _, _, jcfg = _load_runtime(Args())
    jm, _ = mano_pair()
    return jax.tree_util.tree_map(np.asarray, numpy_params(lambda k: jck.init_pipeline_params(
        k, jm, yolo_cfg=jcfg.yolo, hamer_cfg=jcfg.hamer, sar_cfg=jcfg.sar), seed=8))


def test_npz_round_trip(tiny_tree, tmp_path):
    """Leaf for leaf, with the detector's None layers, list positions and an
    empty list; int8 leaves keep their dtype."""
    tree = {**tiny_tree, "extra": {"empty": [], "q": {"wq": {"q": np.arange(6, dtype=np.int8)
                                                              .reshape(2, 3)}}}}
    path = str(tmp_path / "x.npz")
    tck.save_checkpoint(path, tree)
    back = tck.read_checkpoint(path)
    assert_leaf_equal(back, tree)
    assert back["yolo"]["layers"][10] is None and back["extra"]["empty"] == []


def test_load_puts_the_bridge_tensors_on_the_device(tiny_tree, tmp_path):
    path = str(tmp_path / "x.npz")
    tck.save_checkpoint(path, tiny_tree)
    got, ref = tck.load_checkpoint(path, "cpu"), from_jax_params(tiny_tree, "cpu")
    assert jax.tree_util.tree_structure(got) == jax.tree_util.tree_structure(ref)
    for g, r in zip(jax.tree_util.tree_leaves(got), jax.tree_util.tree_leaves(ref)):
        assert g.device.type == "cpu" and g.dtype == r.dtype and torch.equal(g, r)


def _at(tree, path):
    for p in path:
        tree = tree[p]
    return tree


@pytest.mark.parametrize("leaf", [
    {"w": np.zeros((2, 2, 2), np.float32)},
    {"conv": {"w": {"q": np.zeros((1, 1, 4, 4), np.int8), "scale": np.ones(4, np.float32)}}},
    {"mystery": np.ones(3, np.float32)},
], ids=["rank3_weight", "int8_conv", "unknown_key"])
def test_unmapped_leaf_raises(tmp_path, leaf):
    path = str(tmp_path / "bad.npz")
    tck.save_checkpoint(path, {"yolo": {"layers": [leaf]}})
    with pytest.raises(KeyError, match="bridge: no mapping"):
        tck.load_checkpoint(path, "cpu")


@pytest.fixture(scope="module")
def orbax_dir(tiny_tree, tmp_path_factory):
    d = str(tmp_path_factory.mktemp("orbax") / "ckpt")
    jck.save_checkpoint(d, jax.tree_util.tree_map(jax.numpy.asarray, tiny_tree))
    return d


def test_orbax_checkpoint_to_port_checkpoint(tiny_tree, orbax_dir, tmp_path):
    """JAX's load_checkpoint, then the port's save_checkpoint straight from
    its jax arrays: the tensors from_jax_params makes of the original tree."""
    restored = jck.load_checkpoint(orbax_dir)
    assert any(isinstance(x, jax.Array) for x in jax.tree_util.tree_leaves(restored))
    path = str(tmp_path / "from_orbax.npz")
    tck.save_checkpoint(path, restored)
    got = tck.read_checkpoint(path)
    ref = jax.tree_util.tree_map(np.asarray, restored)
    assert_leaf_equal(got, ref)
    orig = {k: v for k, v in leaves(tiny_tree).items() if isinstance(v, np.ndarray)}
    for k, v in orig.items():
        np.testing.assert_array_equal(_at(got, k), v, err_msg=str(k))
    port = tck.load_checkpoint(path, "cpu")
    direct = from_jax_params(tiny_tree, "cpu")
    assert torch.equal(port["hamer"]["backbone"]["blocks"][1]["mlp"]["fc2"]["w"],
                       direct["hamer"]["backbone"]["blocks"][1]["mlp"]["fc2"]["w"])
    assert torch.equal(port["yolo"]["layers"][0]["conv"]["w"],
                       direct["yolo"]["layers"][0]["conv"]["w"])


@pytest.fixture
def image_dir(tmp_path):
    import cv2

    rng = np.random.default_rng(0)
    d = tmp_path / "imgs"
    d.mkdir()
    for i, (h, w) in enumerate([(100, 120), (90, 130), (130, 70)]):
        cv2.imwrite(str(d / f"f{i}.png"), rng.integers(0, 255, (h, w, 3)).astype(np.uint8))
    return str(d)


def test_cli_infer_from_checkpoint_matches_jax_cli(tiny_tree, orbax_dir, image_dir, tmp_path):
    """``infer --tiny --checkpoint`` of the port (the .npz made from JAX's
    orbax directory) against the JAX CLI's ``infer --tiny --checkpoint`` (the
    orbax directory), run in a process of its own with XLA's excess
    precision off (ROADMAP F6: the --tiny CLI is bf16). Slots matched by
    box; the fields within tests/test_torch_pipeline.py's bf16 limit, rtol =
    atol = 8e-3, the limit of the port's bf16 infer against JAX's."""
    npz = str(tmp_path / "ckpt.npz")
    tck.save_checkpoint(npz, jck.load_checkpoint(orbax_dir))
    out_t, out_j = str(tmp_path / "torch"), str(tmp_path / "jax")
    assert main(["infer", "--tiny", "--device", "cpu", "--max-hands", "2", "--checkpoint", npz,
                 "--input", image_dir, "--output", out_t, "--no-obj"]) == 0
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=REPO,
               XLA_FLAGS=(os.environ.get("XLA_FLAGS", "") + " --xla_allow_excess_precision=false"))
    res = subprocess.run([sys.executable, "-m", "hamer_yolo_tpu.cli.main", "infer", "--tiny",
                          "--max-hands", "2", "--checkpoint", orbax_dir, "--input", image_dir,
                          "--output", out_j], env=env, cwd=REPO, capture_output=True, text=True,
                         timeout=600)
    assert res.returncode == 0, res.stderr[-2000:]
    names = sorted(f for f in os.listdir(out_j) if f.endswith(".npy"))
    assert names == sorted(f for f in os.listdir(out_t) if f.endswith(".npy")) and names
    hands = 0
    for name in names:
        a, b = load_hand_npy(os.path.join(out_j, name)), load_hand_npy(os.path.join(out_t, name))
        for side in ("left", "right"):
            assert (a[side] is None) == (b[side] is None), f"{name}:{side}"
            if a[side] is None:
                continue
            hands += 1
            for k in ("betas", "theta", "pose_hand", "pose_global", "cam_t"):
                np.testing.assert_allclose(b[side][k], a[side][k], rtol=8e-3, atol=8e-3,
                                           err_msg=f"{name}:{side}:{k}")
    assert hands, "no hand found: the comparison would be empty"


def test_missing_checkpoint_warns_and_falls_back(image_dir, tmp_path, capsys):
    """As in JAX: a path that does not exist is a warning, then the seeded
    init, the same outputs as no --checkpoint at all."""
    a, b = str(tmp_path / "a"), str(tmp_path / "b")
    args = ["infer", "--tiny", "--device", "cpu", "--input", image_dir, "--no-obj"]
    assert main(args + ["--output", a, "--checkpoint", str(tmp_path / "absent.npz")]) == 0
    assert "not found; random init" in capsys.readouterr().err
    assert main(args + ["--output", b]) == 0
    for name in sorted(os.listdir(a)):
        x, y = load_hand_npy(os.path.join(a, name)), load_hand_npy(os.path.join(b, name))
        for side in x:
            assert (x[side] is None) == (y[side] is None)
            if x[side] is not None:
                np.testing.assert_array_equal(x[side]["betas"], y[side]["betas"])


def test_cli_checkpoint_with_unmapped_leaf_raises(image_dir, tmp_path):
    bad = str(tmp_path / "bad.npz")
    tck.save_checkpoint(bad, {"yolo": {"layers": [{"mystery": np.ones(3, np.float32)}]}})
    with pytest.raises(KeyError, match="bridge: no mapping"):
        main(["detect", "--tiny", "--device", "cpu", "--checkpoint", bad, "--input", image_dir])
