"""The port's tools/train_yolo (hamer_yolo_tpu_torch/tools/train_yolo.py) at a
tiny size on the CPU: a labelled folder of numpy-made PNGs, a three-level
detector of five convs read from a reference-style yaml (with IAuxDetect
for --aux), 64 px batches of 2.

What it holds (no tolerance: the tool's own behaviour, the numbers behind
it are held against JAX in tests/test_torch_simota.py, test_torch_datasets.py
and test_torch_detect_eval.py): steps run and log finite losses,
checkpoints land and ``--resume auto`` goes on from the latest, with the
restored state bit-equal to the saved one; ``--evolve 2`` writes
evolve.txt and a hyp_evolved.yaml that PyYAML reads; ``--hyp``'s loss_ota
picks SimOTA and its gains reach the step; what is not ported raises.
"""
import json
import os
import sys

import numpy as np
import pytest
import torch
import yaml

from hamer_yolo_tpu_torch.tools import train_yolo as tool
from hamer_yolo_tpu_torch.training import train_yolo as ttrain
from test_torch_datasets import write_labelled_folder
from test_torch_train_hamer import flat

torch.set_num_threads(1)

ANCHORS = [[12, 16, 19, 36, 40, 28], [36, 75, 76, 55, 72, 146], [142, 110, 192, 243, 459, 401]]
BACKBONE = [[-1, 1, "Conv", [8, 3, 2]], [-1, 1, "Conv", [16, 3, 2]], [-1, 1, "Conv", [16, 3, 2]],
            [-1, 1, "Conv", [24, 3, 2]], [-1, 1, "Conv", [32, 3, 2]]]
TINY = {"nc": 3, "depth_multiple": 1.0, "width_multiple": 1.0, "anchors": ANCHORS,
        "backbone": BACKBONE, "head": [[[2, 3, 4], 1, "IDetect", ["nc", "anchors"]]]}
TINY_AUX = {**TINY, "head": [[2, 1, "Conv", [16, 1, 1]], [3, 1, "Conv", [24, 1, 1]],
                             [4, 1, "Conv", [32, 1, 1]],
                             [[2, 3, 4, 5, 6, 7], 1, "IAuxDetect", ["nc", "anchors"]]]}


@pytest.fixture(scope="module")
def run_dir(tmp_path_factory):
    root = tmp_path_factory.mktemp("tool")
    images = write_labelled_folder(root / "data", 4, [(96, 128), (120, 90)], 70)
    for name, d in (("tiny.yaml", TINY), ("tiny_aux.yaml", TINY_AUX)):
        (root / name).write_text(yaml.safe_dump(d))
    return root, images


def _args(root, images, out, *extra):
    return ["--data", images, "--batch", "2", "--img-size", "64", "--cfg",
            str(root / "tiny.yaml"), "--out", str(root / out), "--log-every", "1",
            "--device", "cpu", *extra]


@pytest.mark.parametrize("form", ["neighbor", "aux"])
def test_tool_trains_checkpoints_and_resumes(run_dir, form, capsys):
    """3 steps with a checkpoint every 2 (the aux form: --aux over the
    IAuxDetect yaml), then --resume auto for 2 more from ckpt_final: the
    steps logged with finite losses, ckpt_2, ckpt_4 and ckpt_final written,
    the resumed run starting at step 3, its state equal to the checkpoint it
    restored before stepping (test_train_loop_restores_the_saved_state)."""
    root, images = run_dir
    out = f"run_{form}"
    extra = ["--cfg", str(root / "tiny_aux.yaml"), "--aux"] if form == "aux" else []
    assert tool.main(_args(root, images, out, "--steps", "3", "--ckpt-every", "2", *extra)) == 0
    first = capsys.readouterr().out
    assert "step 2:" in first and "loader" in first
    assert sorted(os.listdir(root / out)) == ["ckpt_2.npz", "ckpt_final.npz", "metrics.jsonl"]
    logged = [json.loads(line) for line in (root / out / "metrics.jsonl").read_text().split("\n")
              if line]
    assert [r["step"] for r in logged] == [0, 1, 2]
    assert all(np.isfinite(r[k]) for r in logged for k in ("loss", "box", "obj", "cls"))
    assert tool.main(_args(root, images, out, "--steps", "5", "--ckpt-every", "2", "--resume",
                           "auto", *extra)) == 0
    second = capsys.readouterr().out
    assert "at step 3" in second and "step 4:" in second and "step 2:" not in second
    assert sorted(os.listdir(root / out)) == ["ckpt_2.npz", "ckpt_4.npz", "ckpt_final.npz",
                                              "metrics.jsonl"]


def test_train_loop_restores_the_saved_state(run_dir):
    """train_loop's --resume: the state it builds from a checkpoint equals
    the saved state leaf for leaf (params, momentum, EMA, steps)."""
    root, images = run_dir
    args = tool.build_parser().parse_args(_args(root, images, "loop", "--steps", "2",
                                                "--ckpt-every", "1"))
    from hamer_yolo_tpu_torch.models.yolov7.yaml_spec import load_yaml_model_cfg

    spec, cfg = load_yaml_model_cfg(str(root / "tiny.yaml"), nc=3)
    state, metrics, times = tool.train_loop(args, spec, cfg, {}, {}, {}, "simota", 10,
                                            str(root / "loop"), torch.device("cpu"))
    assert state.step == 2 and len(times["load_ms"]) == len(times["step_ms"]) == 2
    assert np.isfinite(metrics["loss"])
    args.steps = 2
    again, _, times = tool.train_loop(args, spec, cfg, {}, {}, {}, "simota", 10,
                                      str(root / "loop"), torch.device("cpu"), resume="auto")
    assert times["start"] == 2 and not times["load_ms"]
    a, b = flat(ttrain.state_tree(state)), flat(ttrain.state_tree(again))
    assert a.keys() == b.keys()
    for k in a:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def test_tool_evolves_two_generations(run_dir, capsys):
    """--evolve 2 --steps 1 with SimOTA: evolve.txt holds two rows of 7
    results + every hyp, hyp_evolved.yaml reads back (PyYAML) as the best
    row's hyp, no checkpoint is written."""
    root, images = run_dir
    assert tool.main(_args(root, images, "evo", "--steps", "1", "--evolve", "2",
                           "--assigner", "simota")) == 0
    out = capsys.readouterr().out
    assert "evolve gen 0" in out and "evolve gen 1" in out
    rows = np.loadtxt(root / "evo" / "evolve.txt", ndmin=2)
    from hamer_yolo_tpu_torch.training.evolve import META, N_RESULT_COLS, fitness

    assert rows.shape == (2, N_RESULT_COLS + len(META))
    best = yaml.safe_load((root / "evo" / "hyp_evolved.yaml").read_text())
    assert list(best) == list(META)
    top = rows[np.argmax(fitness(rows))]
    np.testing.assert_allclose([best[k] for k in META], top[N_RESULT_COLS:], rtol=1e-3)
    assert not [f for _, _, fs in os.walk(root / "evo") for f in fs if f.endswith(".npz")]


def test_hyp_loss_ota_picks_simota(run_dir, monkeypatch):
    """--hyp with loss_ota: 1 and P5's gains: the step gets the SimOTA
    assigner and the hyp's box / obj / cls gains; without loss_ota the
    neighbor assigner; --assigner overrides."""
    root, images = run_dir
    seen = []
    real = ttrain.make_yolo_train_step

    def spy(cfg, spec=None, assigner="neighbor", ota_topk=10, loss_kwargs=None, mesh=None):
        seen.append((assigner, ota_topk, dict(loss_kwargs or {})))
        return real(cfg, spec, assigner, ota_topk, loss_kwargs, mesh=mesh)

    monkeypatch.setattr(ttrain, "make_yolo_train_step", spy)
    hyp = {"lr0": 0.01, "box": 0.05, "cls": 0.3, "obj": 0.7, "anchor_t": 4.0, "mosaic": 1.0,
           "mixup": 0.15, "loss_ota": 1}
    (root / "hyp.yaml").write_text(yaml.safe_dump(hyp))
    (root / "hyp_no_ota.yaml").write_text(yaml.safe_dump({**hyp, "loss_ota": 0}))
    for name, extra in (("hyp.yaml", []), ("hyp_no_ota.yaml", []),
                        ("hyp_no_ota.yaml", ["--assigner", "simota"])):
        assert tool.main(_args(root, images, f"hyp_{len(seen)}", "--steps", "1", "--hyp",
                               str(root / name), *extra)) == 0
    assert [s[0] for s in seen] == ["simota", "neighbor", "simota"]
    assert seen[0][1] == 10
    assert seen[0][2] == {"box_w": 0.05, "cls_w": 0.3, "obj_w": 0.7, "anchor_t": 4.0}


@pytest.mark.parametrize("flag", ["devices", "plots", "aux_without_cfg"])
def test_what_the_tool_does_not_do_raises(run_dir, flag, monkeypatch):
    """--devices 2 in a process group of one exits (torchrun starts one a device);
    --plots where cv2 is missing (the machine with the card) raises an
    ImportError before training; --aux without --cfg returns 2, as JAX's."""
    root, images = run_dir
    base = ["--data", images, "--device", "cpu", "--steps", "1"]
    if flag == "aux_without_cfg":
        assert tool.main(base + ["--aux"]) == 2
        return
    if flag == "plots":
        monkeypatch.setitem(sys.modules, "cv2", None)
        with pytest.raises(ImportError, match="--plots"):
            tool.main(base + ["--plots", "--out", str(root / "no_plots")])
        assert not os.path.exists(root / "no_plots" / "metrics.jsonl")
        return
    with pytest.raises(SystemExit):
        tool.main(base + ["--devices", "2"])
