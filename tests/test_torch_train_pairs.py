"""One f32 train step of each model on the card against the CPU, from the
same weights and batch (TF32 off): the cases and the limits that
chip_smoke.py's phase "training" and tests/test_torch_cuda.py share.

HaMeR at full width with 2 blocks, YOLOv7 at 64 px (tests/test_training.py's
SMALL_CFG) at B = 8 with the neighbor assigner, at 128 px and B = 16 with
SimOTA (at 64 px and B = 8 SimOTA's gradient, which reaches fewer cells,
is 1.4e-2 from the f64 one on the CPU alone, a case that READ keeps; at 128
px and B = 16 8.3e-4), the
IAuxDetect literal yaml (tests/test_torch_yolo_family.P6_YAML, training
form) at 128 px, B = 8, under ComputeLossAuxOTA's form, IBin's SimOTA loss
on raw maps of its layout (JAX's training forward has no IBin form), and
KPFusion at --tiny with its BN variances calibrated on the batch. The metrics at LOSS_REL; each gradient leaf by its
relative norm error at GRAD_REL (the limits of the CPU tests against JAX,
tests/test_torch_train_*.py). The gradients are taken before any optimizer
step: torch's foreach SGD (the card's) adds the Nesterov term into .grad in
place, where the CPU's does not.

``python tests/test_torch_train_pairs.py [MODEL ...]`` (on a machine with a
card) prints the worst leaf of each case in READ (of those models) without
holding it to its limit, and for the YOLO cases the f32 gradient's distance
from the CPU's f64 one on either device.
"""
import dataclasses
import json
import os
import sys

import numpy as np
import torch

LOSS_REL = {"hamer": 1e-4, "yolo": 1e-4, "yolo_simota": 1e-4, "yolo_aux": 1e-4, "yolo_bin": 1e-4,
            "kpfusion": 1e-3}
GRAD_REL = {"hamer": 1e-3, "yolo": 3e-3, "yolo_simota": 3e-3, "yolo_aux": 3e-3, "yolo_bin": 1e-3,
            "kpfusion": 1e-2}
# biases that a softmax cancels: gradient 0 in exact arithmetic, rounding noise
SOFTMAX_CANCELLED = {"kpfusion": ("finals/2/b", "/k/b")}
# (model, batch size, image size; None where the model takes no image size)
# held at the limits
CASES = (("hamer", 2, None), ("yolo", 8, 64), ("yolo_simota", 16, 128), ("yolo_aux", 8, 128),
         ("yolo_bin", 2, 64), ("kpfusion", 2, None))
# read by main() and not held: YOLO at B = 2, where the 2 x 2 P5 map's batch
# statistics (8 values a channel) leave the CPU's own f32 gradient 2e-2 from
# its f64 one at the worst leaf (PERF.md, PR 14), and SimOTA at 64 px, B = 8
READ = CASES + (("yolo", 2, 64), ("yolo_simota", 8, 64))


def to_device(tree, dev):
    if isinstance(tree, dict):
        return {k: to_device(v, dev) for k, v in tree.items()}
    if isinstance(tree, list):
        return [to_device(v, dev) for v in tree]
    return None if tree is None else tree.to(dev)


def train_pair(model, dev, batch_size=2, img_size=None):
    """{"card", "cpu": the two train states from the same weights,
    "loss": loss(state, on_card), "step": step(state, on_card) -> metrics,
    "batch": the CPU batch, "cfg"}."""
    from hamer_yolo_tpu_torch.cli.main import load_mano
    from hamer_yolo_tpu_torch.models.hamer import HamerConfig
    from hamer_yolo_tpu_torch.models.vit import ViTConfig
    from hamer_yolo_tpu_torch.models.yolov7.model import YoloConfig
    from hamer_yolo_tpu_torch.tools.train_kpfusion_rgbd import tiny_config
    from hamer_yolo_tpu_torch.training import train_hamer as TH
    from hamer_yolo_tpu_torch.training import train_kpfusion_rgbd as TK
    from hamer_yolo_tpu_torch.training import train_yolo as TY

    def moved(batch, on_card):
        return {k: v.to(dev) for k, v in batch.items()} if on_card else batch

    if model == "hamer":
        cfg = HamerConfig(vit=ViTConfig(depth=2, compute_dtype="float32"))
        cpu = TH.init_train_state(torch.Generator().manual_seed(2), cfg)
        card = TH.make_train_state(to_device(cpu.params, dev), to_device(cpu.disc_params, dev))
        batch = TH.synthetic_batch(torch.Generator().manual_seed(3), batch_size, cfg)
        manos = {True: load_mano(None, dev), False: load_mano(None, "cpu")}
        return dict(card=card, cpu=cpu, batch=batch, cfg=cfg,
                    loss=lambda s, c: TH.hamer_loss_fn(s.params, s.disc_params, manos[c],
                                                       moved(batch, c), TH.train_config(cfg))[0],
                    step=lambda s, c: TH.train_step(s, moved(batch, c), manos[c], cfg))
    if model == "yolo_bin":
        return bin_loss_pair(dev, batch_size, img_size)
    if model.startswith("yolo"):
        spec, img, kw = None, img_size, {"assigner": "simota"} if model == "yolo_simota" else {}
        cfg = YoloConfig(nc=3, img_size=img, compute_dtype="float32")
        if model == "yolo_aux":
            from hamer_yolo_tpu_torch.models.yolov7.yaml_spec import spec_from_yaml
            from test_torch_yolo_family import P6_YAML

            spec, cfg = spec_from_yaml(P6_YAML, nc=3, training_form=True)
            kw = {"assigner": "simota", "ota_topk": 20}
            cfg = dataclasses.replace(cfg, img_size=img, compute_dtype="float32")
        cpu = TY.init_yolo_train_state(torch.Generator().manual_seed(4), cfg, 100, spec=spec)
        card = TY.make_yolo_train_state(to_device(cpu.params, dev), 100)
        batch = TY.synthetic_yolo_batch(torch.Generator().manual_seed(5), batch_size, img)
        step = TY.make_yolo_train_step(cfg, spec, **kw)
        return dict(card=card, cpu=cpu, batch=batch, cfg=cfg, spec=spec, loss_kw=kw,
                    loss=lambda s, c: TY.yolo_loss_fn(s.params, moved(batch, c), cfg, spec,
                                                      **kw)[0]["loss"],
                    step=lambda s, c: step(s, moved(batch, c)))
    from test_torch_state_dicts import calibrating_batch_norm

    cfg = tiny_config()
    cpu = TK.init_train_state(torch.Generator().manual_seed(6), cfg)
    batch = {k: torch.from_numpy(v) for k, v in
             TK.synthetic_rgbd_batch(np.random.default_rng(7), batch_size, cfg).items()}
    with torch.no_grad(), calibrating_batch_norm():
        TK.kpfusion_rgbd_loss(cpu.params, batch, cfg)
    card = TK.make_train_state(to_device(cpu.params, dev))
    return dict(card=card, cpu=cpu, batch=batch, cfg=cfg,
                loss=lambda s, c: TK.kpfusion_rgbd_loss(s.params, moved(batch, c), cfg)[0],
                step=lambda s, c: TK.train_step(s, moved(batch, c), cfg))


def bin_loss_pair(dev, batch_size, img_size):
    """IBin's SimOTA loss (ComputeLossBinOTA) over seeded raw maps of its
    layout (nc 3, 21 bins) at ``img_size``: the "state" holds the maps as
    the leaves, and a "step" gives the loss's terms."""
    import types

    from hamer_yolo_tpu_torch.models.yolov7.model import YOLOV7_ANCHORS
    from hamer_yolo_tpu_torch.training.losses import yolo_loss
    from hamer_yolo_tpu_torch.training.train_yolo import synthetic_yolo_batch

    gen = torch.Generator().manual_seed(8)
    no = 3 + 3 + 2 * 22
    maps = [torch.randn((batch_size, img_size // s, img_size // s, 3 * no), generator=gen)
            for s in (8, 16, 32)]
    batch = synthetic_yolo_batch(torch.Generator().manual_seed(9), batch_size, img_size)
    anchors = torch.from_numpy(YOLOV7_ANCHORS)

    def state(d):
        return types.SimpleNamespace(params={"maps": [m.to(d).requires_grad_(True)
                                                      for m in maps]})

    def loss(s, on_card):
        d = dev if on_card else torch.device("cpu")
        return yolo_loss(s.params["maps"], batch["targets"].to(d), anchors.to(d), (8, 16, 32), 3,
                         assigner="simota", head="bin")

    return dict(card=state(dev), cpu=state("cpu"), batch=batch, cfg=None,
                loss=lambda s, c: loss(s, c)["loss"],
                step=lambda s, c: {k: v.detach() for k, v in loss(s, c).items()})


def gradients(loss, state):
    """{path: d loss / d leaf} (f64, on the host) of the leaves that require grad."""
    from hamer_yolo_tpu_torch.training.optim import named_leaves

    leaves = [(f"{i}/{k}", t) for i, tree in enumerate((state.params,
                                                        getattr(state, "disc_params", None)))
              for k, t in named_leaves(tree) if t.requires_grad]
    g = torch.autograd.grad(loss, [t for _, t in leaves], allow_unused=True,
                            materialize_grads=True)
    return {k: v.detach().double().cpu() for (k, _), v in zip(leaves, g)}


def yolo_f64_gradients(pair):
    """The YOLO pair's loss gradient with every op in f64, on the CPU, from
    the pair's starting weights, keyed as gradients()."""
    import dataclasses

    from hamer_yolo_tpu_torch.models.yolov7.model import yolov7_train_forward
    from hamer_yolo_tpu_torch.training.losses import yolo_loss
    from hamer_yolo_tpu_torch.training.optim import is_bn_stat, map_tree, named_leaves, trainable

    from hamer_yolo_tpu_torch.models.yolov7.model import split_aux_maps, yolov7_spec

    cfg = dataclasses.replace(pair["cfg"], compute_dtype="float64")
    params = trainable(map_tree(lambda t: t.detach().double(), pair["cpu"].params), is_bn_stat)
    batch = {k: v.double() for k, v in pair["batch"].items()}
    maps, _ = yolov7_train_forward(params, batch["img"], cfg, pair["spec"])
    lead, aux = split_aux_maps(maps, pair["spec"] or yolov7_spec())
    anchors = torch.tensor(cfg.anchors, dtype=torch.float64).reshape(cfg.nl, cfg.na, 2)
    loss = yolo_loss(lead, batch["targets"], anchors, cfg.strides, cfg.nc, aux_maps=aux or None,
                     **pair["loss_kw"])["loss"]
    leaves = [(f"0/{k}", t) for k, t in named_leaves(params) if t.requires_grad]
    g = torch.autograd.grad(loss, [t for _, t in leaves], allow_unused=True,
                            materialize_grads=True)
    return {k: v.detach() for (k, _), v in zip(leaves, g)}


def rel(a, b):
    return float((a - b).norm() / max(float(b.norm()), 1e-30))


def card_against_cpu(model, dev, batch_size=2, img_size=None, hold=True):
    """One step of ``model``'s pair on both devices (``img_size`` as in
    CASES). Returns {"worst": (the
    largest relative gradient error, its leaf), "loss": (card, CPU), "card":
    the card's state after its step}, and for YOLO "f64": {"at_worst": the
    card's and the CPU's f32 gradient from the f64 one at that leaf, "card"
    and "cpu": each device's largest such error and its leaf}. ``hold``:
    raise where a metric or a gradient is past its limit."""
    pair = train_pair(model, dev, batch_size, img_size)
    card, cpu = pair["card"], pair["cpu"]
    g_card, g_cpu = gradients(pair["loss"](card, True), card), gradients(pair["loss"](cpu, False),
                                                                         cpu)
    g64 = yolo_f64_gradients(pair) if "spec" in pair else None
    got, ref = pair["step"](card, True), pair["step"](cpu, False)
    for k in ref:
        a, b = float(got[k]), float(ref[k])
        if hold and abs(a - b) > LOSS_REL[model] * max(abs(b), 1e-6):
            raise RuntimeError(f"{model} B={batch_size} card against CPU: {k} {a} against {b}")
    skip = SOFTMAX_CANCELLED.get(model, ())
    worst = max((rel(g_card[k], c), k) for k, c in g_cpu.items() if not k.endswith(skip))
    if hold and worst[0] > GRAD_REL[model]:
        raise RuntimeError(f"{model} B={batch_size} card against CPU: gradient of {worst[1]} "
                           f"off by {worst[0]}")
    total = "total" if "total" in ref else "loss"
    out = {"worst": worst, "loss": (float(got[total]), float(ref[total])), "card": card}
    if g64 is not None:
        k = worst[1]
        out["f64"] = {"at_worst": (rel(g_card[k], g64[k]), rel(g_cpu[k], g64[k])),
                      "card": max((rel(g_card[j], g64[j]), j) for j in g64),
                      "cpu": max((rel(g_cpu[j], g64[j]), j) for j in g64)}
    return out


def main(models=()):
    """Each case's readings as one JSON line, no limit held; ``models``
    (the command line's arguments), when given, keeps only their cases."""
    dev = torch.device("cuda")
    for model, b, img in READ:
        if models and model not in models:
            continue
        r = card_against_cpu(model, dev, b, img, hold=False)
        print(json.dumps({"model": model, "batch": b, "img_size": img, "worst": r["worst"][0],
                          "leaf": r["worst"][1], "limit": GRAD_REL[model],
                          "loss_card_cpu": r["loss"], "f64": r.get("f64")}))


if __name__ == "__main__":
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    sys.exit(main(sys.argv[1:]))
