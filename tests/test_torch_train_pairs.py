"""One f32 train step of each model on the card against the CPU, from the
same weights and batch (TF32 off): the cases and the limits that
chip_smoke.py's phase "training" and tests/test_torch_cuda.py share.

HaMeR at full width with 2 blocks, YOLOv7 at 64 px (tests/test_training.py's
SMALL_CFG) at B = 8, KPFusion at --tiny with its BN variances
calibrated on the batch. The metrics at LOSS_REL; each gradient leaf by its
relative norm error at GRAD_REL (the limits of the CPU tests against JAX,
tests/test_torch_train_*.py). The gradients are taken before any optimizer
step: torch's foreach SGD (the card's) adds the Nesterov term into .grad in
place, where the CPU's does not.

``python tests/test_torch_train_pairs.py`` (on a machine with a card) prints the
worst leaf of each case in READ without holding it to its limit, and for
the YOLO cases the f32 gradient's distance from the CPU's f64 one on either
device.
"""
import json
import os
import sys

import numpy as np
import torch

LOSS_REL = {"hamer": 1e-4, "yolo": 1e-4, "kpfusion": 1e-3}
GRAD_REL = {"hamer": 1e-3, "yolo": 3e-3, "kpfusion": 1e-2}
# biases that a softmax cancels: gradient 0 in exact arithmetic, rounding noise
SOFTMAX_CANCELLED = {"kpfusion": ("finals/2/b", "/k/b")}
# (model, batch size) held at the limits
CASES = (("hamer", 2), ("yolo", 8), ("kpfusion", 2))
# read by main() and not held: YOLO at B = 2, where the 2 x 2 P5 map's batch
# statistics (8 values a channel) leave the CPU's own f32 gradient 2e-2 from
# its f64 one at the worst leaf (PERF.md, PR 14)
READ = CASES + (("yolo", 2),)


def to_device(tree, dev):
    if isinstance(tree, dict):
        return {k: to_device(v, dev) for k, v in tree.items()}
    if isinstance(tree, list):
        return [to_device(v, dev) for v in tree]
    return None if tree is None else tree.to(dev)


def train_pair(model, dev, batch_size=2):
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
    if model == "yolo":
        cfg = YoloConfig(nc=3, img_size=64, compute_dtype="float32")
        cpu = TY.init_yolo_train_state(torch.Generator().manual_seed(4), cfg, 100)
        card = TY.make_yolo_train_state(to_device(cpu.params, dev), 100)
        batch = TY.synthetic_yolo_batch(torch.Generator().manual_seed(5), batch_size, 64)
        step = TY.make_yolo_train_step(cfg)
        return dict(card=card, cpu=cpu, batch=batch, cfg=cfg,
                    loss=lambda s, c: TY.yolo_loss_fn(s.params, moved(batch, c), cfg)[0]["loss"],
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

    cfg = dataclasses.replace(pair["cfg"], compute_dtype="float64")
    params = trainable(map_tree(lambda t: t.detach().double(), pair["cpu"].params), is_bn_stat)
    batch = {k: v.double() for k, v in pair["batch"].items()}
    maps, _ = yolov7_train_forward(params, batch["img"], cfg)
    anchors = torch.tensor(cfg.anchors, dtype=torch.float64).reshape(cfg.nl, cfg.na, 2)
    loss = yolo_loss(maps, batch["targets"], anchors, cfg.strides, cfg.nc)["loss"]
    leaves = [(f"0/{k}", t) for k, t in named_leaves(params) if t.requires_grad]
    g = torch.autograd.grad(loss, [t for _, t in leaves], allow_unused=True,
                            materialize_grads=True)
    return {k: v.detach() for (k, _), v in zip(leaves, g)}


def rel(a, b):
    return float((a - b).norm() / max(float(b.norm()), 1e-30))


def card_against_cpu(model, dev, batch_size=2, hold=True):
    """One step of ``model``'s pair on both devices. Returns {"worst": (the
    largest relative gradient error, its leaf), "loss": (card, CPU), "card":
    the card's state after its step}, and for YOLO "f64": {"at_worst": the
    card's and the CPU's f32 gradient from the f64 one at that leaf, "card"
    and "cpu": each device's largest such error and its leaf}. ``hold``:
    raise where a metric or a gradient is past its limit."""
    pair = train_pair(model, dev, batch_size)
    card, cpu = pair["card"], pair["cpu"]
    g_card, g_cpu = gradients(pair["loss"](card, True), card), gradients(pair["loss"](cpu, False),
                                                                         cpu)
    g64 = yolo_f64_gradients(pair) if model == "yolo" else None
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


def main():
    """Each case's readings as one JSON line, no limit held."""
    dev = torch.device("cuda")
    for model, b in READ:
        r = card_against_cpu(model, dev, b, hold=False)
        print(json.dumps({"model": model, "batch": b, "worst": r["worst"][0],
                          "leaf": r["worst"][1], "limit": GRAD_REL[model],
                          "loss_card_cpu": r["loss"], "f64": r.get("f64")}))


if __name__ == "__main__":
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    sys.exit(main())
