"""SimOTA, the auxiliary heads and IBin's loss (hamer_yolo_tpu_torch/training/
losses.py, models/yolov7/), the IAuxDetect training form, the ViT's
stochastic depth and the activation zoo, against the JAX package's on the
same numpy-made maps, weights and batches.

Tolerances, stated at each test: loss values at rel 1e-5 (the JAX
package's tests/test_primary_losses.py) and their gradients over the maps
at GRAD_REL; whole train steps at the train step tests' limits
(tests/test_torch_train_yolo.py: metrics at rel 1e-4, each leaf's move and
the BN stats by relative norm at MODEL_REL); forwards at rel 1e-5 by norm.
"""
import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from hamer_yolo_tpu.core import activations as JA
from hamer_yolo_tpu.models import vit as JV
from hamer_yolo_tpu.models.yolov7 import heads as JH
from hamer_yolo_tpu.models.yolov7 import model as JY
from hamer_yolo_tpu.models.yolov7.yaml_spec import spec_from_yaml as jspec_from_yaml
from hamer_yolo_tpu.training import losses as jlosses
from hamer_yolo_tpu.training import optim as joptim
from hamer_yolo_tpu.training import train_yolo as jtrain
from hamer_yolo_tpu_torch.core import activations as TA
from hamer_yolo_tpu_torch.core.bridge import from_jax_params
from hamer_yolo_tpu_torch.models import vit as TV
from hamer_yolo_tpu_torch.models.yolov7 import blocks as TB
from hamer_yolo_tpu_torch.models.yolov7 import heads as TH
from hamer_yolo_tpu_torch.models.yolov7 import model as TY
from hamer_yolo_tpu_torch.models.yolov7.yaml_spec import spec_from_yaml
from hamer_yolo_tpu_torch.training import losses as tlosses
from hamer_yolo_tpu_torch.training import optim as toptim
from hamer_yolo_tpu_torch.training import train_yolo as ttrain
from test_torch_bridge import numpy_params
from test_torch_train_hamer import flat, rel_err
from test_torch_train_yolo import (ANCHORS, MINI_SPEC, MODEL_REL, STRIDES, TOTAL, WARMUP,
                                   numpy_targets)
from test_torch_yolo_family import P6_YAML

torch.set_num_threads(1)

B = 2
GRAD_REL = 2e-4
BIN_NO = 3 + 3 + 2 * 22   # nc 3, bin_count 21
# The reference's train_aux.py form at the smallest size: two lead levels
# and two auxiliary ones (JAX's tests/test_aux_ota.py)
AUX_SPEC = [(-1, "C", (8, 3, 2)), (-1, "C", (16, 3, 2)), (-1, "C", (16, 3, 2)),
            (-1, "C", (32, 3, 2)), (2, "C", (16, 1, 1)), (3, "C", (32, 1, 1)),
            ((2, 3, 4, 5), "AUXDET", ())]
AUX_ANCHORS = ((12, 16, 19, 36, 40, 28), (36, 75, 76, 55, 72, 146))


def _maps(rng, no, zero=False):
    return [(np.zeros if zero else lambda s: rng.normal(size=s))((B, n, n, 3 * no)).astype(
        np.float32) for n in (8, 4, 2)]


def _cases():
    rng = np.random.default_rng(40)
    tied = numpy_targets(rng)
    tied[:, 1] = tied[:, 0]          # two identical targets: equal costs and IoUs
    tied[:, 2, 1:] = tied[:, 3, 1:]
    return {"random": (_maps(rng, 8), numpy_targets(rng)),
            "ties": (_maps(rng, 8, zero=True), tied),
            "many_targets": (_maps(rng, 8), numpy_targets(rng, T=24, n_valid=20)),
            "no_targets": (_maps(rng, 8), np.zeros((B, 4, 5), np.float32))}


_JAX_LOSS = {}


def _jax_loss(kw):
    """JAX's yolo_loss and its gradient over the maps, jitted once per
    keyword set (and per shape, by jit)."""
    key = tuple(sorted(kw.items()))
    if key not in _JAX_LOSS:
        def jf(ms, ax, t):
            return jlosses.yolo_loss(ms, t, jnp.asarray(ANCHORS), STRIDES, 3, aux_maps=ax, **kw)

        _JAX_LOSS[key] = jax.jit(lambda ms, ax, t: (
            jf(ms, ax, t), jax.grad(lambda m: jf(m, ax, t)["loss"])(ms)))
    return _JAX_LOSS[key]


def _check_loss(maps, targets, aux=None, **kw):
    """loss, box, obj, cls at rel 1e-5 (atol 1e-7) and the loss's gradient
    over each map at GRAD_REL, against JAX's jitted yolo_loss."""
    jaux = None if aux is None else [jnp.asarray(m) for m in aux]
    ref, jgrads = _jax_loss(kw)([jnp.asarray(m) for m in maps], jaux, jnp.asarray(targets))
    tmaps = [torch.from_numpy(m).requires_grad_(True) for m in maps]
    got = tlosses.yolo_loss(tmaps, torch.from_numpy(targets), torch.from_numpy(ANCHORS),
                            STRIDES, 3, aux_maps=None if aux is None else
                            [torch.from_numpy(m) for m in aux], **kw)
    for k in ("loss", "box", "obj", "cls"):
        np.testing.assert_allclose(float(got[k].detach()), float(ref[k]), rtol=1e-5, atol=1e-7,
                                   err_msg=k)
    for g, jg in zip(torch.autograd.grad(got["loss"], tmaps), jgrads):
        assert rel_err(g.numpy(), np.asarray(jg)) < GRAD_REL


@pytest.mark.parametrize("form,case", [
    ("simota", "random"), ("simota", "ties"), ("simota", "many_targets"),
    ("simota", "no_targets"), ("aux", "random"), ("aux", "ties"), ("neighbor_aux", "random")])
def test_yolo_loss_matches_jax(form, case):
    """yolo_loss with the SimOTA assigner, with the auxiliary maps
    (ComputeLossAuxOTA, top k 20) and the neighbor assigner's aux form;
    "ties": all-zero maps (every candidate of a cell the same box and
    score) and duplicated targets, so costs and IoUs tie; 20 targets of 24
    rows; none."""
    maps, targets = _cases()[case]
    aux = None if form == "simota" else [m[..., ::-1].copy() for m in maps]
    kw = {"simota": {"assigner": "simota"}, "aux": {"assigner": "simota", "ota_topk": 20},
          "neighbor_aux": {}}[form]
    _check_loss(maps, targets, aux, **kw)


@pytest.mark.parametrize("case", ["random", "ties"])
def test_bin_head_loss_matches_jax(case):
    """yolo_loss(head="bin") (ComputeLossBinOTA) on IBin's channel layout."""
    rng = np.random.default_rng(41)
    _, targets = _cases()[case]
    _check_loss(_maps(rng, BIN_NO, zero=case == "ties"), targets, assigner="simota", head="bin")


def test_dynamic_k_ties_do_not_depend_on_topk_order():
    """Dynamic k sums the top IoUs; equal IoUs in another order give the
    same sum: the port's dynamic k on a grid of equal boxes equals the
    sum-of-top-k a stable sort gives, and the selections equal JAX's (held
    through the losses by test_yolo_loss_matches_jax[ties])."""
    iou = torch.tensor([[0.3, 0.3, 0.3, 0.1, 0.3, 0.0]])
    top = torch.topk(iou, 4, dim=-1).values.sum(-1)
    assert float(top[0]) == float(jnp.sum(jax.lax.top_k(jnp.asarray(iou.numpy()), 4)[0], -1)[0])


def test_sigmoid_bin_training_loss_matches_jax():
    """SigmoidBin's training loss, unmasked and masked, with targets on bin
    centres and midway between two (a tie: the first bin), and its regressed
    value, at rel 1e-5; the gradient over the logits at GRAD_REL."""
    rng = np.random.default_rng(42)
    logits = rng.normal(size=(12, 22)).astype(np.float32)
    centers = np.asarray(JH.sigmoid_bin_centers(21))
    target = rng.uniform(0.1, 3.9, 12).astype(np.float32)
    target[:3] = centers[[0, 5, 20]]
    target[3] = (centers[4] + centers[5]) / 2
    weight = (rng.uniform(size=12) < 0.6).astype(np.float32)
    for w in (None, weight):
        ref = JH.sigmoid_bin_training_loss(jnp.asarray(logits), jnp.asarray(target),
                                           None if w is None else jnp.asarray(w))
        jg = jax.grad(lambda lg: JH.sigmoid_bin_training_loss(
            lg, jnp.asarray(target), None if w is None else jnp.asarray(w))[0])(
            jnp.asarray(logits))
        tl = torch.from_numpy(logits).requires_grad_(True)
        got = TH.sigmoid_bin_training_loss(tl, torch.from_numpy(target),
                                           None if w is None else torch.from_numpy(w))
        np.testing.assert_allclose(float(got[0].detach()), float(ref[0]), rtol=1e-5)
        np.testing.assert_allclose(got[1].detach().numpy(), np.asarray(ref[1]), rtol=1e-5,
                                   atol=1e-6)
        g, = torch.autograd.grad(got[0], tl)
        assert rel_err(g.numpy(), np.asarray(jg)) < GRAD_REL


def test_aux_training_form_matches_jax():
    """The literal IAuxDetect yaml (tests/test_torch_yolo_family.P6_YAML)
    with training_form: the same AUXDET spec and config as JAX's; init's
    tree ("m" lead and "m2" auxiliary heads) shaped as JAX's; the training
    forward's 4 + 4 maps (BN over batch statistics) at rel 1e-4 by norm (as
    tests/test_torch_train_yolo.py holds MINI_SPEC's), split_aux_maps, and
    the inference forward (lead maps only) at rel 1e-5 on the same weights."""
    spec, tcfg = spec_from_yaml(P6_YAML, nc=3, training_form=True)
    jspec, jcfg = jspec_from_yaml(P6_YAML, nc=3, training_form=True)
    assert spec == jspec and spec[-1][1] == TY.AUXDET == JY.AUXDET
    assert (tcfg.nc, tcfg.anchors, tcfg.strides) == (jcfg.nc, jcfg.anchors, jcfg.strides)
    assert tcfg.strides == (8, 16, 32, 64)
    deploy, _ = spec_from_yaml(P6_YAML, nc=3)
    assert deploy[-1][1] == TY.DET and len(deploy[-1][0]) == 4
    jcfg = dataclasses.replace(jcfg, compute_dtype="float32")
    tcfg = dataclasses.replace(tcfg, compute_dtype="float32")
    params = jax.tree_util.tree_map(np.asarray, numpy_params(
        lambda k: JY.init_yolov7(k, jcfg, deploy=False, spec=jspec), 43))
    mine = TY.init_yolov7(torch.Generator().manual_seed(0), tcfg, spec, deploy=False)
    assert {k: v.shape for k, v in flat(mine).items()} == \
        {k: v.shape for k, v in flat(params).items()}
    x = np.random.default_rng(44).uniform(size=(1, 128, 128, 3)).astype(np.float32)
    jmaps, _ = jax.jit(lambda p, x: JY.yolov7_train_forward(p, x, jcfg, spec=jspec))(
        params, jnp.asarray(x))
    tp = from_jax_params(params)
    maps, _ = TY.yolov7_train_forward(tp, torch.from_numpy(x), tcfg, spec)
    lead, aux = TY.split_aux_maps(maps, spec)
    assert len(lead) == len(aux) == 4 and len(maps) == len(jmaps) == 8
    for g, r in zip(maps, jmaps):
        assert rel_err(g.detach().numpy().astype(np.float64), np.asarray(r)) < 1e-4
    inf = TY.yolov7_backbone_forward(tp, torch.from_numpy(x), tcfg, spec)
    jinf = jax.jit(lambda p, x: JY.yolov7_backbone_forward(p, x, jcfg, spec=jspec))(
        params, jnp.asarray(x))
    assert len(inf) == len(jinf) == 4
    for g, r in zip(inf, jinf):
        assert rel_err(g.numpy().astype(np.float64), np.asarray(r)) < 1e-5
    assert TY.split_aux_maps(lead, deploy) == (lead, [])


def _two_jax_steps(jcfg, spec, params, batch, assigner, ota_topk):
    tx = joptim.yolo_optimizer(params, total_steps=TOTAL, warmup_steps=WARMUP)
    state = jtrain.YoloTrainState(params, tx.init(params), joptim.ema_init(params),
                                  jnp.zeros((), jnp.int32))
    step = jax.jit(jtrain.make_yolo_train_step(jcfg, tx, spec=spec, assigner=assigner,
                                               ota_topk=ota_topk))
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    out = []
    for _ in range(2):
        state, metrics = step(state, jbatch)
        out.append((jax.tree_util.tree_map(np.asarray, state), metrics))
    return out


@pytest.mark.parametrize("form", ["simota", "aux"])
def test_two_train_steps_match_jax(form):
    """Two whole steps with SimOTA (MINI_SPEC, 3 levels) and with the
    auxiliary heads (AUX_SPEC, ComputeLossAuxOTA's top k 20) against JAX's
    jitted step: metrics at rel 1e-4, each leaf's move from the start (the
    parameters and the EMA) and the BN stats by relative norm at MODEL_REL."""
    spec, anchors, seed = ((MINI_SPEC, TY.YoloConfig().anchors, 45) if form == "simota"
                           else (AUX_SPEC, AUX_ANCHORS, 46))
    strides = (8, 16, 32)[:len(anchors)]
    jcfg = JY.YoloConfig(nc=3, img_size=64, compute_dtype="float32", anchors=anchors,
                         strides=strides)
    tcfg = TY.YoloConfig(nc=3, img_size=64, compute_dtype="float32", anchors=anchors,
                         strides=strides)
    topk = 10 if form == "simota" else 20
    params = jax.tree_util.tree_map(np.asarray, numpy_params(
        lambda k: JY.init_yolov7(k, jcfg, deploy=False, spec=spec), seed))
    rng = np.random.default_rng(seed + 1)
    batch = {"img": rng.uniform(size=(B, 64, 64, 3)).astype(np.float32),
             "targets": numpy_targets(rng)}
    steps = _two_jax_steps(jcfg, spec, params, batch, "simota", topk)
    state = ttrain.make_yolo_train_state(from_jax_params(params), TOTAL)
    state.opt, state.sched = toptim.yolo_optimizer(state.params, total_steps=TOTAL,
                                                   warmup_steps=WARMUP)
    step = ttrain.make_yolo_train_step(tcfg, spec, assigner="simota", ota_topk=topk)
    tbatch = {k: torch.from_numpy(v) for k, v in batch.items()}
    for jstate, jmetrics in steps:
        metrics = step(state, tbatch)
        for k in ("loss", "box", "obj", "cls"):
            np.testing.assert_allclose(float(metrics[k]), float(jmetrics[k]), rtol=1e-4,
                                       err_msg=k)
    start = flat(params)
    for tree, jtree in ((state.params, jstate.params), (state.ema.params, jstate.ema.params)):
        got, ref = flat(tree), flat(jtree)
        assert got.keys() == ref.keys()
        for k in ref:
            if k.endswith(("/mean", "/var")):
                assert rel_err(got[k], ref[k]) < MODEL_REL, k
            elif np.any(ref[k] != start[k]):
                assert rel_err(got[k] - start[k], ref[k] - start[k]) < MODEL_REL, k
    if form == "aux":  # the auxiliary heads learn
        assert any(np.any(flat(state.params)[k] != start[k]) for k in start if "/m2/" in k)


def test_stochastic_depth_matches_jax(monkeypatch):
    """vit_forward with a generator against JAX's with an rng whose
    bernoulli draws are replaced by the port's keep masks from the same
    generator seed (in JAX's order: block 0's attention, then its MLP, ...),
    at rel 1e-5 by norm, f32, 3 blocks with drop_path_rate 0.55; the rates
    ramp 0, 0.275, 0.55 (block 0 keeps all); with a generator the ViT takes
    the plain layers even where fused_attn asks for K2."""
    jcfg = JV.ViTConfig(img_size=(64, 48), embed_dim=32, depth=3, num_heads=4,
                        compute_dtype="float32")
    tcfg = TV.ViTConfig(img_size=(64, 48), embed_dim=32, depth=3, num_heads=4,
                        compute_dtype="float32", fused_attn=True)
    params = jax.tree_util.tree_map(np.asarray, numpy_params(lambda k: JV.init_vit(k, jcfg), 47))
    x = np.random.default_rng(48).normal(size=(8, 64, 48, 3)).astype(np.float32)
    masks = TV.keep_masks(torch.Generator().manual_seed(3), 8, tcfg, 3)
    assert len(masks) == 6 and masks[0].all() and masks[1].all()
    assert all(m.shape == (8, 1, 1) and m.dtype == torch.bool for m in masks)
    assert not all(m.all() for m in masks[2:])  # some residuals dropped
    np.testing.assert_allclose(TV.drop_path_rates(tcfg, 3), [0.0, 0.275, 0.55])
    queue = [m.numpy() for m in masks]
    monkeypatch.setattr(jax.random, "bernoulli",
                        lambda key, p, shape: jnp.asarray(queue.pop(0)))
    ref = JV.vit_forward(params, jnp.asarray(x), jcfg, rng=jax.random.PRNGKey(0))
    assert not queue
    tp = from_jax_params(params)
    got = TV.vit_forward(tp, torch.from_numpy(x), tcfg, generator=torch.Generator().manual_seed(3))
    assert rel_err(got.numpy().astype(np.float64), np.asarray(ref)) < 1e-5
    plain = TV.vit_forward(tp, torch.from_numpy(x), dataclasses.replace(tcfg, fused_attn=False))
    assert rel_err(got.numpy(), plain.numpy()) > 1e-3


@pytest.mark.parametrize("name", ["silu", "hardswish", "mish", "frelu"])
def test_activations_match_jax(name):
    """Each activation (values at rel 1e-6, atol 1e-6; the gradient at
    GRAD_REL), including x at -3, 0 and 3, where hardswish's clip ties; and
    conv_block(act=) takes it, True (SiLU) and False (none)."""
    rng = np.random.default_rng(50)
    x = rng.normal(size=(2, 6, 6, 4)).astype(np.float32) * 3
    x[0, 0, 0, :3] = (-3.0, 0.0, 3.0)
    if name == "frelu":
        jp = jax.tree_util.tree_map(np.asarray, numpy_params(lambda k: JA.frelu_init(k, 4), 51))
        jf = lambda v: JA.frelu(jp, v)  # noqa: E731
        tp = from_jax_params(jp)
        tf = lambda v: TA.frelu(tp, v)  # noqa: E731
        assert flat(TA.frelu_init(torch.Generator().manual_seed(0), 4)).keys() == flat(jp).keys()
    else:
        jf, tf = getattr(JA, name), getattr(TA, name)
    ref, jg = jax.value_and_grad(lambda v: jnp.sum(jf(v) ** 2))(jnp.asarray(x))
    tx = torch.from_numpy(x).requires_grad_(True)
    out = tf(tx)
    np.testing.assert_allclose(float((out ** 2).sum().detach()), float(ref), rtol=1e-6)
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(jf(jnp.asarray(x))), rtol=1e-6,
                               atol=1e-6)
    g, = torch.autograd.grad((out ** 2).sum(), tx)
    assert rel_err(g.numpy(), np.asarray(jg)) < GRAD_REL
    cp = {"conv": {"w": torch.from_numpy(rng.normal(size=(4, 4, 3, 3)).astype(np.float32)),
                   "b": torch.zeros(4)}}
    xt = torch.from_numpy(x)
    lin = TB.conv_block(cp, xt, act=False)
    np.testing.assert_array_equal(TB.conv_block(cp, xt, act=tf).detach().numpy(),
                                  tf(lin).detach().numpy())
    np.testing.assert_array_equal(TB.conv_block(cp, xt).numpy(), TB.silu(lin).numpy())
