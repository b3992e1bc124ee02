"""YOLOv7's train step (hamer_yolo_tpu_torch/training/train_yolo.py), its
training-form detector, nn.batch_norm_train, yolo_loss with the neighbor
assigner, the SGD optimizer, schedules, decay mask and EMA, and map_hyp,
against the JAX package's on the same numpy-made weights and batch, at
tests/test_training.py's SMALL_CFG (nc 3, 64 px, f32).

Tolerances, stated at each test: losses at rel 1e-5 (the JAX package's
tests/test_primary_losses.py), gradients by the relative norm error of each
leaf (GRAD_REL), parameters after SGD by f32 ulps of the magnitude the
update summed (ULPS). Through the training forward at this size the
normalisation by batch statistics over 8 to 32 values a channel (the 2 x 2
P5 map of 2 images) amplifies the convolutions' rounding, so the model's
maps, gradients and updates are held at MODEL_REL:
test_f32_gradient_sits_within_half_the_limit_of_f64 holds the port's f32
gradient within half of it from its own f64 one, the other half is JAX's
f32 rounding of the same kind.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from hamer_yolo_tpu.core import nn as jnn
from hamer_yolo_tpu.models.yolov7 import model as JY
from hamer_yolo_tpu.training import losses as jlosses
from hamer_yolo_tpu.training import optim as joptim
from hamer_yolo_tpu.training import train_yolo as jtrain
from hamer_yolo_tpu.training.hyp import map_hyp as jmap_hyp
from hamer_yolo_tpu_torch.core import nn as tnn
from hamer_yolo_tpu_torch.core.bridge import from_jax_params, to_jax_layout
from hamer_yolo_tpu_torch.models.yolov7 import model as TY
from hamer_yolo_tpu_torch.training import losses as tlosses
from hamer_yolo_tpu_torch.training import optim as toptim
from hamer_yolo_tpu_torch.training import train_yolo as ttrain
from hamer_yolo_tpu_torch.training.hyp import map_hyp
from hamer_yolo_tpu_torch.training.optim import named_leaves
from test_torch_bridge import jax_exact, numpy_params
from test_torch_train_hamer import flat, rel_err

torch.set_num_threads(1)

B = 2
GRAD_REL = 2e-4   # per leaf: |g - g_jax| / |g_jax|
MODEL_REL = 3e-3  # per map or leaf, through the training forward (module docstring)
ULPS = 6          # SGD, 3 steps, each rounding p + update once in either package: f32
                  # ulps of max(|p_jax|, |p_start|, the sum of |update|)
TOTAL, WARMUP = 10, 1   # a schedule whose second update is not 0
STRIDES = (8, 16, 32)
ANCHORS = JY.YOLOV7_ANCHORS
# A small spec with every training-form block the built-in one has, and
# RepConv's identity branch (c1 == c2), which the built-in one lacks
MINI_SPEC = [(-1, "C", (8, 3, 2)), (-1, "C", (16, 3, 2)), (-1, "C", (16, 3, 2)),
             (-1, "REP", (16,)), (-1, "C", (16, 3, 2)), (-1, "SPP", (16,)),
             (-1, "MP", ()), (-2, "C", (24, 3, 2)), ((-1, -2), "CAT", ()),
             ((3, 5, 8), "DET", ())]


def configs(dtype="float32"):
    return (JY.YoloConfig(nc=3, img_size=64, compute_dtype=dtype),
            TY.YoloConfig(nc=3, img_size=64, compute_dtype=dtype))


def numpy_targets(rng, T=8, n_valid=4, nc=3):
    """synthetic_yolo_batch's label rows: [cls, cx, cy, w, h], padding w = h = 0."""
    cls = rng.integers(0, nc, (B, T, 1)).astype(np.float32)
    cxy = rng.uniform(0.2, 0.8, (B, T, 2)).astype(np.float32)
    wh = rng.uniform(0.05, 0.3, (B, T, 2)).astype(np.float32)
    wh[:, n_valid:] = 0
    return np.concatenate([cls, cxy, wh], -1)


def ulps_apart(got, ref, start, moved):
    """|got - ref| in f32 ulps of the largest magnitude the updates summed:
    max(|ref|, |start|, ``moved``, the sum of the updates' sizes)."""
    mag = np.maximum(np.maximum(np.abs(ref), np.abs(start)), moved)
    return np.abs(got - ref) / np.spacing(mag.astype(np.float32))


@pytest.fixture(scope="module")
def setup():
    """Training-form weights, a batch, JAX's loss, gradient and new BN stats
    (one value_and_grad), and two jitted JAX train steps."""
    jcfg, tcfg = configs()
    params = jax.tree_util.tree_map(
        np.asarray, numpy_params(lambda k: JY.init_yolov7(k, jcfg, deploy=False), 11))
    rng = np.random.default_rng(12)
    batch = {"img": rng.uniform(size=(B, 64, 64, 3)).astype(np.float32),
             "targets": numpy_targets(rng)}
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    anchors = jnp.asarray(ANCHORS)

    def loss_fn(p, b):
        maps, stats = JY.yolov7_train_forward(p, b["img"], jcfg)
        out = jlosses.yolo_loss([m.astype(jnp.float32) for m in maps], b["targets"], anchors,
                                STRIDES, 3)
        return out["loss"], (out, maps, stats)

    (loss, (out, maps, stats)), grads = jax_exact(
        lambda p, b: jax.value_and_grad(loss_fn, has_aux=True)(p, b), params, jbatch)
    tx = joptim.yolo_optimizer(params, total_steps=TOTAL, warmup_steps=WARMUP)
    state = jtrain.YoloTrainState(params, tx.init(params), joptim.ema_init(params),
                                  jnp.zeros((), jnp.int32))
    step = jax.jit(jtrain.make_yolo_train_step(jcfg, tx))
    steps = []
    for _ in range(2):
        state, metrics = step(state, jbatch)
        steps.append((jax.tree_util.tree_map(np.asarray, state), metrics))
    return dict(jcfg=jcfg, tcfg=tcfg, params=params, batch=batch, out=out, maps=maps,
                stats=stats, grads=grads, steps=steps)


def port_batch(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_batch_norm_train_matches_jax(dtype):
    """y, and the running stats' update (momentum 0.03, unbiased variance):
    f32 at rel 1e-5; bf16 y within one bf16 ulp of JAX's on under 1% of
    elements (the f32 moments summed in other orders), the stats at rel 1e-5."""
    rng = np.random.default_rng(13)
    x = (3.0 + 2.0 * rng.normal(size=(4, 8, 8, 6))).astype(np.float32)
    p = {"scale": (1 + 0.2 * rng.normal(size=6)).astype(np.float32),
         "bias": rng.normal(size=6).astype(np.float32),
         "mean": (0.1 * rng.normal(size=6)).astype(np.float32),
         "var": rng.uniform(0.5, 1.5, 6).astype(np.float32)}
    ref_y, ref_p = jax_exact(lambda p, x: jnn.batch_norm_train(p, x.astype(dtype)), p,
                             jnp.asarray(x))
    got_y, got_p = tnn.batch_norm_train(from_jax_params(p),
                                        torch.from_numpy(x).to(getattr(torch, dtype)))
    assert got_y.dtype == getattr(torch, dtype)
    ref_y = np.asarray(ref_y.astype(jnp.float32))
    got_y = got_y.float().numpy()
    if dtype == "float32":
        np.testing.assert_allclose(got_y, ref_y, rtol=1e-5, atol=1e-6)
    else:
        ulp = np.spacing(np.abs(ref_y).astype(np.float32)) * 2 ** 16  # bf16's
        off = np.abs(got_y - ref_y)
        assert off.max() <= ulp.max() and (off > 0).mean() < 0.01
    for k in ("mean", "var"):
        np.testing.assert_allclose(got_p[k].numpy(), np.asarray(ref_p[k]), rtol=1e-5, err_msg=k)
        assert not got_p[k].requires_grad


def test_train_forward_matches_jax(setup):
    """The training forward's three maps and every BN leaf's new running
    stats by relative norm at MODEL_REL, against JAX's."""
    s = setup
    maps, stats = TY.yolov7_train_forward(from_jax_params(s["params"]),
                                          torch.from_numpy(s["batch"]["img"]), s["tcfg"])
    assert len(maps) == 3
    for got, ref in zip(maps, s["maps"]):
        assert got.shape == ref.shape
        assert rel_err(got.detach().numpy().astype(np.float64), np.asarray(ref)) < MODEL_REL
    got, ref = flat(stats), flat(s["stats"])
    assert got.keys() == ref.keys()
    stat_keys = [k for k in ref if k.endswith(("/mean", "/var"))]
    assert stat_keys
    for k in stat_keys:
        assert rel_err(got[k], ref[k]) < MODEL_REL, k


def _loss_cases():
    rng = np.random.default_rng(14)
    maps = [rng.normal(size=(B, n, n, 24)).astype(np.float32) for n in (8, 4, 2)]
    corner = numpy_targets(rng)
    corner[0, 0, 1:3] = [0.5, 0.25]   # a centre on a cell corner of every level (fx == 0)
    corner[1, :2, 1:] = corner[1, 2:4, 1:]   # two targets on the same cells: duplicate writes
    return {"random": (maps, numpy_targets(rng)),
            "corner_and_duplicates": (maps, corner),
            "no_targets": ([np.zeros_like(m) for m in maps], np.zeros((B, 4, 5), np.float32))}


@pytest.mark.parametrize("case", ["random", "corner_and_duplicates", "no_targets"])
def test_yolo_loss_matches_jax(case):
    """loss, box, obj, cls at rel 1e-5 (atol 1e-7 for the zero box and cls
    of no targets), and the gradient of the loss over each map at GRAD_REL."""
    maps, targets = _loss_cases()[case]
    jf = lambda ms: jlosses.yolo_loss(ms, jnp.asarray(targets), jnp.asarray(ANCHORS), STRIDES, 3)
    ref, jgrads = jax.jit(lambda ms: (jf(ms), jax.grad(lambda m: jf(m)["loss"])(ms)))(
        [jnp.asarray(m) for m in maps])
    tmaps = [torch.from_numpy(m).requires_grad_(True) for m in maps]
    got = tlosses.yolo_loss(tmaps, torch.from_numpy(targets), torch.from_numpy(ANCHORS),
                            STRIDES, 3)
    for k in ("loss", "box", "obj", "cls"):
        np.testing.assert_allclose(float(got[k].detach()), float(ref[k]), rtol=1e-5, atol=1e-7,
                                   err_msg=k)
    grads = torch.autograd.grad(got["loss"], tmaps)
    for g, jg in zip(grads, jgrads):
        assert rel_err(g.numpy(), np.asarray(jg)) < GRAD_REL


def test_ciou_matches_jax():
    """CIoU of random box pairs, identical and disjoint boxes at rel 1e-5."""
    rng = np.random.default_rng(15)
    a = np.concatenate([rng.uniform(0, 10, (64, 2)), rng.uniform(0.5, 4, (64, 2))], -1)
    b = np.concatenate([rng.uniform(0, 10, (64, 2)), rng.uniform(0.5, 4, (64, 2))], -1)
    b[:4] = a[:4]
    a, b = a.astype(np.float32), b.astype(np.float32)
    ref = np.asarray(jlosses.bbox_ciou(jnp.asarray(a), jnp.asarray(b)))
    got = tlosses.bbox_ciou(torch.from_numpy(a), torch.from_numpy(b)).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-6)


def test_gradients_match_jax(setup):
    """The gradient of the whole loss (training forward + yolo_loss) for
    every trained leaf, at MODEL_REL; JAX's BN running stats get 0."""
    s = setup
    state = ttrain.make_yolo_train_state(from_jax_params(s["params"]))
    b = port_batch(s["batch"])
    maps, _ = TY.yolov7_train_forward(state.params, b["img"], s["tcfg"])
    out = tlosses.yolo_loss([m.float() for m in maps], b["targets"], torch.from_numpy(ANCHORS),
                            STRIDES, 3)
    np.testing.assert_allclose(float(out["loss"].detach()), float(s["out"]["loss"]), rtol=1e-5)
    leaves = [(k, t) for k, t in named_leaves(state.params) if t.requires_grad]
    grads = torch.autograd.grad(out["loss"], [t for _, t in leaves])
    ref = flat(s["grads"])
    for (k, _), g in zip(leaves, grads):
        assert rel_err(to_jax_layout(g).astype(np.float64), ref[k]) < MODEL_REL, k
    untrained = set(ref) - {k for k, _ in leaves}
    assert untrained and all(k.endswith(("/mean", "/var")) and not ref[k].any()
                             for k in untrained)


def test_sgd_schedule_and_mask_match_optax():
    """yolo_optimizer alone: the same gradients for 3 steps into JAX's
    (add_decayed_weights under decay_mask, then SGD with Nesterov momentum
    under the warmed one-cycle schedule) and the port's: every parameter
    within ULPS ulps."""
    jcfg, _ = configs()
    params = jax.tree_util.tree_map(np.asarray, numpy_params(
        lambda k: JY.init_yolov7(k, jcfg, deploy=False, spec=MINI_SPEC), 16))
    rng = np.random.default_rng(16)
    grads = [jax.tree_util.tree_map(
        lambda a: rng.normal(size=a.shape).astype(np.float32), params) for _ in range(3)]
    tx = joptim.yolo_optimizer(params, total_steps=TOTAL, warmup_steps=WARMUP)
    jp, jst = params, tx.init(params)
    upd_fn = jax.jit(tx.update)
    moved = {k: 0.0 for k in flat(params)}
    for g in grads:
        upd, jst = upd_fn(g, jst, jp)
        moved = {k: moved[k] + np.abs(v) for k, v in flat(upd).items()}
        jp = jax.tree_util.tree_map(lambda a, u: a + u, jp, upd)
    state = ttrain.make_yolo_train_state(from_jax_params(params), TOTAL)
    opt, sched = toptim.yolo_optimizer(state.params, total_steps=TOTAL, warmup_steps=WARMUP)
    for g in grads:
        gt = dict(named_leaves(from_jax_params(g)))
        for k, t in named_leaves(state.params):
            t.grad = gt[k] if t.requires_grad else None
        opt.step()
        sched.step()
    got, ref, start = flat(state.params), flat(jax.tree_util.tree_map(np.asarray, jp)), flat(params)
    for k, t in named_leaves(state.params):
        if t.requires_grad:
            assert ulps_apart(got[k], ref[k], start[k], moved[k]).max() <= ULPS, k


@pytest.mark.parametrize("fn,steps", [
    ("one_cycle", (0, 1, 37, 50, 99, 100, 150)), ("warmup", (0, 1, 150, 299, 300, 400))])
def test_schedules_match_jax(fn, steps):
    """The rates of one_cycle_cosine and warmup_wrap at rel 1e-6 (f32 cos)."""
    def build(m):
        sched = m.one_cycle_cosine(0.01, 0.1, 200)
        return sched if fn == "one_cycle" else m.warmup_wrap(sched, 300)

    js, ts = build(joptim), build(toptim)
    for t in steps:
        np.testing.assert_allclose(ts(t), float(js(jnp.asarray(t, jnp.int32))), rtol=1e-6,
                                   atol=1e-12, err_msg=str(t))
    if fn == "warmup":
        assert ts(0) == 0.0


def test_decay_mask_and_groups_match_jax(setup):
    """decay_mask over the training-form tree equals JAX's, and the
    optimizer's decayed group holds exactly those leaves."""
    s = setup
    ref = {k: bool(v) for k, v in flat(joptim.decay_mask(s["params"])).items()}
    params = from_jax_params(s["params"])
    got = {k: v for k, v in zip([k for k, _ in named_leaves(params)],
                                [bool(x) for x in _leaf_values(toptim.decay_mask(params))])}
    assert got == ref and any(got.values()) and not all(got.values())
    state = ttrain.make_yolo_train_state(params)
    decayed = {id(t) for t in state.opt.param_groups[0]["params"]}
    assert state.opt.param_groups[0]["weight_decay"] == 5e-4
    assert state.opt.param_groups[1]["weight_decay"] == 0.0
    assert {k for k, t in named_leaves(state.params) if id(t) in decayed} == \
        {k for k, v in ref.items() if v}


def _leaf_values(tree):
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in _leaf_values(v)]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in _leaf_values(v)]
    return [] if tree is None else [tree]


def test_ema_matches_jax():
    """Three ema_update calls with a decay that moves (tau 2): within 4 f32
    ulps of the largest value each element summed (XLA may fuse e d + p (1 -
    d) into an fma)."""
    rng = np.random.default_rng(17)
    p0 = {"a": rng.normal(size=(5, 3)).astype(np.float32), "bn": {"var": rng.uniform(
        0.5, 1.5, 7).astype(np.float32)}}
    news = [jax.tree_util.tree_map(lambda a: rng.normal(size=a.shape).astype(np.float32), p0)
            for _ in range(3)]
    je = joptim.ema_init(p0)
    te = toptim.ema_init(from_jax_params({"a": {"w": p0["a"]}, "bn": p0["bn"]}))
    for n in news:
        je = jax.jit(lambda e, n: joptim.ema_update(e, n, decay=0.9, tau=2.0))(je, n)
        te = toptim.ema_update(te, from_jax_params({"a": {"w": n["a"]}, "bn": n["bn"]}),
                               decay=0.9, tau=2.0)
    assert te.updates == int(je.updates) == 3
    for got, ref, key in ((te.params["a"]["w"], je.params["a"], ("a",)),
                          (te.params["bn"]["var"], je.params["bn"]["var"], ("bn", "var"))):
        mag = np.max([np.abs(_get(t, key)) for t in [p0] + news], axis=0)
        assert (np.abs(got.numpy() - np.asarray(ref)) <= 4 * np.spacing(mag)).all()


def _get(tree, key):
    for k in key:
        tree = tree[k]
    return tree


def test_two_train_steps_match_jax(setup):
    """Two whole steps against JAX's jitted step (the schedule's second
    update at full rate): the metrics at rel 1e-4; each leaf's move from the
    start, of the parameters and of the EMA, by relative norm at MODEL_REL
    (SGD's update is linear in the gradients) and the BN running stats by
    relative norm, both at MODEL_REL."""
    s = setup
    state = ttrain.make_yolo_train_state(from_jax_params(s["params"]), TOTAL)
    state.opt, state.sched = toptim.yolo_optimizer(state.params, total_steps=TOTAL,
                                                   warmup_steps=WARMUP)
    step = ttrain.make_yolo_train_step(s["tcfg"])
    batch = port_batch(s["batch"])
    for jstate, jmetrics in s["steps"]:
        metrics = step(state, batch)
        for k in ("loss", "box", "obj", "cls"):
            np.testing.assert_allclose(float(metrics[k]), float(jmetrics[k]), rtol=1e-4,
                                       err_msg=k)
    assert state.step == int(jstate.step) == 2 and state.ema.updates == 2
    start = flat(s["params"])
    for tree, jtree in ((state.params, jstate.params), (state.ema.params, jstate.ema.params)):
        got, ref = flat(tree), flat(jtree)
        assert got.keys() == ref.keys()
        for k in ref:
            if k.endswith(("/mean", "/var")):
                assert rel_err(got[k], ref[k]) < MODEL_REL, k
            else:
                assert rel_err(got[k] - start[k], ref[k] - start[k]) < MODEL_REL, k


def test_loss_falls_and_stats_move():
    """The port alone, as JAX's TestTrainStep: 4 steps on a fixed batch from
    a seeded init (the default schedule), the loss falls, the BN stats move,
    the EMA counts 4."""
    _, tcfg = configs()
    gen = torch.Generator().manual_seed(0)
    state = ttrain.init_yolo_train_state(gen, tcfg, 100)
    step = ttrain.make_yolo_train_step(tcfg)
    batch = ttrain.synthetic_yolo_batch(torch.Generator().manual_seed(1), 2, 64)
    mean0 = state.params["layers"][0]["bn"]["mean"].clone()
    losses = [float(step(state, batch)["loss"]) for _ in range(4)]
    assert all(np.isfinite(losses)) and losses[-1] < losses[0]
    assert state.step == 4 and state.ema.updates == 4
    assert (state.params["layers"][0]["bn"]["mean"] - mean0).abs().max() > 0


def test_map_hyp_matches_jax():
    """The reference's hyp.scratch.p5.yaml, written as a literal."""
    p5 = {"lr0": 0.01, "lrf": 0.1, "momentum": 0.937, "weight_decay": 0.0005,
          "warmup_epochs": 3.0, "warmup_momentum": 0.8, "warmup_bias_lr": 0.1, "box": 0.05,
          "cls": 0.3, "cls_pw": 1.0, "obj": 0.7, "obj_pw": 1.0, "iou_t": 0.2, "anchor_t": 4.0,
          "fl_gamma": 0.0, "hsv_h": 0.015, "hsv_s": 0.7, "hsv_v": 0.4, "degrees": 0.0,
          "translate": 0.2, "scale": 0.9, "shear": 0.0, "perspective": 0.0, "flipud": 0.0,
          "fliplr": 0.5, "mosaic": 1.0, "mixup": 0.15, "copy_paste": 0.0, "paste_in": 0.15,
          "loss_ota": 1}
    assert map_hyp(p5) == jmap_hyp(p5)
    opt, loss, data, extras = map_hyp(p5)
    assert opt == {"lr0": 0.01, "lrf": 0.1, "momentum": 0.937, "weight_decay": 0.0005}
    assert extras["_assigner"] == "simota" and data["mosaic"] is True


def test_train_state_reloads_bit_equal(tmp_path):
    """params, the momentum, the EMA and the step counts through
    save_checkpoint / load_checkpoint into a fresh state: bit-equal, the
    schedule moved on to the saved step."""
    _, tcfg = configs()
    gen = torch.Generator().manual_seed(3)
    state = ttrain.init_yolo_train_state(gen, tcfg, TOTAL, spec=MINI_SPEC)
    batch = ttrain.synthetic_yolo_batch(torch.Generator().manual_seed(4), 2, 64)
    ttrain.make_yolo_train_step(tcfg, MINI_SPEC)(state, batch)
    path = str(tmp_path / "ckpt_1.npz")
    ttrain.save_train_state(path, state)
    fresh = ttrain.load_train_state(path, ttrain.init_yolo_train_state(
        torch.Generator().manual_seed(5), tcfg, TOTAL, spec=MINI_SPEC))
    assert fresh.step == 1 and fresh.ema.updates == 1
    assert fresh.sched.last_epoch == 1
    assert [g["lr"] for g in fresh.opt.param_groups] == [g["lr"] for g in state.opt.param_groups]
    a, b = flat(ttrain.state_tree(state)), flat(ttrain.state_tree(fresh))
    assert a.keys() == b.keys()
    for k in a:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def test_mini_spec_forward_and_gradients_match_jax():
    """MINI_SPEC's training forward (RepConv with its identity branch,
    SPPCSPC, DET) at rel 1e-4 by norm, its new stats and the loss's
    gradient of every trained leaf at MODEL_REL."""
    jcfg, tcfg = configs()
    params = jax.tree_util.tree_map(np.asarray, numpy_params(
        lambda k: JY.init_yolov7(k, jcfg, deploy=False, spec=MINI_SPEC), 18))
    assert "id_bn" in params["layers"][3]
    rng = np.random.default_rng(19)
    img, targets = rng.uniform(size=(B, 64, 64, 3)).astype(np.float32), numpy_targets(rng)

    def loss_fn(p):
        maps, stats = JY.yolov7_train_forward(p, jnp.asarray(img), jcfg, spec=MINI_SPEC)
        out = jlosses.yolo_loss(maps, jnp.asarray(targets), jnp.asarray(ANCHORS), STRIDES, 3)
        return out["loss"], (maps, stats)

    (loss, (jmaps, jstats)), jg = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(params)
    state = ttrain.make_yolo_train_state(from_jax_params(params))
    maps, stats = TY.yolov7_train_forward(state.params, torch.from_numpy(img), tcfg, MINI_SPEC)
    out = tlosses.yolo_loss(maps, torch.from_numpy(targets), torch.from_numpy(ANCHORS),
                            STRIDES, 3)
    np.testing.assert_allclose(float(out["loss"].detach()), float(loss), rtol=1e-5)
    for got, ref in zip(maps, jmaps):
        assert rel_err(got.detach().numpy().astype(np.float64), np.asarray(ref)) < 1e-4
    got_s, ref_s = flat(stats), flat(jstats)
    for k in ref_s:
        if k.endswith(("/mean", "/var")):
            assert rel_err(got_s[k], ref_s[k]) < MODEL_REL, k
    leaves = [(k, t) for k, t in named_leaves(state.params) if t.requires_grad]
    grads = torch.autograd.grad(out["loss"], [t for _, t in leaves])
    ref = flat(jg)
    for (k, _), g in zip(leaves, grads):
        assert rel_err(to_jax_layout(g).astype(np.float64), ref[k]) < MODEL_REL, k


def test_bridge_maps_the_training_form(setup):
    """Every leaf of JAX's training-form tree has a rule (conv OIHW, BN
    vectors, RepConv's branches), and the port's init has the same tree."""
    s = setup
    port = from_jax_params(s["params"])
    ref = flat(s["params"])
    assert flat(port).keys() == ref.keys()
    mine = TY.init_yolov7(torch.Generator().manual_seed(0), s["tcfg"], deploy=False)
    assert {k: v.shape for k, v in flat(mine).items()} == {k: v.shape for k, v in ref.items()}
    assert "id_bn" not in port["layers"][102] and "dense_bn" in port["layers"][102]


@pytest.mark.parametrize("what", ["simota", "aux", "bin", "variant"])
def test_what_is_not_ported_raises(what):
    """What neither package trains raises: an assigner other than neighbor
    and simota; a training form of the IBin head (JAX's training forward
    has none: IBin's loss is taken on raw maps) or of a variant layer; the
    IBin loss under the neighbor assigner (the reference has only
    ComputeLossBinOTA). SimOTA, the auxiliary heads and IBin's loss are
    ported since: tests/test_torch_simota.py."""
    maps, targets = _loss_cases()["random"]
    args = ([torch.from_numpy(m) for m in maps], torch.from_numpy(targets),
            torch.from_numpy(ANCHORS), STRIDES, 3)
    if what in ("variant", "aux"):
        spec = ([(-1, "C", (8, 3, 1)), (-1, "GHOST", (8, 3, 1))] if what == "variant" else
                [(-1, "C", (8, 3, 2)), (-1, "C", (16, 3, 2)), ((0, 1), "BIN", ())])
        with pytest.raises(ValueError, match="no training form"):
            TY.init_yolov7(torch.Generator().manual_seed(0), configs()[1], spec, deploy=False)
        return
    kw = {"simota": {"assigner": "hungarian"}, "bin": {"head": "bin"}}[what]
    with pytest.raises(ValueError, match="assigner" if what == "simota" else "OTA"):
        tlosses.yolo_loss(*args, **kw)


def test_inference_forward_of_the_training_form_matches_jax():
    """The plain forward (BN by running stats, RepConv's three branches) of
    a training-form tree, as an EMA is evaluated, against JAX's
    yolov7_backbone_forward on the same tree, at rel 1e-5 by norm."""
    jcfg, tcfg = configs()
    params = jax.tree_util.tree_map(np.asarray, numpy_params(
        lambda k: JY.init_yolov7(k, jcfg, deploy=False, spec=MINI_SPEC), 20))
    img = np.random.default_rng(21).uniform(size=(B, 64, 64, 3)).astype(np.float32)
    ref = jax.jit(lambda p, x: JY.yolov7_backbone_forward(p, x, jcfg, spec=MINI_SPEC))(
        params, jnp.asarray(img))
    got = TY.yolov7_backbone_forward(from_jax_params(params), torch.from_numpy(img), tcfg,
                                     MINI_SPEC)
    for g, r in zip(got, ref):
        assert rel_err(g.numpy().astype(np.float64), np.asarray(r)) < 1e-5


def test_hyp_drives_the_train_step():
    """map_hyp's optimizer and loss kwargs into the train state and the step
    (P5's gains, a 4-step schedule) against JAX's same step on MINI_SPEC:
    the losses at rel 1e-4, every parameter's move at MODEL_REL."""
    p5 = {"lr0": 0.02, "lrf": 0.2, "momentum": 0.9, "weight_decay": 0.001, "box": 0.1,
          "cls": 0.5, "obj": 1.0, "anchor_t": 3.0}
    opt, loss, _, _ = map_hyp(p5)
    jcfg, tcfg = configs()
    params = jax.tree_util.tree_map(np.asarray, numpy_params(
        lambda k: JY.init_yolov7(k, jcfg, deploy=False, spec=MINI_SPEC), 22))
    rng = np.random.default_rng(23)
    batch = {"img": rng.uniform(size=(B, 64, 64, 3)).astype(np.float32),
             "targets": numpy_targets(rng)}
    tx = joptim.yolo_optimizer(params, total_steps=4, warmup_steps=0, **opt)
    jstate = jtrain.YoloTrainState(params, tx.init(params), joptim.ema_init(params),
                                   jnp.zeros((), jnp.int32))
    jstep = jax.jit(jtrain.make_yolo_train_step(jcfg, tx, spec=MINI_SPEC, loss_kwargs=loss))
    state = ttrain.make_yolo_train_state(from_jax_params(params), 4, opt_kwargs=opt)
    state.opt, state.sched = toptim.yolo_optimizer(state.params, total_steps=4, warmup_steps=0,
                                                   **opt)
    step = ttrain.make_yolo_train_step(tcfg, MINI_SPEC, loss_kwargs=loss)
    for _ in range(2):
        jstate, jm = jstep(jstate, {k: jnp.asarray(v) for k, v in batch.items()})
        m = step(state, port_batch(batch))
        np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]), rtol=1e-4)
    assert [g["weight_decay"] for g in state.opt.param_groups] == [0.001, 0.0]
    got, ref, start = flat(state.params), flat(jstate.params), flat(params)
    for k in ref:
        if not k.endswith(("/mean", "/var")):
            assert rel_err(got[k] - start[k], ref[k] - start[k]) < MODEL_REL, k


def test_f32_gradient_sits_within_half_the_limit_of_f64(setup):
    """The conditioning MODEL_REL rests on: the port's f32 gradient of the
    fixture's loss against its own f64 gradient (every op in f64), each
    trained leaf within MODEL_REL / 2, which leaves JAX's f32 rounding the
    other half."""
    from hamer_yolo_tpu_torch.training.optim import map_tree

    s = setup
    grads = {}
    for dtype in (torch.float32, torch.float64):
        cfg = TY.YoloConfig(nc=3, img_size=64, compute_dtype=str(dtype).split(".")[1])
        params = map_tree(lambda t: t.to(dtype).requires_grad_(True), from_jax_params(s["params"]))
        maps, _ = TY.yolov7_train_forward(params, torch.from_numpy(s["batch"]["img"]).to(dtype),
                                          cfg)
        out = tlosses.yolo_loss(maps, torch.from_numpy(s["batch"]["targets"]).to(dtype),
                                torch.from_numpy(ANCHORS).to(dtype), STRIDES, 3)
        leaves = [(k, t) for k, t in named_leaves(params) if not k.endswith(("/mean", "/var"))]
        g = torch.autograd.grad(out["loss"], [t for _, t in leaves])
        grads[dtype] = {k: v.double() for (k, _), v in zip(leaves, g)}
    worst = max((float((grads[torch.float32][k] - v).norm() / v.norm()), k)
                for k, v in grads[torch.float64].items())
    assert worst[0] < MODEL_REL / 2, worst
