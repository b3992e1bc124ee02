"""KPFusion RGB-D's train step (hamer_yolo_tpu_torch/training/
train_kpfusion_rgbd.py) and tools/train_kpfusion_rgbd against the JAX
package's on the same numpy-made weights and batch, at the JAX tool's --tiny
config (32 x 32 crops, 8 x 8 feature maps, dim 32, 64 points, one stage;
the UNets are ResNet-18 whatever the config).

Weights follow the JAX initialisers' distributions (test_torch_bridge.
numpy_params); each BN's running variance is then set to its input's mean
square by one port forward (test_torch_state_dicts.calibrating_batch_norm),
so activations stay O(1). Tolerances, stated at each test: the loss terms at
rel 1e-5 (the JAX package's tests/test_primary_losses.py) on the same
forward outputs, AdamW by f32 ulps plus ADAM_REL of the updates' reach
(test_torch_train_hamer's rule: optax's bias correction is float32), and
gradients by each leaf's relative norm error at GRAD_REL: the DESA
grouping, the BERT attention and the GAM gate's scalar logit make them
ill-conditioned; test_f32_gradient_sits_within_half_the_limit_of_f64 holds
the port's f32 gradient within half of it from its own f64 one, the other
half is JAX's f32 rounding of the same kind.
"""
import json
import os

import numpy as np
import optax
import pytest
import torch

import jax
import jax.numpy as jnp

from hamer_yolo_tpu.models.kpfusion_rgbd import model as JM
from hamer_yolo_tpu.training import train_kpfusion_rgbd as jtrain
from hamer_yolo_tpu_torch.core.bridge import from_jax_params, to_jax_layout
from hamer_yolo_tpu_torch.models.kpfusion_rgbd import model as TM
from hamer_yolo_tpu_torch.tools import train_kpfusion_rgbd as tool
from hamer_yolo_tpu_torch.training import train_kpfusion_rgbd as ttrain
from hamer_yolo_tpu_torch.training.optim import named_leaves
from test_torch_bridge import numpy_params
from test_torch_state_dicts import calibrating_batch_norm
from test_torch_train_hamer import ULPS, flat, rel_err, ulps_apart

torch.set_num_threads(1)

B = 2
LR = 8e-4
GRAD_REL = 1e-2    # per leaf: |g - g_jax| / |g_jax| (module docstring)
UPDATE_REL = 2e-2  # per leaf after two AdamW steps: |move - move_jax| / |move_jax|
GRAD_FLOOR = 5e-2  # whole steps: elements with 0 < |g| below this share of the leaf's max left out


def shift_invariant(path):
    """A bias that a softmax cancels: the UNets' weight heads' (a softmax
    over pixels takes their logits) and BERT's key biases (one softmax over
    keys per query). Its gradient is 0 in exact arithmetic and rounding
    noise in either package: held below 1e-4 of its weight's."""
    return path.endswith(("finals/2/b", "/k/b"))


def jax_tiny():
    return JM.KPFusionConfig(img_size=32, feature_size=8, dim=32, sample_num=64, num_stages=1,
                             heads=2)


def port_batch(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


@pytest.fixture(scope="module")
def setup():
    """Calibrated weights, a batch, JAX's loss terms and gradients at epoch 0
    and past the spatial gate (one jitted value_and_grad, the epoch an
    argument), and two JAX train steps under a staircase that decays at the
    second: make_train_step's body (value_and_grad, tx.update,
    apply_updates), its value_and_grad the same jitted one, so that the
    model's forward and backward compile once."""
    jcfg, tcfg = jax_tiny(), tool.tiny_config()
    batch = ttrain.synthetic_rgbd_batch(np.random.default_rng(21), B, tcfg)
    port = from_jax_params(jax.tree_util.tree_map(
        np.asarray, numpy_params(lambda k: JM.init_kpfusion(k, jcfg), 22)))
    with torch.no_grad(), calibrating_batch_norm():
        ttrain.kpfusion_rgbd_loss(port, port_batch(batch), tcfg)
    params = to_jax_layout(port)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}

    def loss_and_grads(p, b, epoch):
        return jax.value_and_grad(jtrain.kpfusion_rgbd_loss, has_aux=True)(p, b, jcfg, epoch)

    fn = jax.jit(loss_and_grads)
    at = {e: fn(params, jbatch, jnp.asarray(e, jnp.int32)) for e in (0, 30)}
    tx = jtrain.make_optimizer(LR, steps_per_epoch=1, step_size_epochs=1)

    @jax.jit
    def update(grads, opt_state, p):
        updates, opt_state = tx.update(grads, opt_state, p)
        return optax.apply_updates(p, updates), opt_state

    p, st, steps = params, tx.init(params), []
    for _ in range(2):
        (_, metrics), grads = fn(p, jbatch, jnp.asarray(0, jnp.int32))
        p, st = update(grads, st, p)
        steps.append((jax.tree_util.tree_map(np.asarray, p), metrics))
    return dict(jcfg=jcfg, tcfg=tcfg, params=params, batch=batch, at=at, steps=steps)


def test_smooth_l1_matches_jax():
    """Both branches (|z| around the 0.01 knee) and exact zeros: the value
    at rel 1e-5, the gradient at GRAD_REL."""
    rng = np.random.default_rng(23)
    x = (0.02 * rng.normal(size=(3, 21, 3))).astype(np.float32)
    y = (0.02 * rng.normal(size=(3, 21, 3))).astype(np.float32)
    y[0, :4] = x[0, :4]
    ref, gref = jax.value_and_grad(jtrain.smooth_l1)(jnp.asarray(x), jnp.asarray(y))
    xt = torch.from_numpy(x).requires_grad_(True)
    got = ttrain.smooth_l1(xt, torch.from_numpy(y))
    got.backward()
    np.testing.assert_allclose(float(got.detach()), float(ref), rtol=1e-5)
    assert rel_err(xt.grad.numpy(), np.asarray(gref)) < GRAD_REL


@pytest.mark.parametrize("epoch", [0, 30], ids=["epoch0", "past_gate"])
def test_loss_terms_match_jax(setup, epoch, monkeypatch):
    """Every term (pixel and coord of both UNets, each KFAM's coord, the
    spatial weights) and the total, at rel 1e-5 on the same forward outputs
    (JAX's loss handed the port forward's), and end to end at the full
    forward's limit (rtol 1e-3, tests/test_kpfusion_rgbd.py's); past
    SPATIAL_EPOCH the spatial term is 0."""
    s = setup
    batch = port_batch(s["batch"])
    with torch.no_grad():
        out = TM.kpfusion_forward(from_jax_params(s["params"]), batch["img_rgb"], batch["img"],
                                  batch["pcl"], batch["center"], batch["M"], batch["cube"],
                                  batch["cam_para"], s["tcfg"])
    _, metrics = ttrain.loss_terms(out, batch, s["tcfg"], epoch)
    jout = jax.tree_util.tree_map(lambda t: jnp.asarray(t.numpy()), out)
    monkeypatch.setattr(jtrain, "kpfusion_forward", lambda *a, **k: jout)
    _, jmetrics = jtrain.kpfusion_rgbd_loss(None, {k: jnp.asarray(v) for k, v in
                                                   s["batch"].items()}, s["jcfg"], epoch)
    assert metrics.keys() == jmetrics.keys()
    for k in metrics:
        np.testing.assert_allclose(float(metrics[k]), float(jmetrics[k]), rtol=1e-5, atol=1e-7,
                                   err_msg=k)
    _, e2e = ttrain.kpfusion_rgbd_loss(from_jax_params(s["params"]), batch, s["tcfg"], epoch)
    (_, ref), _ = s["at"][epoch]
    for k in e2e:
        np.testing.assert_allclose(float(e2e[k].detach()), float(ref[k]), rtol=1e-3, err_msg=k)
    assert (float(metrics["spatial_0"]) == 0.0) == (epoch > ttrain.SPATIAL_EPOCH)


@pytest.mark.parametrize("epoch", [0, 30], ids=["epoch0", "past_gate"])
def test_gradients_match_jax(setup, epoch):
    """Every leaf's gradient, the BN running stats' included (JAX trains
    them), at GRAD_REL; the shift_invariant leaves' below 1e-4 of their
    weights' in both packages."""
    s = setup
    state = ttrain.make_train_state(from_jax_params(s["params"]))
    leaves = named_leaves(state.params)
    loss, _ = ttrain.kpfusion_rgbd_loss(state.params, port_batch(s["batch"]), s["tcfg"], epoch)
    grads = torch.autograd.grad(loss, [t for _, t in leaves], allow_unused=True,
                                materialize_grads=True)
    ref = flat(s["at"][epoch][1])
    assert {k for k, _ in leaves} == ref.keys()
    got = {k: to_jax_layout(g).astype(np.float64) for (k, _), g in zip(leaves, grads)}
    for k in ref:
        if shift_invariant(k):
            w = k[:-1] + "w"
            for tree in (got, ref):
                assert np.linalg.norm(tree[k]) < 1e-4 * np.linalg.norm(tree[w]), k
        else:
            assert rel_err(got[k], ref[k]) < GRAD_REL, k


def test_adamw_schedule_matches_optax():
    """make_optimizer alone: the same gradients for 3 steps under a staircase
    that decays after each step, into optax's and the port's: every
    parameter within ULPS ulps plus ADAM_REL of the updates' reach."""
    rng = np.random.default_rng(24)
    tree = {"conv": {"w": rng.normal(size=(3, 3, 4, 8)).astype(np.float32),
                     "b": (0.1 * rng.normal(size=8)).astype(np.float32)},
            "bn": {"mean": (0.1 * rng.normal(size=8)).astype(np.float32),
                   "var": rng.uniform(0.5, 1.5, 8).astype(np.float32)}}
    grads = [jax.tree_util.tree_map(
        lambda a: (rng.normal(size=a.shape) * 10.0 ** rng.uniform(-2, 1)).astype(np.float32),
        tree) for _ in range(3)]
    tx = jtrain.make_optimizer(LR, steps_per_epoch=1, step_size_epochs=1)
    jp, jst = tree, tx.init(tree)
    for g in grads:
        upd, jst = jax.jit(tx.update)(g, jst, jp)
        jp = optax.apply_updates(jp, upd)
    state = ttrain.make_train_state(from_jax_params(tree), LR)
    state.opt, state.sched = ttrain.make_optimizer(state.params, LR, 1, 1)
    rates = []
    for g in grads:
        gt = dict(named_leaves(from_jax_params(g)))
        for k, t in named_leaves(state.params):
            t.grad = gt[k]
        rates.append(state.opt.param_groups[0]["lr"])
        state.opt.step()
        state.sched.step()
    np.testing.assert_allclose(rates, [LR, LR * 0.1, LR * 0.01], rtol=1e-6)
    got, ref, start = flat(state.params), flat(jax.tree_util.tree_map(np.asarray, jp)), flat(tree)
    for k in ref:
        assert ulps_apart(got[k], ref[k], start[k], LR, 3).max() <= ULPS, k


def test_two_train_steps_match_jax(setup):
    """Two whole steps against JAX's (the fixture's): the metrics at rel 1e-4;
    each leaf's move from its start by relative norm at UPDATE_REL (Adam's
    update is the ratio of two moments of gradients that are only held at
    GRAD_REL), elements whose gradient in either step is nonzero but below
    GRAD_FLOOR of their leaf's largest, and the shift_invariant biases (Adam
    steps them by lr sign(rounding noise)), left out."""
    s = setup
    state = ttrain.make_train_state(from_jax_params(s["params"]), LR)
    state.opt, state.sched = ttrain.make_optimizer(state.params, LR, 1, 1)
    batch = port_batch(s["batch"])
    small = {}
    for p_ref, jmetrics in s["steps"]:
        metrics = ttrain.train_step(state, batch, s["tcfg"], 0)
        assert metrics.keys() == jmetrics.keys()
        for k in metrics:
            np.testing.assert_allclose(float(metrics[k]), float(jmetrics[k]), rtol=1e-4,
                                       atol=1e-7, err_msg=k)
        for k, t in named_leaves(state.params):
            g = np.abs(to_jax_layout(t.grad))
            low = (g > 0) & (g < GRAD_FLOOR * g.max())
            if k.endswith("in_proj_b"):  # the fused q, k, v bias: its key third
                low[g.size // 3:2 * (g.size // 3)] = True
            small[k] = small.get(k, low) | low
    got, ref, start = flat(state.params), flat(p_ref), flat(s["params"])
    assert state.step == 2
    for k in ref:
        if not shift_invariant(k):
            keep = ~small[k]
            assert rel_err((got[k] - start[k])[keep], (ref[k] - start[k])[keep]) < UPDATE_REL, k


def test_train_state_reloads_bit_equal(setup, tmp_path):
    s = setup
    state = ttrain.make_train_state(from_jax_params(s["params"]), LR)
    ttrain.train_step(state, port_batch(s["batch"]), s["tcfg"])
    path = str(tmp_path / "ckpt_1.npz")
    ttrain.save_train_state(path, state)
    fresh = ttrain.load_train_state(path, ttrain.make_train_state(from_jax_params(s["params"]),
                                                                  LR))
    assert fresh.step == 1 and fresh.sched.last_epoch == 1
    a, b = flat(ttrain.state_tree(state)), flat(ttrain.state_tree(fresh))
    assert a.keys() == b.keys()
    for k in a:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def test_tool_runs_checkpoints_and_resumes(setup, tmp_path, capsys):
    """tools/train_kpfusion_rgbd --tiny on the CPU: 3 steps logged each and
    checkpointed at step 2, then --resume auto for one more; metrics.jsonl's
    keys are those JAX's tool writes (its step's metrics, "step", "time")."""
    out = str(tmp_path / "run")
    assert tool.main(["--tiny", "--steps", "3", "--batch", "1", "--log-every", "1",
                      "--ckpt-every", "2", "--device", "cpu", "--out", out]) == 0
    assert sorted(os.listdir(out)) == ["ckpt_2.npz", "ckpt_final.npz", "metrics.jsonl"]
    assert tool.main(["--tiny", "--steps", "4", "--batch", "1", "--log-every", "1",
                      "--resume", "auto", "--device", "cpu", "--out", out]) == 0
    assert "at step 3" in capsys.readouterr().out
    with open(os.path.join(out, "metrics.jsonl")) as f:
        recs = [json.loads(line) for line in f]
    assert [r["step"] for r in recs] == [0, 1, 2, 3]
    for r in recs:
        assert set(r) == {"step", "time"} | set(setup["steps"][0][1])
        assert all(np.isfinite(v) for v in r.values())


@pytest.mark.parametrize("flags,error", [
    (["--data", "d"], FileNotFoundError), (["--augment", "--data", "d"], FileNotFoundError),
    (["--devices", "2"], SystemExit)], ids=["data", "augment", "devices"])
def test_tool_refuses_what_is_not_ported(flags, error, tmp_path):
    """--data (with or without --augment) on a folder without samples raises
    naming it; --devices 2 in a process group of one exits."""
    with pytest.raises(error):
        tool.main(["--tiny", "--device", "cpu", "--out", str(tmp_path)] + flags)


def test_f32_gradient_sits_within_half_the_limit_of_f64(setup):
    """The conditioning GRAD_REL rests on: the port's f32 gradient of the
    fixture's loss against its own f64 gradient, each leaf but the
    shift_invariant ones within GRAD_REL / 2, which leaves JAX's f32
    rounding the other half."""
    from hamer_yolo_tpu_torch.training.optim import map_tree

    s = setup
    grads = {}
    for dtype in (torch.float32, torch.float64):
        params = map_tree(lambda t: t.to(dtype).requires_grad_(True), from_jax_params(s["params"]))
        batch = {k: v.to(dtype) for k, v in port_batch(s["batch"]).items()}
        loss, _ = ttrain.kpfusion_rgbd_loss(params, batch, s["tcfg"], 0)
        leaves = named_leaves(params)
        g = torch.autograd.grad(loss, [t for _, t in leaves], allow_unused=True,
                                materialize_grads=True)
        grads[dtype] = {k: v.double() for (k, _), v in zip(leaves, g)}
    worst = max((float((grads[torch.float32][k] - v).norm() / v.norm()), k)
                for k, v in grads[torch.float64].items() if not shift_invariant(k))
    assert worst[0] < GRAD_REL / 2, worst
