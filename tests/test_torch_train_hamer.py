"""HaMeR's adversarial train step (hamer_yolo_tpu_torch/training/train_hamer.py),
the discriminator, the HaMeR losses and tools/train_hamer against the JAX
package's on the same numpy-made weights and batch, at the JAX tool's --tiny
config (f32 ViT of 2 blocks of 64, a 2-layer MANO head); and every kernel
wrapper's refusal of an input that requires grad.

Tolerances, stated at each test: losses at rel 1e-5 (the JAX package's
tests/test_primary_losses.py), gradients by the relative norm error of each
leaf, the optimizers by f32 ulps of each parameter's magnitude plus
ADAM_REL of the distance the updates may move it: the port's AdamW is
optax's form op for op (bias corrections in float32), where XLA fuses the
moment updates of jitted optax into fused multiply-adds (2e-5 of lr a step
while the port took torch's AdamW, whose float64 bias correction was
1.3e-5 off at t = 1). Adam's first update is about
lr sign(g), so an element whose gradient is near 0 can step either way in
either package: the whole-step comparisons leave out the elements whose
gradient is below GRAD_FLOOR of their leaf's largest.
"""
import json
import os

import numpy as np
import optax
import pytest
import torch

import jax
import jax.numpy as jnp

from hamer_yolo_tpu.models.discriminator import discriminator_forward as jdisc_fwd
from hamer_yolo_tpu.models.discriminator import init_discriminator as jinit_disc
from hamer_yolo_tpu.models.hamer import HamerConfig as JH
from hamer_yolo_tpu.models.hamer import init_hamer as jinit_hamer
from hamer_yolo_tpu.models.mano_head import ManoHeadConfig as JM
from hamer_yolo_tpu.models.vit import ViTConfig as JV
from hamer_yolo_tpu.training import losses as jlosses
from hamer_yolo_tpu.training import train_hamer as jtrain
from hamer_yolo_tpu_torch.core.bridge import from_jax_params, to_jax_layout
from hamer_yolo_tpu_torch.models.discriminator import discriminator_forward
from hamer_yolo_tpu_torch.tools import train_hamer as tool
from hamer_yolo_tpu_torch.training import losses as tlosses
from hamer_yolo_tpu_torch.training import train_hamer as ttrain
from hamer_yolo_tpu_torch.training.optim import named_leaves
from test_torch_bridge import jax_exact, mano_pair, numpy_params

torch.set_num_threads(1)

B = 2
LR = 1e-4
GRAD_REL = 2e-4     # per leaf: |g - g_jax| / |g_jax| (f32 sums in other orders)
ULPS = 4            # optimizer updates: f32 ulps of max(|p_jax|, |p_start|, lr)
ADAM_REL = 5e-6     # ... plus this share of lr per step (jitted optax's fused moments)
GRAD_FLOOR = 5e-2   # whole steps: elements with 0 < |g| below this share of the leaf's max left out


def jax_tiny():
    return JH(image_size=64, crop_margin=8,
              vit=JV(img_size=(64, 48), embed_dim=64, depth=2, num_heads=4,
                     compute_dtype="float32"),
              head=JM(dim=32, context_dim=64, depth=2, heads=2, dim_head=8, mlp_dim=32))


def flat(tree, path=()):
    """{path: numpy array} of a tree of JAX arrays, numpy arrays or tensors
    (tensors mapped to JAX layout first)."""
    if isinstance(tree, dict):
        return {k: v for key, sub in tree.items() for k, v in flat(sub, path + (str(key),)).items()}
    if isinstance(tree, (list, tuple)):
        return {k: v for i, sub in enumerate(tree) for k, v in flat(sub, path + (str(i),)).items()}
    if tree is None:
        return {}
    return {"/".join(path): np.asarray(to_jax_layout(tree) if isinstance(tree, torch.Tensor)
                                       else tree, np.float64)}


def rel_err(a, b):
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def ulps_apart(got, ref, start, lr, steps):
    """|got - ref|, less ADAM_REL of the ``steps`` updates' reach (steps lr),
    in f32 ulps of the magnitude of what the updates summed: max(|ref|,
    |start|, lr), elementwise (a parameter that an update moved to near 0 is
    as far off as the update's rounding, not its own)."""
    mag = np.maximum(np.maximum(np.abs(ref), np.abs(start)), lr).astype(np.float32)
    return np.maximum(np.abs(got - ref) - ADAM_REL * steps * lr, 0) / np.spacing(mag)


def numpy_batch(seed, cfg):
    """JAX's synthetic_batch schema, drawn with numpy."""
    rng = np.random.default_rng(seed)
    eye = np.broadcast_to(np.eye(3, dtype=np.float32), (B, 15, 3, 3)).copy()
    kp2d = rng.normal(size=(B, 21, 3)).astype(np.float32)
    kp2d[..., 2] = rng.uniform(size=(B, 21))
    kp3d = rng.normal(size=(B, 21, 4)).astype(np.float32)
    kp3d[..., 3] = rng.uniform(size=(B, 21))
    return {"img": rng.normal(size=(B, cfg.image_size, cfg.image_size, 3)).astype(np.float32),
            "keypoints_2d": kp2d, "keypoints_3d": kp3d,
            "mano_global_orient": np.broadcast_to(np.eye(3, dtype=np.float32),
                                                  (B, 1, 3, 3)).copy(),
            "mano_hand_pose": eye, "mano_betas": (0.1 * rng.normal(size=(B, 10))).astype(np.float32),
            "has_mano_params": np.array([1.0, 0.0], np.float32),
            "mocap_hand_pose": eye.copy(),
            "mocap_betas": (0.1 * rng.normal(size=(B, 10))).astype(np.float32)}


@pytest.fixture(scope="module")
def setup():
    """Weights, batch, and the JAX side's values: the loss, its terms and
    its gradient (one jitted value_and_grad) and two jitted train steps."""
    jcfg, tcfg = jax_tiny(), tool.tiny_config()
    jmano, tmano = mano_pair()
    params = jax.tree_util.tree_map(np.asarray, numpy_params(lambda k: jinit_hamer(k, jcfg), 1))
    disc = jax.tree_util.tree_map(np.asarray, numpy_params(jinit_disc, 2))
    batch = numpy_batch(3, jcfg)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}

    def loss_and_grads(p, d, b):
        return jax.value_and_grad(jtrain.hamer_loss_fn, argnums=(0, 1), has_aux=True)(
            p, d, jmano, b, jcfg)

    (total, aux), (g_gen, g_disc) = jax_exact(loss_and_grads, params, disc, jbatch)
    gen_tx, disc_tx = jtrain.make_optimizers(LR)
    state = jtrain.HamerTrainState(params, gen_tx.init(params), disc, disc_tx.init(disc),
                                   jnp.zeros((), jnp.int32))
    step = jax.jit(jtrain.make_train_step(jmano, jcfg, gen_tx, disc_tx))
    steps = []
    for _ in range(2):
        state, metrics = step(state, jbatch)
        steps.append((jax.tree_util.tree_map(np.asarray, state), metrics))
    return dict(jcfg=jcfg, tcfg=tcfg, jmano=jmano, tmano=tmano, params=params, disc=disc,
                batch=batch, total=total, aux=aux, g_gen=g_gen, g_disc=g_disc, steps=steps)


def port_batch(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def test_loss_terms_match_jax(setup):
    """Each HaMeR loss term and the total at rel 1e-5."""
    s = setup
    total, aux = ttrain.hamer_loss_fn(from_jax_params(s["params"]), from_jax_params(s["disc"]),
                                      s["tmano"], port_batch(s["batch"]), s["tcfg"])
    for k in tlosses.HAMER_LOSS_WEIGHTS:
        np.testing.assert_allclose(float(aux[k]), float(s["aux"][k]), rtol=1e-5, err_msg=k)
    np.testing.assert_allclose(float(total), float(s["total"]), rtol=1e-5)


def test_discriminator_and_adversarial_losses_match_jax():
    """The (B, 17) logits at rel 1e-5 (atol 1e-6 for logits near 0), and both
    LSGAN losses at rel 1e-5."""
    disc = jax.tree_util.tree_map(np.asarray, numpy_params(jinit_disc, 4))
    rng = np.random.default_rng(5)
    pose = rng.normal(size=(3, 15, 3, 3)).astype(np.float32)
    betas = rng.normal(size=(3, 10)).astype(np.float32)
    ref = np.asarray(jax.jit(jdisc_fwd)(disc, jnp.asarray(pose), jnp.asarray(betas)))
    got = discriminator_forward(from_jax_params(disc), torch.from_numpy(pose),
                                torch.from_numpy(betas)).numpy()
    assert got.shape == (3, 17)
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-6)
    real = rng.normal(size=(3, 17)).astype(np.float32)
    np.testing.assert_allclose(
        float(tlosses.adversarial_disc_loss(torch.from_numpy(real), torch.from_numpy(got))),
        float(jlosses.adversarial_disc_loss(jnp.asarray(real), jnp.asarray(ref))), rtol=1e-5)
    np.testing.assert_allclose(float(tlosses.adversarial_gen_loss(torch.from_numpy(got))),
                               float(jlosses.adversarial_gen_loss(jnp.asarray(ref))), rtol=1e-5)


@pytest.mark.parametrize("which", ["keypoint_2d", "keypoint_3d", "parameter"])
def test_keypoint_and_parameter_losses_match_jax(which):
    """Values at rel 1e-5 and gradients at GRAD_REL, with exact zeros in the
    differences (jnp.abs's gradient at 0 is 1)."""
    rng = np.random.default_rng(6)
    pred = rng.normal(size=(3, 21, 3)).astype(np.float32)
    gt = rng.normal(size=(3, 21, 4)).astype(np.float32)
    gt[0, 1, :3] = pred[0, 1] - pred[0, 0] + gt[0, 0, :3]   # a root-relative zero
    gt[1, 2, :2] = pred[1, 2, :2]                          # a 2D zero
    has = np.array([1.0, 0.0, 1.0], np.float32)
    fns = {"keypoint_2d": (lambda m, p, g: m.keypoint_2d_loss(p[..., :2], g[..., :3])),
           "keypoint_3d": (lambda m, p, g: m.keypoint_3d_loss(p, g)),
           "parameter": (lambda m, p, g, h=None: m.parameter_loss(p, g[..., :3], h))}
    if which == "parameter":
        jf = lambda p: jlosses.parameter_loss(p, jnp.asarray(gt[..., :3]), jnp.asarray(has))
        tf = lambda p: tlosses.parameter_loss(p, torch.from_numpy(gt[..., :3]),
                                              torch.from_numpy(has))
    else:
        jf = lambda p: fns[which](jlosses, p, jnp.asarray(gt))
        tf = lambda p: fns[which](tlosses, p, torch.from_numpy(gt))
    ref, gref = jax.value_and_grad(jf)(jnp.asarray(pred))
    p = torch.from_numpy(pred).requires_grad_(True)
    got = tf(p)
    got.backward()
    np.testing.assert_allclose(float(got.detach()), float(ref), rtol=1e-5)
    assert rel_err(p.grad.numpy(), np.asarray(gref)) < GRAD_REL


def test_gradients_match_jax(setup):
    """Every leaf's gradient of the generator's loss, over HaMeR's leaves and
    the discriminator's, by its relative norm error, at GRAD_REL."""
    s = setup
    state = ttrain.make_train_state(from_jax_params(s["params"]), from_jax_params(s["disc"]))
    gen = [t for _, t in named_leaves(state.params)]
    disc = [t for _, t in named_leaves(state.disc_params)]
    total, _ = ttrain.hamer_loss_fn(state.params, state.disc_params, s["tmano"],
                                    port_batch(s["batch"]), ttrain.train_config(s["tcfg"]))
    grads = torch.autograd.grad(total, gen + disc)
    for tree, values, ref_tree in ((state.params, grads[:len(gen)], s["g_gen"]),
                                   (state.disc_params, grads[len(gen):], s["g_disc"])):
        got, ref = flat(_tree_like(tree, values)), flat(ref_tree)
        assert got.keys() == ref.keys()
        worst = max((rel_err(got[k], ref[k]), k) for k in ref)
        assert worst[0] < GRAD_REL, worst


def _tree_like(tree, values):
    it = iter(values)

    def fill(node):
        if isinstance(node, dict):
            return {k: fill(v) for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            return [fill(v) for v in node]
        return None if node is None else next(it)

    return fill(tree)


def test_adamw_matches_optax():
    """The train state's AdamW against optax.adamw on the same
    gradients for 3 steps: every parameter within ULPS f32 ulps."""
    disc = jax.tree_util.tree_map(np.asarray, numpy_params(jinit_disc, 7))
    rng = np.random.default_rng(8)
    grads = [jax.tree_util.tree_map(
        lambda a: (rng.normal(size=a.shape) * 10.0 ** rng.uniform(-3, 1)).astype(np.float32),
        disc) for _ in range(3)]
    tx = optax.adamw(LR, weight_decay=1e-4)
    jp, jst = disc, tx.init(disc)
    for g in grads:
        upd, jst = jax.jit(tx.update)(g, jst, jp)
        jp = jax.jit(optax.apply_updates)(jp, upd)
    params = ttrain.make_train_state(from_jax_params(disc), from_jax_params(disc), LR).params
    opt = ttrain.adamw(params, LR, 1e-4)
    leaves = [t for _, t in named_leaves(params)]
    for g in grads:
        for p, gv in zip(leaves, [t for _, t in named_leaves(from_jax_params(g))]):
            p.grad = gv
        opt.step()
    got, ref, start = flat(params), flat(jax.tree_util.tree_map(np.asarray, jp)), flat(disc)
    worst = max((ulps_apart(got[k], ref[k], start[k], LR, len(grads)).max(), k) for k in ref)
    assert worst[0] <= ULPS, worst


ADAMW_LONG_ULPS = 1.0   # a step, in f32 ulps of max(|p_jax|, |p_start|, lr), over 200 steps


@pytest.mark.parametrize("form", ["port", "torch"])
def test_adamw_long_run_matches_optax(form):
    """The optimizer at HaMeR's lr 1e-5 and wd 1e-4 over 200 steps of seeded
    gradients against jitted optax.adamw, each step: the port's AdamW
    (optax's form) within ADAMW_LONG_ULPS ulps a step; XLA fuses the moment
    updates into fused multiply-adds, which eager optax does not (the port
    is within one ulp of eager optax after 200 steps). torch.optim.AdamW,
    whose decay factor rounds to 1, misses the limit: 36 ulps a step on
    these gradients, more than 10 times it."""
    rng = np.random.default_rng(31)
    shapes = [(64, 32), (32,), (16, 16, 3), (1000,)]
    p0 = [(rng.normal(size=s) * 10.0 ** rng.uniform(-3, 1)).astype(np.float32) for s in shapes]
    grads = [[(rng.normal(size=s) * 10.0 ** rng.uniform(-3, 1)).astype(np.float32)
              for s in shapes] for _ in range(200)]
    lr, wd = 1e-5, 1e-4
    tx = optax.adamw(lr, weight_decay=wd)
    update = jax.jit(lambda g, st, p: (lambda u, st: (optax.apply_updates(p, u), st))(
        *tx.update(g, st, p)))
    jp = [jnp.asarray(a) for a in p0]
    jst = tx.init(jp)
    params = [torch.tensor(a) for a in p0]
    cls = ttrain.AdamW if form == "port" else torch.optim.AdamW
    opt = cls(params, lr=lr, betas=(0.9, 0.999), eps=1e-8, weight_decay=wd)
    worst = 0.0
    for i, g in enumerate(grads):
        jp, jst = update(g, jst, jp)
        for p, gv in zip(params, g):
            p.grad = torch.from_numpy(gv)
        opt.step()
        for p, ref, start in zip(params, jp, p0):
            ref = np.asarray(ref)
            mag = np.maximum(np.maximum(np.abs(ref), np.abs(start)), lr).astype(np.float32)
            worst = max(worst, float((np.abs(p.numpy() - ref) / np.spacing(mag)).max()) / (i + 1))
    if form == "port":
        assert worst <= ADAMW_LONG_ULPS, worst
    else:
        assert worst > 10 * ADAMW_LONG_ULPS, worst


@pytest.mark.parametrize("run", [1, 1000, 2100])
def test_adamw_runs_match_one_run(monkeypatch, run):
    """AdamW updating its leaves in runs of ``run`` elements (ADAMW_RUN; a
    leaf larger than a run goes alone) gives bit for bit the parameters and
    moments of one run over every leaf, over 5 steps of seeded gradients."""
    from hamer_yolo_tpu_torch.training import optim as toptim

    rng = np.random.default_rng(32)
    shapes = [(64, 32), (32,), (16, 16, 3), (1000,)]
    p0 = [rng.normal(size=s).astype(np.float32) for s in shapes]
    grads = [[(1e-3 * rng.normal(size=s)).astype(np.float32) for s in shapes] for _ in range(5)]
    out = []
    for limit in (toptim.ADAMW_RUN, run):
        monkeypatch.setattr(toptim, "ADAMW_RUN", limit)
        params = [torch.tensor(a) for a in p0]
        opt = toptim.AdamW(params, lr=1e-5, weight_decay=1e-4)
        for g in grads:
            for p, gv in zip(params, g):
                p.grad = torch.from_numpy(gv)
            opt.step()
        out.append([t for p in params
                    for t in (p, opt.state[p]["exp_avg"], opt.state[p]["exp_avg_sq"])])
    assert len(list(toptim._runs(params, run))) > 1
    assert all(torch.equal(a, b) for a, b in zip(*out))


def test_two_train_steps_match_jax(setup):
    """Two whole steps (generator, then discriminator) against JAX's jitted
    step: the metrics at rel 1e-4, every parameter of both nets within the
    optimizer's limit (ULPS, ADAM_REL), elements whose gradient in either
    step is nonzero but below GRAD_FLOOR of their leaf's largest, or 0 in
    one package only, left out (at most a quarter of all: a gradient's
    error is a share of its leaf's norm, and Adam's update is g over its own
    scale; a key's bias has the gradient 0 in exact arithmetic)."""
    s = setup
    state = ttrain.make_train_state(from_jax_params(s["params"]), from_jax_params(s["disc"]), LR)
    batch = port_batch(s["batch"])
    small = {}
    jax_g1 = {f"params/{k}": v for k, v in flat(s["g_gen"]).items()}
    for i, (jstate, jmetrics) in enumerate(s["steps"]):
        metrics = ttrain.train_step(state, batch, s["tmano"], s["tcfg"])
        assert metrics.keys() == jmetrics.keys()
        for k in metrics:
            np.testing.assert_allclose(float(metrics[k]), float(jmetrics[k]), rtol=1e-4,
                                       err_msg=k)
        for name, tree in (("params", state.params), ("disc", state.disc_params)):
            for k, t in named_leaves(tree):
                g = np.abs(to_jax_layout(t.grad))
                low = (g > 0) & (g < GRAD_FLOOR * g.max())
                if i == 0 and f"{name}/{k}" in jax_g1:  # 0 in one package only (a key bias's)
                    low |= (g == 0) != (jax_g1[f"{name}/{k}"] == 0)
                small[f"{name}/{k}"] = small.get(f"{name}/{k}", low) | low
    assert state.step == 2
    got = {**{f"params/{k}": v for k, v in flat(state.params).items()},
           **{f"disc/{k}": v for k, v in flat(state.disc_params).items()}}
    ref = {**{f"params/{k}": v for k, v in flat(jstate.params).items()},
           **{f"disc/{k}": v for k, v in flat(jstate.disc_params).items()}}
    start = {**{f"params/{k}": v for k, v in flat(s["params"]).items()},
             **{f"disc/{k}": v for k, v in flat(s["disc"]).items()}}
    assert got.keys() == ref.keys() == small.keys()
    kept = {"params": [0, 0], "disc": [0, 0]}
    for k in ref:
        apart = ulps_apart(got[k], ref[k], start[k], LR, 2)[~small[k]]
        count = kept[k.split("/")[0]]
        count[0], count[1] = count[0] + apart.size, count[1] + ref[k].size
        assert apart.size == 0 or apart.max() <= ULPS, (k, apart.max())
    # gradients are heavy-tailed (the critic's 1024-wide layers' at batch 2
    # of rank 2): 59% and 67% of the elements are kept here
    assert kept["params"][0] > 0.5 * kept["params"][1], kept
    assert kept["disc"][0] > 0.5 * kept["disc"][1], kept


def test_train_step_runs_no_kernel(setup):
    """A config that asks for the fused attention and the fused MANO still
    trains on the plain layers (train_config), while its forward under grad
    hits K2's refusal."""
    import dataclasses

    s = setup
    cfg = dataclasses.replace(s["tcfg"], vit=dataclasses.replace(s["tcfg"].vit, fused_attn=True),
                              fused_mano=True)
    state = ttrain.make_train_state(from_jax_params(s["params"]), from_jax_params(s["disc"]), LR)
    ref = ttrain.make_train_state(from_jax_params(s["params"]), from_jax_params(s["disc"]), LR)
    batch = port_batch(s["batch"])
    m = ttrain.train_step(state, batch, s["tmano"], cfg)
    m_ref = ttrain.train_step(ref, batch, s["tmano"], s["tcfg"])
    assert float(m["total"]) == float(m_ref["total"])
    with pytest.raises(ValueError, match="fused_bf16_attn_block"):
        ttrain.hamer_loss_fn(state.params, state.disc_params, s["tmano"], batch, cfg)


def test_train_state_reloads_bit_equal(setup, tmp_path):
    """params, both optimizers' moments and the step through
    save_checkpoint / load_checkpoint into a fresh state: bit-equal."""
    s = setup
    state = ttrain.make_train_state(from_jax_params(s["params"]), from_jax_params(s["disc"]), LR)
    ttrain.train_step(state, port_batch(s["batch"]), s["tmano"], s["tcfg"])
    path = str(tmp_path / "ckpt_1.npz")
    ttrain.save_train_state(path, state)
    fresh = ttrain.make_train_state(from_jax_params(s["params"]), from_jax_params(s["disc"]), LR)
    ttrain.load_train_state(path, fresh)
    assert fresh.step == 1
    a, b = flat(ttrain.state_tree(state)), flat(ttrain.state_tree(fresh))
    assert a.keys() == b.keys()
    for k in a:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def test_tool_runs_checkpoints_and_resumes(setup, tmp_path, capsys):
    """tools/train_hamer --tiny on the CPU: 3 steps with the viz and a
    checkpoint at step 2, then --resume auto for one more; metrics.jsonl's
    keys are those JAX's tool writes (its step's metrics, "step", "time")."""
    out = str(tmp_path / "run")
    assert tool.main(["--tiny", "--steps", "3", "--batch", "2", "--viz-every", "2",
                      "--ckpt-every", "2", "--device", "cpu", "--out", out]) == 0
    assert sorted(os.listdir(out)) == ["ckpt_2.npz", "ckpt_final.npz", "images", "metrics.jsonl"]
    assert tool.main(["--tiny", "--steps", "4", "--batch", "2", "--resume", "auto",
                      "--device", "cpu", "--out", out]) == 0
    assert "resumed at step 3" in capsys.readouterr().out
    with open(os.path.join(out, "metrics.jsonl")) as f:
        recs = [json.loads(line) for line in f]
    assert [r["step"] for r in recs] == [0]
    assert set(recs[0]) == {"step", "time"} | set(setup["steps"][0][1])
    assert all(np.isfinite(v) for k, v in recs[0].items())


@pytest.mark.parametrize("flag", ["--devices", "--tp"])
def test_tool_refuses_parallelism(flag):
    """A parallelism the process group cannot hold exits: --devices 2 or
    --tp 2 in a group of one process (torchrun starts one a device)."""
    with pytest.raises(SystemExit):
        tool.main(["--tiny", flag, "2", "--device", "cpu"])


# ---------------------------------------------------------------------------
# F22: no kernel under autograd
# ---------------------------------------------------------------------------

def _kernel_calls():
    """{kernel: (wrapper name, a call of the wrapper on small CPU inputs
    whose first float input is ``x``)}."""
    from hamer_yolo_tpu_torch.ops import attn_block, attn_block_int8, attn_proj_block
    from hamer_yolo_tpu_torch.ops import int8_matmul as im
    from hamer_yolo_tpu_torch.ops import mano_lbs, nms, short_attention

    g = torch.Generator().manual_seed(9)
    K, H, h = 32, 64, 2

    def f(*shape):
        return torch.randn(shape, generator=g)

    def q(*shape):
        return torch.randint(-127, 128, shape, generator=g, dtype=torch.int8)

    def s(n):
        return 0.01 + 0.01 * torch.rand(n, generator=g)

    ln = (1 + 0.1 * f(K), 0.1 * f(K))
    _, tmano = mano_pair()
    boxes = torch.cumsum(torch.rand(2, 6, 4, generator=g), -1) * 10
    return {
        "K1": ("greedy_nms_keep", lambda x: nms.greedy_nms_keep(x, torch.ones(2, 6), 0.5),
               boxes),
        "K2": ("fused_bf16_attn_block", lambda x: attn_block.fused_bf16_attn_block(
            x, f(K, 3 * K), f(3 * K), *ln, h), f(2, 5, K)),
        "K3": ("fused_int8_attn_proj_block", lambda x: attn_proj_block.fused_int8_attn_proj_block(
            x, q(K, 3 * K), s(3 * K), f(3 * K), *ln, 0.03, 0.012, q(K, K), s(K), f(K), h),
            f(2, 5, K)),
        "K4": ("fused_int8_mlp_block", lambda x: im.fused_int8_mlp_block(
            x, q(K, H), s(H), f(H), q(H, K), s(K), f(K), *ln, 0.03, 0.02), f(2, 5, K)),
        "K5": ("fused_int8_matmul", lambda x: im.fused_int8_matmul(x, q(K, H), s(H), f(H)),
               f(2, 5, K)),
        "K6": ("fused_int8_attn_block", lambda x: attn_block_int8.fused_int8_attn_block(
            x, q(K, 3 * K), s(3 * K), f(3 * K), *ln, 0.03, 0.012, h), f(2, 5, K)),
        "K7": ("fused_short_attention", lambda x: short_attention.fused_short_attention(
            x, f(2, h, 5, 16), f(2, h, 5, 16)), f(2, h, 5, 16)),
        "K8": ("fused_qkv_attention", lambda x: short_attention.fused_qkv_attention(x, h),
               f(2, 5, 3 * K)),
        "K9": ("mano_lbs_fused", lambda x: mano_lbs.mano_lbs_fused(
            tmano, x, torch.eye(3).expand(2, 16, 3, 3).contiguous()), f(2, 10)),
        "K10": ("fused_int8_mlp_block1", lambda x: im.fused_int8_mlp_block1(
            x, q(K, H), s(H), f(H), q(H, K), s(K), f(K), *ln, 0.03, 0.02, hc=32), f(2, 5, K)),
    }


@pytest.mark.parametrize("kernel", [f"K{i}" for i in range(1, 11)])
def test_kernel_wrapper_refuses_grad(kernel):
    """Under grad mode an input that requires grad makes the wrapper raise,
    naming it, on the CPU too; under torch.no_grad the same call runs."""
    name, call, x = _kernel_calls()[kernel]
    with pytest.raises(ValueError, match=name):
        call(x.clone().requires_grad_(True))
    with torch.no_grad():
        out = call(x.clone().requires_grad_(True))
    assert all(torch.isfinite(o.float()).all() for o in (out if isinstance(out, tuple) else (out,)))
    call(x)  # no input requires grad: runs with grad mode on


def test_train_step_after_an_inference_forward(setup):
    """The constants a forward caches (core/nn.constant: MANO's joint
    indices) made under torch.inference_mode, as the pipeline's forwards
    run, still serve a train step's autograd."""
    from hamer_yolo_tpu_torch.core import nn
    from hamer_yolo_tpu_torch.models.hamer import hamer_forward

    s = setup
    state = ttrain.make_train_state(from_jax_params(s["params"]), from_jax_params(s["disc"]), LR)
    batch = port_batch(s["batch"])
    nn.constant.cache_clear()
    with torch.inference_mode():
        hamer_forward(state.params, s["tmano"], batch["img"], s["tcfg"])
    metrics = ttrain.train_step(state, batch, s["tmano"], s["tcfg"])
    assert np.isfinite(float(metrics["total"]))
