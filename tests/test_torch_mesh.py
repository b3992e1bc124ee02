"""parallel/mesh.py (ROADMAP Queue 1 item 8) on the CPU: torch.distributed's
gloo backend, one spawned process a rank. JAX's sharding rules; a (2 data x
2 model) HaMeR step against JAX's sharded step on the 8-device virtual mesh
(tests/conftest.py) and against the port's single-process step; the replica
axis; a 2-rank YOLOv7 step (BN over the global batch) and KPFusion step
against the single-process step; BatchedPipeline(mesh=); train_kpfusion_rgbd
--devices 2. Workers run one thread; every join and collective has a time
limit, so that a hung rank fails its test."""
import os
import time

import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

torch.set_num_threads(1)

JOIN_TIMEOUT_S = 240.0       # a spawned group's whole run
COLLECTIVE_TIMEOUT_S = 60.0  # each collective (init_process_group's timeout)
# tests/test_parallel.py:55-80: the sharded step's loss against the single-device one
LOSS_RTOL = 2e-4
HAMER_LR = 1e-5              # training/train_hamer's default
KPF_LR = 8e-4                # training/train_kpfusion_rgbd's default
# Adam's first step is lr sign(g): where a gradient is rounding noise near 0,
# two reductions of it may step a parameter in opposite directions, 2 lr apart
# (training/train_hamer.py's note). Every parameter within that; all but a few
# within f32 rounding of the single-process step.
ADAM_FLIP = 2.0 + 1e-3
SETTLED = 1e-6
SETTLED_SHARE = 0.99
# SGD's step is linear in the gradient: the data-parallel sum moves a
# parameter by the rounding of its terms only; BN's moments are a mean of
# the ranks' means (one rounding apart from the global mean).
SGD_TOL = dict(rtol=1e-5, atol=1e-6)
BN_TOL = dict(rtol=1e-5, atol=1e-6)
PIPE_TOL = dict(rtol=1e-4, atol=1e-4)


# ---------------------------------------------------------------------------
# Spawned ranks (no JAX here: the workers import this module)
# ---------------------------------------------------------------------------

def _spawn(scenario, nprocs, tmp):
    from hamer_yolo_tpu_torch.parallel.mesh import free_port

    ctx = mp.start_processes(_worker, args=(nprocs, free_port(), str(tmp), scenario),
                             nprocs=nprocs, join=False, start_method="spawn")
    deadline = time.monotonic() + JOIN_TIMEOUT_S
    while not ctx.join(timeout=max(1.0, deadline - time.monotonic())):
        if time.monotonic() > deadline:
            for p in ctx.processes:
                p.kill()
            raise TimeoutError(f"{scenario}: the {nprocs} ranks did not finish in "
                               f"{JOIN_TIMEOUT_S} s")


def _worker(rank, world, port, tmp, scenario):
    os.environ.update(RANK=str(rank), WORLD_SIZE=str(world), LOCAL_RANK=str(rank),
                      MASTER_ADDR="localhost", MASTER_PORT=str(port))
    torch.set_num_threads(1)
    from hamer_yolo_tpu_torch.parallel.mesh import init_distributed

    init_distributed("cpu", timeout_s=COLLECTIVE_TIMEOUT_S)
    try:
        SCENARIOS[scenario](rank, tmp)
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def _mano():
    from hamer_yolo_tpu_torch.core.mano_assets import load_mano_model, synthetic_mano_model
    from hamer_yolo_tpu_torch.models.mano import ManoModel

    try:
        return ManoModel.from_arrays(load_mano_model("right"))
    except Exception:
        return ManoModel.from_arrays(synthetic_mano_model())


def tiny_hamer():
    from hamer_yolo_tpu_torch.tools.train_hamer import tiny_config

    return tiny_config()  # tests/test_parallel.py's TINY_CFG


def hamer_step(params, disc, batch, mesh=None):
    """One port step from the given trees: (metrics, {path: param})."""
    from hamer_yolo_tpu_torch.training import train_hamer as TH
    from hamer_yolo_tpu_torch.training.optim import named_leaves

    state = TH.make_train_state(params, disc)
    m = TH.train_step(state, batch, _mano(), tiny_hamer(), mesh=mesh)
    return ({k: float(v) for k, v in m.items()},
            {p: t.detach().numpy().copy() for p, t in named_leaves(state.params)})


def _save(path, metrics, leaves):
    np.savez(path, **{f"m:{k}": v for k, v in metrics.items()},
             **{f"p:{k}": v for k, v in leaves.items()})


def _hamer_ranks(rank, tmp):
    from hamer_yolo_tpu_torch.core.checkpoint import load_checkpoint
    from hamer_yolo_tpu_torch.parallel.mesh import make_mesh

    tree = load_checkpoint(os.path.join(tmp, "hamer_in.npz"), "cpu")
    batch = {k: torch.from_numpy(v) for k, v in np.load(os.path.join(tmp, "batch.npz")).items()}
    for name, (rep, data, model) in (("dp2tp2", (1, 2, 2)), ("replica", (2, 2, 1))):
        mesh = make_mesh(data, model, devices="cpu", n_replica=rep)
        metrics, leaves = hamer_step(tree["params"], tree["disc_params"], batch, mesh)
        if rank == 0:
            _save(os.path.join(tmp, f"{name}.npz"), metrics, leaves)


def tiny_yolo():
    from hamer_yolo_tpu_torch.models.yolov7.model import YoloConfig

    return YoloConfig(nc=3, img_size=64, compute_dtype="float32")


# every trainable YOLO block and its BN: conv, RepConv (with its identity
# branch), SPPCSPC, and the DET head (tests/test_torch_train_yolo.py's MINI_SPEC)
YOLO_SPEC = [(-1, "C", (8, 3, 2)), (-1, "C", (16, 3, 2)), (-1, "C", (16, 3, 2)),
             (-1, "REP", (16,)), (-1, "C", (16, 3, 2)), (-1, "SPP", (16,)),
             (-1, "MP", ()), (-2, "C", (24, 3, 2)), ((-1, -2), "CAT", ()),
             ((3, 5, 8), "DET", ())]


def yolo_step(mesh=None):
    """One port YOLOv7 step at 64 px, B = 4, from seed 0: {path: leaf} of the
    params (BN running stats included) and the loss."""
    from hamer_yolo_tpu_torch.training import train_yolo as TY
    from hamer_yolo_tpu_torch.training.optim import named_leaves

    state = TY.init_yolo_train_state(torch.Generator().manual_seed(0), tiny_yolo(), 100,
                                     spec=YOLO_SPEC)
    batch = TY.synthetic_yolo_batch(torch.Generator().manual_seed(1), 4, 64)
    m = TY.make_yolo_train_step(tiny_yolo(), YOLO_SPEC, mesh=mesh)(state, batch)
    return float(m["loss"]), {p: t.detach().numpy().copy() for p, t in named_leaves(state.params)}


def kpf_step(mesh=None):
    from hamer_yolo_tpu_torch.tools.train_kpfusion_rgbd import tiny_config
    from hamer_yolo_tpu_torch.training import train_kpfusion_rgbd as TK
    from hamer_yolo_tpu_torch.training.optim import named_leaves

    cfg = tiny_config()
    state = TK.init_train_state(torch.Generator().manual_seed(0), cfg)
    batch = {k: torch.from_numpy(v)
             for k, v in TK.synthetic_rgbd_batch(np.random.default_rng(1), 4, cfg).items()}
    m = TK.train_step(state, batch, cfg, mesh=mesh)
    return float(m["loss"]), {p: t.detach().numpy().copy() for p, t in named_leaves(state.params)}


def pipeline_outputs(mesh=None):
    """A tiny BatchedPipeline batch of 4 frames (two a rank with a mesh)."""
    from hamer_yolo_tpu_torch.cli.main import pipeline_config
    from hamer_yolo_tpu_torch.core.checkpoint import init_pipeline_params
    from hamer_yolo_tpu_torch.pipeline.runner import default_intrinsics
    from hamer_yolo_tpu_torch.pipeline.serving import BatchedPipeline

    cfg = pipeline_config(tiny=True)
    mano = _mano()
    params = init_pipeline_params(0, mano, cfg.yolo, cfg.hamer, cfg.sar, device="cpu")
    frames = [np.random.default_rng(i).integers(0, 256, (48, 64, 3), dtype=np.uint8)
              for i in range(3)]
    pipe = BatchedPipeline(params, mano, cfg, batch_size=4, device="cpu", mesh=mesh)
    with torch.inference_mode():
        return pipe.process_batch(frames, default_intrinsics(frames[0].shape))


def _pair_ranks(rank, tmp):
    from hamer_yolo_tpu_torch.parallel.mesh import make_mesh
    from hamer_yolo_tpu_torch.tools import train_kpfusion_rgbd as tool

    mesh = make_mesh(2, 1, devices="cpu")
    loss, leaves = yolo_step(mesh)
    kloss, kleaves = kpf_step(mesh)
    pipe = pipeline_outputs(mesh)
    if rank == 0:
        _save(os.path.join(tmp, "yolo.npz"), {"loss": loss}, leaves)
        _save(os.path.join(tmp, "kpf.npz"), {"loss": kloss}, kleaves)
        np.savez(os.path.join(tmp, "pipe.npz"), **pipe)
    # last: the tool leaves the process group when it is done
    rc, _ = tool.run(["--tiny", "--device", "cpu", "--devices", "2", "--steps", "2",
                      "--log-every", "1", "--out", os.path.join(tmp, "tool")])
    with open(os.path.join(tmp, f"tool_rc{rank}"), "w") as f:
        f.write(str(rc))


SCENARIOS = {"hamer": _hamer_ranks, "pair": _pair_ranks}


def _load(path):
    z = np.load(path)
    return ({k[2:]: float(z[k]) for k in z.files if k.startswith("m:")},
            {k[2:]: z[k] for k in z.files if k.startswith("p:")})


def _hold_adam(got, ref, lr):
    d = np.concatenate([np.abs(got[k] - ref[k]).ravel() for k in ref])
    assert got.keys() == ref.keys()
    assert d.max() <= ADAM_FLIP * lr, d.max()
    assert (d <= SETTLED).mean() >= SETTLED_SHARE, (d <= SETTLED).mean()


# ---------------------------------------------------------------------------
# Tests (JAX in this process only)
# ---------------------------------------------------------------------------

def test_mesh_rules_match_jax():
    """The axes, JAX's Megatron rules by path and NamedSharding specs, on a
    one-process gloo group (a 1 x 1 mesh; the rules do not need more)."""
    from jax.sharding import PartitionSpec as P

    from hamer_yolo_tpu.parallel import mesh as jmesh
    from hamer_yolo_tpu_torch.parallel import mesh as M
    from torch.distributed.tensor import Replicate, Shard

    for path, ndim in (("blocks/0/attn/qkv/w", 2), ("blocks/0/attn/proj/w", 2),
                       ("blocks/0/mlp/fc1/w", 2), ("blocks/0/mlp/fc2/b", 1),
                       ("layers/0/ca/to_kv/w", 2), ("patch_embed/proj/w", 4),
                       ("norm/scale", 1), ("decpose/w", 2)):
        jspec, tspec = jmesh._tp_spec_for_path(path, ndim), M._tp_spec_for_path(path, ndim)
        want = {P(None, "model"): Shard(1), P("model", None): Shard(0), P(): Replicate()}
        assert tspec == want[jspec], path
    M.init_distributed("cpu", COLLECTIVE_TIMEOUT_S)
    try:
        mesh = M.make_mesh(1, 1, devices="cpu")
        assert mesh.mesh_dim_names == ("data", "model") and M.data_axes(mesh) == ("data",)
        params = {"attn": {"qkv": {"w": torch.zeros(64, 192)}, "proj": {"w": torch.zeros(64, 64)}},
                  "norm": {"scale": torch.zeros(64)}}
        sh = M.vit_tp_shardings(params, mesh)
        assert sh["attn"]["qkv"]["w"].spec == (None, "model")
        assert sh["attn"]["proj"]["w"].spec == ("model",)
        assert sh["norm"]["scale"].spec == ()
        assert M.batch_sharding(mesh).spec == ("data",)
        shared = M.shard_params(params, sh)
        assert torch.equal(shared["attn"]["qkv"]["w"].full_tensor(), params["attn"]["qkv"]["w"])
        batch = M.shard_batch({"img": torch.arange(8.0).reshape(4, 2)}, mesh)
        assert torch.equal(batch["img"].to_local(), torch.arange(8.0).reshape(4, 2))
        with pytest.raises(ValueError, match="needs 2 ranks"):
            M.make_mesh(2, 1, devices="cpu")
    finally:
        M.leave_distributed()


@pytest.fixture(scope="module")
def hamer_runs(tmp_path_factory):
    """JAX's tiny HaMeR step sharded (2 data x 2 model) on the virtual mesh;
    the port's single-process step and its ranks' steps on the same
    (bridged) weights and batch."""
    import jax
    import jax.numpy as jnp

    from hamer_yolo_tpu.models.discriminator import init_discriminator
    from hamer_yolo_tpu.models.hamer import init_hamer
    from hamer_yolo_tpu.models.mano import ManoModel as JMano
    from hamer_yolo_tpu.parallel.mesh import make_mesh, shard_batch, shard_params, vit_tp_shardings
    from hamer_yolo_tpu.training import train_hamer as JT
    from hamer_yolo_tpu_torch.core.checkpoint import save_checkpoint
    from test_parallel import TINY_CFG
    from test_torch_bridge import numpy_params, to_port

    tmp = tmp_path_factory.mktemp("hamer_mesh")
    try:
        from hamer_yolo_tpu.core.mano_assets import load_mano_model
        jmano = JMano.from_arrays(load_mano_model("right"))
    except Exception:
        from hamer_yolo_tpu.core.mano_assets import synthetic_mano_model
        jmano = JMano.from_arrays(synthetic_mano_model())
    # numpy weights in JAX's structure (JAX's eager init takes seconds), JAX's optimizers
    params = numpy_params(lambda k: init_hamer(k, TINY_CFG), 50)
    disc = numpy_params(init_discriminator, 51)
    gtx, dtx = JT.make_optimizers()
    state = JT.HamerTrainState(params, gtx.init(params), disc, dtx.init(disc),
                               jnp.zeros((), jnp.int32))
    rng = np.random.default_rng(52)  # JAX's synthetic_batch's schema and distributions
    eye = np.broadcast_to(np.eye(3, dtype=np.float32), (8, 15, 3, 3)).copy()
    kp2d, kp3d = rng.normal(size=(8, 21, 3)), rng.normal(size=(8, 21, 4))
    kp2d[..., 2], kp3d[..., 3] = rng.uniform(size=(8, 21)), rng.uniform(size=(8, 21))
    batch = {k: np.asarray(v, np.float32) for k, v in {
        "img": rng.normal(size=(8, 64, 64, 3)), "keypoints_2d": kp2d, "keypoints_3d": kp3d,
        "mano_global_orient": eye[:, :1], "mano_hand_pose": eye,
        "mano_betas": 0.1 * rng.normal(size=(8, 10)), "has_mano_params": np.ones(8),
        "mocap_hand_pose": eye, "mocap_betas": 0.1 * rng.normal(size=(8, 10))}.items()}
    step = JT.make_train_step(jmano, TINY_CFG, gtx, dtx)
    mesh = make_mesh(n_data=2, n_model=2)
    with jax.set_mesh(mesh):
        sh = state._replace(params=shard_params(state.params, vit_tp_shardings(state.params,
                                                                                mesh)))
        _, m2 = jax.jit(step)(sh, shard_batch(batch, mesh))
    tree = {"params": params, "disc_params": disc}
    save_checkpoint(str(tmp / "hamer_in.npz"), tree)
    np.savez(tmp / "batch.npz", **batch)
    _spawn("hamer", 4, tmp)
    ported = to_port(tree)
    single = hamer_step(ported["params"], ported["disc_params"],
                        {k: torch.from_numpy(v) for k, v in batch.items()})
    return {"jax_sharded": float(m2["total"]),
            "single": single, "dp2tp2": _load(tmp / "dp2tp2.npz"),
            "replica": _load(tmp / "replica.npz")}


@pytest.mark.parametrize("mesh", ["dp2tp2", "replica"])
def test_hamer_mesh_step_matches_jax_and_the_single_step(hamer_runs, mesh):
    """2 data x 2 model (heads and MLP split, one all-reduce after proj and
    fc2) and 2 replica x 2 data: the loss against JAX's sharded step and the
    port's single-process step at tests/test_parallel.py's rtol; the
    parameters against the port's single-process step (Adam's sign flips)."""
    metrics, leaves = hamer_runs[mesh]
    s_metrics, s_leaves = hamer_runs["single"]
    for ref in (hamer_runs["jax_sharded"], s_metrics["total"]):
        np.testing.assert_allclose(metrics["total"], ref, rtol=LOSS_RTOL)
    np.testing.assert_allclose(metrics["disc_loss"], s_metrics["disc_loss"], rtol=LOSS_RTOL)
    _hold_adam(leaves, s_leaves, HAMER_LR)


@pytest.fixture(scope="module")
def pair_runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("pair_mesh")
    _spawn("pair", 2, tmp)
    return tmp


def test_yolo_two_rank_step_matches_the_single_step(pair_runs):
    """BN over the global batch (the ranks' moments reduced): the running
    stats and every parameter equal to the single-process step's."""
    loss, ref = yolo_step()
    got = _load(pair_runs / "yolo.npz")
    np.testing.assert_allclose(got[0]["loss"], loss, rtol=LOSS_RTOL)
    stats = [k for k in ref if k.endswith("/mean") or k.endswith("/var")]
    assert len(stats) >= 20
    for k in ref:
        np.testing.assert_allclose(got[1][k], ref[k], **(BN_TOL if k in stats else SGD_TOL),
                                   err_msg=k)


def test_kpfusion_two_rank_step_matches_the_single_step(pair_runs):
    loss, ref = kpf_step()
    got = _load(pair_runs / "kpf.npz")
    np.testing.assert_allclose(got[0]["loss"], loss, rtol=LOSS_RTOL)
    _hold_adam(got[1], ref, KPF_LR)


def test_batched_pipeline_mesh_matches_no_mesh(pair_runs):
    """Each rank's two rows of the padded batch through its own program, the
    outputs gathered: the pipeline without a mesh's (per-batch-size
    rounding of the CPU's kernels apart)."""
    ref = pipeline_outputs()
    got = dict(np.load(pair_runs / "pipe.npz"))
    assert got.keys() == ref.keys()
    for k, v in ref.items():
        if v.dtype == bool:
            np.testing.assert_array_equal(got[k], v, err_msg=k)
        else:
            np.testing.assert_allclose(got[k], v, err_msg=k, **PIPE_TOL)


def test_train_tool_with_two_devices(pair_runs):
    """train_kpfusion_rgbd --tiny --devices 2 on two gloo ranks: both exit 0,
    rank 0 alone logs and saves."""
    import json

    out = pair_runs / "tool"
    assert [open(pair_runs / f"tool_rc{r}").read() for r in (0, 1)] == ["0", "0"]
    assert sorted(os.listdir(out)) == ["ckpt_final.npz", "metrics.jsonl"]
    with open(out / "metrics.jsonl") as f:
        recs = [json.loads(line) for line in f]
    assert [r["step"] for r in recs] == [0, 1] and all(np.isfinite(r["loss"]) for r in recs)
