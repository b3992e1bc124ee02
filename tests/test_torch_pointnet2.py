"""The port's PointNet++ / DGCNN / pointMLP zoo (hamer_yolo_tpu_torch/models/
pointnet2.py) and its eight converters against the JAX package's.

- The nets with inits, at tests/test_pointnet2_models.py's tiny widths: the
  JAX init carried across by core/bridge, the port's forward against JAX's
  at atol 5e-4, rtol 1e-4 (that file's tolerance for the zoo).
- The converters, on numpy-made state dicts with the reference's key names
  (tests/test_torch_state_dicts.ZOO, hidden widths divided by 8): the port's
  tree equals the bridge applied to JAX's, leaf for leaf and exactly.
- The zoo's nine forwards on those trees against JAX's, each at its oracle
  test's tolerance in tests/test_pointnet2_models.py
  (test_torch_state_dicts.ZOO_TOL).

Each JAX forward is jitted once (``jitted``) and the cases share it."""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hamer_yolo_tpu.core import convert as JC
from hamer_yolo_tpu.models import pointnet2 as JP
from hamer_yolo_tpu_torch.core.bridge import from_jax_params
from hamer_yolo_tpu_torch.models import pointnet2 as TP
from test_torch_state_dicts import ZOO, ZOO_TOL, assert_leaf_equal

torch.set_num_threads(2)

SA1 = JP.SAConfig(npoint=32, radius=0.4, nsample=8, mlp=(16, 32))
SA2 = JP.SAConfig(npoint=8, radius=0.8, nsample=8, mlp=(32, 64))
TSA1 = TP.SAConfig(npoint=32, radius=0.4, nsample=8, mlp=(16, 32))
TSA2 = TP.SAConfig(npoint=8, radius=0.8, nsample=8, mlp=(32, 64))
MSG_TINY = (
    ((64, (0.05, 0.1), (8, 16), ((16, 32), (16, 64))),
     (32, (0.1, 0.2), (8, 16), ((32, 128), (32, 128))),
     (16, (0.2, 0.4), (8, 16), ((64, 256), (64, 256))),
     (8, (0.4, 0.8), (8, 16), ((128, 512), (128, 512)))))
ATOL, RTOL = 5e-4, 1e-4
DIV = 8  # the zoo's hidden widths on the CPU
JAX_CONVERT = {"cls_ssg": JC.convert_pointnet2_cls_ssg, "sem_seg": JC.convert_pointnet2_sem_seg,
               "dgcnn_semseg": JC.convert_dgcnn_semseg,
               "part_seg": JC.convert_pointnet2_part_seg_ref,
               "msg_large": JC.convert_pointnet2_msg_large, "pointmlp": JC.convert_pointmlp,
               "pointmlp_refine": JC.convert_pointmlp, "pointnet": JC.convert_dgcnn_pointnet,
               "dgcnn_partseg": JC.convert_dgcnn_partseg}


@functools.lru_cache(maxsize=None)
def jitted(fn, **static):
    return jax.jit(functools.partial(fn, **static))


def port(tree):
    return from_jax_params(jax.tree_util.tree_map(np.asarray, tree))


def close(got, want, atol=ATOL, rtol=RTOL):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), atol=atol, rtol=rtol)


def cloud(seed, *shape, scale=0.5):
    return np.random.default_rng(seed).normal(scale=scale, size=shape).astype(np.float32)


# --- the nets with inits ------------------------------------------------------

@pytest.mark.parametrize("net", ["cls", "seg", "dgcnn", "pointmlp", "part_seg", "msg_sem",
                                 "sa_msg"])
def test_net_forward_equals_jax(net):
    key = jax.random.PRNGKey(0)
    if net == "cls":
        p, x = JP.init_pointnet2_cls(key, 10, sa1=SA1, sa2=SA2), cloud(1, 2, 128, 3)
        want = jitted(JP.pointnet2_cls_forward, sa1=SA1, sa2=SA2)(p, x)
        got = TP.pointnet2_cls_forward(port(p), torch.from_numpy(x), TSA1, TSA2)
    elif net == "seg":
        p, x = JP.init_pointnet2_seg(key, 4, sa1=SA1, sa2=SA2), cloud(2, 2, 128, 3)
        want = jitted(JP.pointnet2_seg_forward, sa1=SA1, sa2=SA2)(p, x)
        got = TP.pointnet2_seg_forward(port(p), torch.from_numpy(x), TSA1, TSA2)
    elif net == "dgcnn":
        p, x = JP.init_dgcnn_cls(key, 6, dims=(8, 16)), cloud(3, 2, 64, 3)
        want = jitted(JP.dgcnn_cls_forward, k=8)(p, x)
        got = TP.dgcnn_cls_forward(port(p), torch.from_numpy(x), k=8)
        np.testing.assert_array_equal(TP.knn_indices(torch.from_numpy(x), 8).numpy(),
                                      np.asarray(JP.knn_indices(jnp.asarray(x), 8)))
    elif net == "pointmlp":
        p, x = JP.init_pointmlp_cls(key, 7, dims=(16, 32), npoints=(32, 8)), cloud(4, 2, 96, 3)
        want = jitted(JP.pointmlp_cls_forward, npoints=(32, 8), nsample=8)(p, x)
        got = TP.pointmlp_cls_forward(port(p), torch.from_numpy(x), (32, 8), 8)
    elif net == "part_seg":
        sa1, sa2 = JP.SAConfig(64, 0.2, 16, (32, 64)), JP.SAConfig(16, 0.4, 16, (64, 128))
        tsa1, tsa2 = TP.SAConfig(64, 0.2, 16, (32, 64)), TP.SAConfig(16, 0.4, 16, (64, 128))
        p = JP.init_pointnet2_part_seg(key, 50, in_dim=3, sa1=sa1, sa2=sa2)
        x, f = cloud(5, 2, 256, 3), cloud(6, 2, 256, 3)
        want = jitted(JP.pointnet2_part_seg_forward, sa1=sa1, sa2=sa2)(p, x, f)
        got = TP.pointnet2_part_seg_forward(port(p), torch.from_numpy(x), torch.from_numpy(f),
                                            tsa1, tsa2)
    elif net == "msg_sem":
        jl = tuple(JP.MSGConfig(*c) for c in MSG_TINY)
        tl = tuple(TP.MSGConfig(*c) for c in MSG_TINY)
        p, x = JP.init_pointnet2_msg_sem(key, in_dim=0, levels=jl), cloud(7, 1, 256, 3)
        want = jitted(JP.pointnet2_msg_sem_forward, levels=jl)(p, x)
        got = TP.pointnet2_msg_sem_forward(port(p), torch.from_numpy(x), levels=tl)
        assert [tuple(g.shape) for g in got] == [(1, 256, 63), (1, 256, 21), (1, 256, 21)]
        for a, b in zip(got, want):
            close(a, b)
        return
    else:
        cfg = (32, (0.2, 0.4), (8, 16), ((16, 32), (16, 48)))
        p, x = JP.sa_msg_init(key, 3, JP.MSGConfig(*cfg)), cloud(8, 2, 128, 3)
        wx, wf = jitted(JP.set_abstraction_msg, cfg=JP.MSGConfig(*cfg))(p, x, x)
        gx, gf = TP.set_abstraction_msg(port(p), torch.from_numpy(x), torch.from_numpy(x),
                                        TP.MSGConfig(*cfg))
        assert TP.MSGConfig(*cfg).out_dim == 80
        np.testing.assert_array_equal(gx.numpy(), np.asarray(wx))
        close(gf, wf)
        return
    assert tuple(got.shape) == tuple(want.shape)
    close(got, want)


def test_pointmlp_affine_and_knn_self_first():
    x = cloud(9, 1, 32, 3)
    idx = TP.knn_indices(torch.from_numpy(x), 4).numpy()
    np.testing.assert_array_equal(idx[0, :, 0], np.arange(32))
    g = cloud(10, 2, 8, 5, 6)
    p = {"alpha": np.linspace(0.5, 1.5, 6, dtype=np.float32),
         "beta": np.linspace(-0.2, 0.2, 6, dtype=np.float32)}
    close(TP.geometric_affine(port(p), torch.from_numpy(g)),
          JP.geometric_affine(jax.tree_util.tree_map(jnp.asarray, p), jnp.asarray(g)), 1e-6, 1e-6)


# --- the converters -------------------------------------------------------------

@pytest.fixture(scope="module")
def zoo_trees():
    """name -> (the reference-format state dict, JAX's tree, the port's tree)."""
    out = {}
    for i, (name, (build, convert)) in enumerate(ZOO.items()):
        sd = build(np.random.default_rng(100 + i), DIV)
        out[name] = (sd, JAX_CONVERT[name](sd), convert(sd))
    return out


@pytest.mark.parametrize("name", list(ZOO))
def test_zoo_converter_equals_bridge_of_jax(name, zoo_trees):
    _, jax_tree, port_tree = zoo_trees[name]
    assert_leaf_equal({k: _numpy(v) for k, v in port_tree.items()},
                      {k: _numpy(v) for k, v in from_jax_params(jax_tree).items()})


def _numpy(tree):
    if isinstance(tree, dict):
        return {k: _numpy(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_numpy(v) for v in tree]
    return tree.numpy()


def test_zoo_converters_refuse_a_foreign_state_dict(zoo_trees):
    sd = zoo_trees["cls_ssg"][0]
    with pytest.raises(KeyError):
        ZOO["pointnet"][1](sd)


# --- the zoo's forwards -----------------------------------------------------------

def zoo_inputs(name):
    """(JAX forward, its static keywords, the inputs) of each zoo case at the
    CPU's size."""
    if name == "cls_ssg":
        return JP.ref_cls_ssg_forward, {}, (cloud(20, 2, 600, 6),)
    if name == "sem_seg":
        return JP.ref_sem_seg_forward, {}, (cloud(21, 2, 1100, 9),)
    if name == "dgcnn_semseg":
        return JP.ref_dgcnn_semseg_forward, {"k": 20}, (cloud(22, 2, 128, 9),)
    if name == "part_seg":
        return JP.ref_part_seg_forward, {}, (cloud(23, 2, 700, 3), cloud(24, 2, 21, 3, scale=0.4))
    if name == "msg_large":
        return JP.ref_msg_large_forward, {}, (cloud(25, 2, 600, 3),)
    if name == "pointmlp":
        return JP.ref_pointmlp_forward, {"points": 1024}, (cloud(26, 2, 1024, 3),)
    if name == "pointmlp_refine":
        return (JP.ref_pointmlp_refine_forward, {"points": 1024},
                (cloud(27, 2, 1024, 3), cloud(28, 2, 1024, 64 // DIV)))
    if name == "pointnet":
        return JP.ref_pointnet_cls_forward, {}, (cloud(29, 4, 256, 3),)
    return JP.ref_dgcnn_partseg_forward, {"k": 20}, (cloud(30, 2, 160, 3),)


@pytest.mark.parametrize("name", list(ZOO))
def test_zoo_forward_equals_jax(name, zoo_trees):
    _, jax_tree, port_tree = zoo_trees[name]
    fn, static, inputs = zoo_inputs(name)
    want = jitted(fn, **static)(jax.tree_util.tree_map(jnp.asarray, jax_tree),
                                *(jnp.asarray(a) for a in inputs))
    got = getattr(TP, fn.__name__)(port_tree, *(torch.from_numpy(a) for a in inputs), **static)
    assert tuple(got.shape) == tuple(want.shape)
    assert np.isfinite(got.numpy()).all()
    assert float(np.abs(np.asarray(want)).max()) > 1e-2  # the net is not dead
    close(got, want, ZOO_TOL[name])


def test_dgcnn_semseg_pinned_first_graph_equals_jax(zoo_trees):
    """A 3-channel cloud leaves the first graph's distances empty; both
    packages take the pinned graph a caller gives."""
    sd = ZOO["dgcnn_semseg"][0](np.random.default_rng(31), DIV, channels=3)
    jt, tt = JC.convert_dgcnn_semseg(sd), ZOO["dgcnn_semseg"][1](sd)
    x = cloud(32, 2, 96, 3)
    pin = np.stack([np.random.default_rng(33 + b).permutation(96)[None, :20].repeat(96, 0)
                    for b in range(2)]).astype(np.int32)
    for idx in (None, pin):
        want = JP.ref_dgcnn_semseg_forward(jax.tree_util.tree_map(jnp.asarray, jt),
                                           jnp.asarray(x), k=20,
                                           stage1_idx=None if idx is None else jnp.asarray(idx))
        got = TP.ref_dgcnn_semseg_forward(tt, torch.from_numpy(x), k=20,
                                          stage1_idx=None if idx is None
                                          else torch.from_numpy(idx).long())
        close(got, want, ZOO_TOL["dgcnn_semseg"])
