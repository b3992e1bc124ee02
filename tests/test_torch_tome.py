"""ToMe token merging against the JAX package: the bipartite merge (mass
kept, duplicates merged first, as tests/test_tome_tta.py checks JAX's), and
vit_forward_tome over bf16 / f32 weights and over int8 weights (the unfused
composition, and the kernels' plain versions against JAX's Pallas kernels in
interpret mode), and hamer_forward's ``tome_r`` branch. Weights are made
with numpy and loaded through core/bridge.py."""
import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from hamer_yolo_tpu.core import quant as jquant
from hamer_yolo_tpu.models import tome as jtome
from hamer_yolo_tpu.models.hamer import hamer_forward as jax_hamer_forward
from hamer_yolo_tpu.models.vit import ViTConfig as JViT
from hamer_yolo_tpu.models.vit import init_vit as jinit_vit
from hamer_yolo_tpu_torch.core import quant
from hamer_yolo_tpu_torch.models import tome
from hamer_yolo_tpu_torch.models.hamer import hamer_forward
from hamer_yolo_tpu_torch.models.vit import ViTConfig
from test_torch_bridge import (jax_exact, mano_pair, numpy_params, pipeline_params, tiny_configs,
                               to_port)

torch.set_num_threads(1)

# tests/test_tome_tta.py's ViT: 12 tokens, r = 2 a layer -> 10, 8, 6
SHAPE = dict(img_size=(64, 48), embed_dim=64, depth=3, num_heads=4)
R = 2


def _vit(dtype, seed=0):
    jcfg, tcfg = JViT(**SHAPE, compute_dtype=dtype), ViTConfig(**SHAPE, compute_dtype=dtype)
    params = jax.tree_util.tree_map(jnp.asarray, numpy_params(lambda k: jinit_vit(k, jcfg), seed))
    x = np.random.default_rng(seed + 1).normal(size=(2, 64, 48, 3)).astype(np.float32)
    return jcfg, tcfg, params, x


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("n", [12, 13])
def test_merge_matches_jax(dtype, n):
    """Same merges, same size-weighted sums: f32 to the last bits of the
    sums' order, bf16 bit for bit (JAX's one-hot product sums in f32 and
    rounds once, as the port's f32 scatter-add)."""
    rng = np.random.default_rng(n)
    tok = rng.normal(size=(2, n, 8)).astype(np.float32)
    sizes = rng.integers(1, 4, (2, n)).astype(np.float32)
    for r in (1, 3, 10):
        ref_t, ref_s = jax_exact(lambda t, s: jtome.bipartite_soft_matching_merge(
            t.astype(dtype), s.astype(dtype), r), tok, sizes)
        got_t, got_s = tome.bipartite_soft_matching_merge(
            torch.from_numpy(tok).to(getattr(torch, dtype)),
            torch.from_numpy(sizes).to(getattr(torch, dtype)), r)
        assert got_t.shape == ref_t.shape == (2, n - min(r, (n + 1) // 2 - 1), 8)
        g, rt = got_t.float().numpy(), np.asarray(ref_t.astype(jnp.float32))
        np.testing.assert_array_equal(got_s.float().numpy(), np.asarray(ref_s.astype(jnp.float32)))
        if dtype == "bfloat16":
            np.testing.assert_array_equal(g, rt)
        else:
            np.testing.assert_allclose(g, rt, rtol=1e-6, atol=1e-6)


def test_merge_conserves_mass():
    rng = np.random.default_rng(0)
    tok = torch.from_numpy(rng.normal(size=(2, 12, 8)).astype(np.float32))
    out, sizes = tome.bipartite_soft_matching_merge(tok, torch.ones(2, 12), 3)
    assert out.shape == (2, 9, 8)
    np.testing.assert_allclose(sizes.sum(-1).numpy(), 12.0, atol=1e-5)
    np.testing.assert_allclose((out * sizes[..., None]).sum(1).numpy(), tok.sum(1).numpy(),
                               atol=1e-4)


def test_merges_duplicates_first():
    """Identical token pairs merge before distinct ones."""
    tok = np.zeros((1, 8, 4), np.float32)
    tok[0, 0] = tok[0, 1] = [1, 0, 0, 0]  # A0 identical to B0
    tok[0, 2:8] = [[0, 1, 0, 0], [0, 0, 1, 0], [0, 0, 0, 1], [1, 1, 0, 0], [0, 1, 1, 0],
                   [1, 0, 1, 0]]
    out, sizes = tome.bipartite_soft_matching_merge(torch.from_numpy(tok), torch.ones(1, 8), 1)
    np.testing.assert_allclose(out[0, 0].numpy(), [1, 0, 0, 0], atol=1e-5)
    assert sizes[0, 0] == 2.0


def test_merge_with_nothing_to_merge_is_the_identity():
    tok = torch.randn(1, 3, 4, generator=torch.Generator().manual_seed(0))
    sizes = torch.ones(1, 3)
    for n, r in ((3, 0), (1, 4)):
        t, s = tome.bipartite_soft_matching_merge(tok[:, :n], sizes[:, :n], r)
        assert t is not None and torch.equal(t, tok[:, :n]) and torch.equal(s, sizes[:, :n])


def test_merges_replayed_from_another_run_give_its_tokens(monkeypatch):
    """vit_forward_tome is embed_tokens + vit_blocks_tome, and its merges all
    go through tome.bipartite_matching: the choices recorded in one run and
    handed back in a second give the first run's tokens bit for bit (the
    card's test of the int8 forward against the CPU's fixes the choices so)."""
    from hamer_yolo_tpu_torch.models.vit import embed_tokens

    jcfg, tcfg, params, x = _vit("float32")
    tree = to_port(_int8_trees(params, x, jcfg)["dynamic"])
    xt = torch.from_numpy(x)
    match, seen = tome.bipartite_matching, []
    monkeypatch.setattr(tome, "bipartite_matching", lambda t, r: seen.append(match(t, r))
                        or seen[-1])
    first = tome.vit_forward_tome(tree, xt, tcfg, R)
    assert len(seen) == 3 and all(m[0].shape == (2, R) for m in seen)
    replay = iter(seen)
    monkeypatch.setattr(tome, "bipartite_matching", lambda t, r: next(replay))
    again = tome.vit_blocks_tome(tree, embed_tokens(tree, xt, tcfg), tcfg, R)
    assert torch.equal(again, first)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_vit_forward_tome_matches_jax(dtype):
    """bf16 / f32 weights: the plain attention on both sides. f32 to
    reassociation; bf16 at the JAX package's bf16 ViT tolerance
    (tests/test_pallas_kernels.py:164-167)."""
    jcfg, tcfg, params, x = _vit(dtype)
    ref = np.asarray(jax_exact(lambda p, xx: jtome.vit_forward_tome(p, xx, jcfg, r_per_layer=R),
                               params, jnp.asarray(x)).astype(jnp.float32))
    got = tome.vit_forward_tome(to_port(params), torch.from_numpy(x), tcfg, R).float().numpy()
    assert got.shape == ref.shape == (2, 12 - 3 * R, 64)
    tol = 1e-4 if dtype == "float32" else 0.05
    np.testing.assert_allclose(got, ref, rtol=tol, atol=tol)


def _int8_trees(params, x, jcfg):
    pq = jax.jit(jquant.quantize_vit_params)(params)
    stats = jax_exact(lambda p, xx: jquant.collect_vit_act_stats(p, xx, jcfg), pq, jnp.asarray(x))
    return {"dynamic": pq, "static": jax.jit(jquant.attach_static_act_scales)(pq, stats)}


@pytest.mark.parametrize("scales", ["static", "dynamic"])
def test_vit_forward_tome_int8_unfused_matches_jax(scales):
    """Over int8 weights on the CPU both sides run the unfused composition
    (JAX: not on a TPU; the port: not on CUDA); test_torch_int8_vit's f32
    limits for it."""
    jcfg, tcfg, params, x = _vit("float32")
    tree = _int8_trees(params, x, jcfg)[scales]
    ref = np.asarray(jax_exact(lambda p, xx: jtome.vit_forward_tome(p, xx, jcfg, r_per_layer=R),
                               tree, jnp.asarray(x)))
    got = tome.vit_forward_tome(to_port(tree), torch.from_numpy(x), tcfg, R).numpy()
    assert got.shape == ref.shape
    assert np.isclose(got, ref, rtol=1e-3, atol=1e-3).mean() > 0.99
    np.testing.assert_allclose(got, ref, rtol=0.05, atol=0.05)


@pytest.mark.parametrize("scales", ["static", "dynamic"])
def test_vit_forward_tome_int8_fused_matches_jax_fused(scales):
    """The kernel dispatch at ToMe's token counts (12, 10, 8): the port's
    plain versions of K3 + K4 (static) or K5 + K7 + K5 and K5 twice
    (dynamic) against JAX's Pallas kernels in interpret mode, at
    test_torch_int8_vit's tolerance for it."""
    jcfg, tcfg, params, x = _vit("float32")
    tree = _int8_trees(params, x, jcfg)[scales]
    ref = np.asarray(jax_exact(lambda p, xx: jtome.vit_forward_tome(
        p, xx, jcfg, r_per_layer=R, fused=True, interpret=True), tree, jnp.asarray(x)))
    got = tome.vit_forward_tome(to_port(tree), torch.from_numpy(x), tcfg, R, fused=True).numpy()
    assert got.shape == ref.shape
    np.testing.assert_allclose(got, ref, rtol=0.05, atol=0.05)


def test_tome_fused_path_runs_the_int8_dispatch(monkeypatch):
    """fused=True sends every block through quant's int8 block dispatch (the
    kernels on CUDA tensors), the unfused composition is not touched."""
    jcfg, tcfg, params, x = _vit("float32")
    tree = to_port(_int8_trees(params, x, jcfg)["static"])
    calls = []
    for name in ("int8_block_attn_residual", "int8_block_mlp_residual"):
        fn = getattr(quant, name)
        monkeypatch.setattr(quant, name, lambda *a, _f=fn, _n=name, **k: calls.append(_n)
                            or _f(*a, **k))
    monkeypatch.setattr(quant, "int8_mha_self_attention", None)
    tome.vit_forward_tome(tree, torch.from_numpy(x), tcfg, R, fused=True)
    assert calls == ["int8_block_attn_residual", "int8_block_mlp_residual"] * 3


@pytest.mark.parametrize("int8", [False, True], ids=["tome", "int8_tome"])
def test_hamer_forward_tome_matches_jax(int8):
    """hamer_forward's tome_r branch (composed with the int8 backbone), f32,
    on the --tiny HaMeR."""
    jcfg, tcfg = tiny_configs("float32")
    jh = dataclasses.replace(jcfg.hamer, tome_r=2, int8_backbone=int8)
    th = dataclasses.replace(tcfg.hamer, tome_r=2, int8_backbone=int8)
    params = jax.tree_util.tree_map(jnp.asarray, pipeline_params(jcfg, seed=6)["hamer"])
    if int8:
        params = {**params, "backbone": jax.jit(jquant.quantize_vit_params)(params["backbone"])}
    jm, tm = mano_pair()
    x = np.random.default_rng(7).normal(size=(3, 64, 64, 3)).astype(np.float32)
    ref = jax_exact(lambda p, xx: jax_hamer_forward(p, jm, xx, jh), params, jnp.asarray(x))
    got = hamer_forward(to_port(params), tm, torch.from_numpy(x), th)
    for k in ("pred_cam", "pred_vertices", "pred_keypoints_3d"):
        g, r = got[k].numpy(), np.asarray(ref[k])
        if int8:  # the unfused int8 limits of test_torch_int8_vit
            np.testing.assert_allclose(g, r, rtol=0.05, atol=0.05, err_msg=k)
        else:
            np.testing.assert_allclose(g, r, rtol=1e-4, atol=1e-4, err_msg=k)
