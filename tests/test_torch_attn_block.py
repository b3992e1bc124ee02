"""Kernel K2 (fused LN + QKV GEMM + attention) and the ViT backbone: the
port's plain twin against the JAX Pallas kernel in interpret mode, and
vit_forward (depth 2) on its plain path and on its fused path against the
JAX package's two paths."""
from dataclasses import replace
from functools import partial

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import hamer_yolo_tpu.ops.attention_pallas as jax_attention_pallas
from hamer_yolo_tpu.models.vit import ViTConfig as JaxViTConfig
from hamer_yolo_tpu.models.vit import init_vit as jax_init_vit
from hamer_yolo_tpu.models.vit import vit_forward as jax_vit_forward
from hamer_yolo_tpu_torch.models.vit import ViTConfig, vit_forward
from hamer_yolo_tpu_torch.core.nn import weak_scalar
from hamer_yolo_tpu_torch.ops.attn_block import (check_against_twin, fused_bf16_attn_block,
                                                  fused_bf16_attn_block_ref)
from test_torch_bridge import jax_exact, numpy_params, to_port

torch.set_num_threads(1)

DT = {"bfloat16": (jnp.bfloat16, torch.bfloat16), "float32": (jnp.float32, torch.float32)}


@pytest.mark.parametrize("h,hd", [(2, 16), (3, 24)])
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_twin_matches_pallas_interpret(h, hd, dtype):
    rng = np.random.default_rng(h * hd)
    B, N, K = 3, 24, 48
    tok = rng.normal(size=(B, N, K)).astype(np.float32)
    w = (rng.normal(size=(K, 3 * h * hd)) * K ** -0.5).astype(np.float32)
    b, g, beta = (rng.normal(size=n).astype(np.float32) for n in (3 * h * hd, K, K))
    g = 1.0 + 0.1 * g
    jdt, tdt = DT[dtype]
    ref = jax_attention_pallas.fused_bf16_attn_block(
        jnp.asarray(tok).astype(jdt), jnp.asarray(w), jnp.asarray(b), jnp.asarray(g),
        jnp.asarray(beta), h, interpret=True)
    got = fused_bf16_attn_block(torch.from_numpy(tok).to(tdt), torch.from_numpy(w),
                                torch.from_numpy(b), torch.from_numpy(g),
                                torch.from_numpy(beta), h)
    assert got.dtype == tdt and got.shape == (B, N, h * hd)
    # Both round at the same points (LN f32 -> bf16, qkv f32 + bias -> bf16,
    # bf16 q * bf16 scale, p -> bf16). In bf16 the outputs agree to one
    # bf16 ulp at most (f32 reduction order); f32 outputs skip the last
    # rounding, so only the f32 sum order shows.
    tol = dict(rtol=1e-2, atol=1e-2) if dtype == "bfloat16" else dict(rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got.float().numpy(), np.asarray(ref.astype(jnp.float32)), **tol)


def test_wrapper_takes_twin_on_cpu():
    rng = np.random.default_rng(0)
    args = [torch.from_numpy(a.astype(np.float32)) for a in (
        rng.normal(size=(2, 16, 32)), rng.normal(size=(32, 96)), rng.normal(size=96),
        rng.normal(size=32), rng.normal(size=32))]
    args[0] = args[0].bfloat16()
    before = fused_bf16_attn_block.launches
    assert torch.equal(fused_bf16_attn_block(*args, 2), fused_bf16_attn_block_ref(*args, 2))
    assert fused_bf16_attn_block.launches == before


def _twin_variant(tok, w, bias, g, beta, h, skip=None):
    """K2's math with f64 sums (a kernel that only sums in another order) and,
    with ``skip``, one of its bf16 rounding points left out."""
    B, N, K = tok.shape
    hd = w.shape[1] // 3 // h
    x = tok.double()
    mu = x.mean(-1, keepdim=True)
    x = ((x - mu) * torch.rsqrt(torch.square(x - mu).mean(-1, keepdim=True) + 1e-6)).float()
    x = x * g + beta
    if skip != "ln":
        x = x.to(torch.bfloat16).float()
    qkv = (x.double() @ w.to(torch.bfloat16).double()).float() + bias
    qkv = qkv.to(torch.bfloat16).float().reshape(B, N, 3, h, hd)
    scale = hd ** -0.5 if skip == "scale" else weak_scalar(hd ** -0.5, torch.bfloat16)
    q = qkv[:, :, 0] * scale
    if skip != "q_scale":
        q = q.to(torch.bfloat16).float()
    logits = torch.einsum("bnhd,bmhd->bhnm", q.double(), qkv[:, :, 1].double())
    e = torch.exp(logits - logits.amax(-1, keepdim=True))
    p = (e / e.sum(-1, keepdim=True)).float()
    if skip != "p":
        p = p.to(torch.bfloat16).float()
    out = torch.einsum("bhnm,bmhd->bnhd", p.double(), qkv[:, :, 2].double()).float()
    return out.reshape(B, N, h * hd).to(tok.dtype)


@pytest.mark.parametrize("skip", [None, "ln", "scale", "q_scale", "p"])
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_twin_tolerance_catches_a_skipped_rounding(skip, dtype):
    """The limits that hold K2 to its twin on the card pass a version that
    only sums in another order and fail one that skips a rounding point."""
    rng = np.random.default_rng(7)
    B, N, K, h = 2, 96, 192, 2
    f = lambda *s: torch.from_numpy(rng.normal(size=s).astype(np.float32))  # noqa: E731
    tok = f(B, N, K).to(DT[dtype][1])
    args = (f(K, 3 * K) * K ** -0.5, 0.1 * f(3 * K), 1.0 + 0.1 * f(K), 0.1 * f(K), h)
    ref = fused_bf16_attn_block_ref(tok, *args)
    got = _twin_variant(tok, *args, skip=skip)
    if skip is None:
        check_against_twin(got, ref)
    else:
        with pytest.raises(AssertionError, match="disagrees with its twin"):
            check_against_twin(got, ref)


def _vit_setup(dtype):
    kw = dict(img_size=(64, 48), embed_dim=64, depth=2, num_heads=4, compute_dtype=dtype)
    jcfg, tcfg = JaxViTConfig(**kw), ViTConfig(**kw)
    params = numpy_params(lambda k: jax_init_vit(k, jcfg), seed=3)
    x = np.random.default_rng(3).normal(size=(4, 64, 48, 3)).astype(np.float32)
    return jcfg, tcfg, params, x


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_vit_plain_path_matches_jax(dtype, monkeypatch):
    monkeypatch.setenv("HYT_ATTN_BF16", "off")
    jcfg, tcfg, params, x = _vit_setup(dtype)
    jp = jax.tree_util.tree_map(jnp.asarray, params)
    ref = jax_exact(lambda i: jax_vit_forward(jp, i, jcfg), jnp.asarray(x))
    got = vit_forward(to_port(params), torch.from_numpy(x), replace(tcfg, fused_attn=False))
    _check_vit(got, ref, dtype)


def test_vit_fused_path_matches_jax(monkeypatch):
    """The JAX accelerator path (HYT_ATTN_BF16=megakernel, the Pallas block
    in interpret mode) against the port's fused path (K2's twin on CPU)."""
    monkeypatch.setenv("HYT_ATTN_BF16", "megakernel")
    monkeypatch.setattr(jax_attention_pallas, "fused_bf16_attn_block",
                        partial(jax_attention_pallas.fused_bf16_attn_block, interpret=True))
    jcfg, tcfg, params, x = _vit_setup("bfloat16")
    jp = jax.tree_util.tree_map(jnp.asarray, params)
    ref = jax_exact(lambda i: jax_vit_forward(jp, i, jcfg), jnp.asarray(x))
    got = vit_forward(to_port(params), torch.from_numpy(x), replace(tcfg, fused_attn=True))
    _check_vit(got, ref, "bfloat16")


def _check_vit(got, ref, dtype):
    ref = np.asarray(ref.astype(jnp.float32))
    got = got.float().numpy()
    assert got.shape == ref.shape == (4, 12, 64)
    if dtype == "float32":
        # f32 sum order and XLA's approximate f32 rsqrt (1 ulp) only
        np.testing.assert_allclose(got, ref, rtol=1e-4, atol=1e-4)
    else:
        # bf16 conv/matmul accumulation order flips single bf16 ulps, which
        # two blocks carry on: the JAX package's own bf16-vs-reference
        # tolerance (tests/test_pallas_kernels.py:164-167).
        np.testing.assert_allclose(got, ref, rtol=0.05, atol=0.05)


@pytest.mark.parametrize("env", ["megakernel", "off"])
def test_vit_reads_hyt_attn_bf16_as_jax(env, monkeypatch):
    """fused_attn None: HYT_ATTN_BF16 picks the path on any device, as JAX's
    models/vit.py reads it: "megakernel" K2 (its twin on the CPU; JAX's
    Pallas block in interpret mode), "off" the plain layers."""
    import hamer_yolo_tpu_torch.models.vit as tvit

    monkeypatch.setenv("HYT_ATTN_BF16", env)
    monkeypatch.setattr(jax_attention_pallas, "fused_bf16_attn_block",
                        partial(jax_attention_pallas.fused_bf16_attn_block, interpret=True))
    calls = []
    k2 = tvit.fused_bf16_attn_block
    monkeypatch.setattr(tvit, "fused_bf16_attn_block", lambda *a: calls.append(1) or k2(*a))
    jcfg, tcfg, params, x = _vit_setup("bfloat16")
    jp = jax.tree_util.tree_map(jnp.asarray, params)
    ref = jax_exact(lambda i: jax_vit_forward(jp, i, jcfg), jnp.asarray(x))
    got = vit_forward(to_port(params), torch.from_numpy(x), tcfg)
    assert len(calls) == (jcfg.depth if env == "megakernel" else 0)
    _check_vit(got, ref, "bfloat16")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_vit_leaves_hyt_attn_to_the_frame(dtype, monkeypatch):
    """HYT_ATTN is the frame program's switch (pipeline/frame._select_attn_impl),
    not the ViT's: vit_forward without ``attn_impl`` keeps the plain
    attention whatever it names, as JAX's does for every caller but the
    frame, and matches JAX's there; handed fast_mha_self_attention, the ViT
    runs it in every block and keeps K2 off."""
    import hamer_yolo_tpu_torch.models.vit as tvit
    from hamer_yolo_tpu_torch.ops import short_attention

    monkeypatch.setenv("HYT_ATTN", "pallas_direct")
    monkeypatch.delenv("HYT_ATTN_BF16", raising=False)
    calls = []
    k7 = short_attention.fused_short_attention
    monkeypatch.setattr(short_attention, "fused_short_attention",
                        lambda *a, **kw: calls.append(1) or k7(*a, **kw))
    monkeypatch.setattr(tvit, "fused_bf16_attn_block", lambda *a: calls.append("K2"))
    jcfg, tcfg, params, x = _vit_setup(dtype)
    jp = jax.tree_util.tree_map(jnp.asarray, params)
    ref = jax_exact(lambda i: jax_vit_forward(jp, i, jcfg), jnp.asarray(x))
    got = vit_forward(to_port(params), torch.from_numpy(x), tcfg)
    assert calls == []
    _check_vit(got, ref, dtype)
    mha = partial(short_attention.fast_mha_self_attention, force="pallas_direct")
    vit_forward(to_port(params), torch.from_numpy(x), replace(tcfg, fused_attn=True),
                attn_impl=mha)
    assert calls == [1] * jcfg.depth
