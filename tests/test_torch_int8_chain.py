"""K5's chain form (JAX's _xla_chain above FUSED_GEMM_MAX_M rows, and
HYT_INT8_EP) against the JAX package on the CPU, on numpy-made inputs.

Above 8192 rows JAX's fused_int8_matmul leaves its Pallas kernel for an
inline XLA chain with other arithmetic: the prologue, the absmax and the
quantize division in the tokens' dtype, and the dequant acc * (sx * sw) + b
in f32 or, under HYT_INT8_EP=bf16, in bf16. The port computes the same above
the same limit (ops/int8_matmul.fused_int8_chain_ref on the CPU).

Limits: bf16 tokens are bit-equal to JAX compiled with excess precision off
(test_torch_bridge.jax_exact; ROADMAP F6), every prologue, static and
dynamic, both HYT_INT8_EP values. f32 tokens: XLA's CPU code sums LN's
means in its own order and contracts some f32 multiply-adds the port leaves
apart, so a prologue output moves by an ulp; where one sits within an ulp
of an int8 rounding midpoint it lands on the neighbouring int8 value and
moves its row by one int8 step. The f32 cases hold every row but
F32_FLIP_ROWS of them to the JAX package's own f32 limit for this kernel
(1e-5, tests/test_int8_fused.py:57-58) and every element to F32_MAX_ERR of
the output's largest magnitude (one int8 step of a 64-long product is about
0.4% of it here; a wrong form is off by 1% and more in most rows).
"""
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from hamer_yolo_tpu.ops import int8_matmul as jim
from hamer_yolo_tpu_torch.ops import int8_matmul as im
from test_torch_bridge import jax_exact
from test_torch_int8_kernels import _linear, _ln, _t

torch.set_num_threads(1)

M, K, N = 8448, 64, 48  # 8448 rows: above FUSED_GEMM_MAX_M = 8192
F32_TOL = 1e-5
F32_FLIP_ROWS = 0.001
F32_MAX_ERR = 0.01


@pytest.fixture(scope="module")
def inputs():
    rng = np.random.default_rng(29)
    x = (2.0 * rng.normal(size=(M, K))).astype(np.float32)
    return x, _linear(rng, K, N), _ln(rng, K)


def _jax_k5(x, lin, ln, prologue, sx, dtype, **kw):
    q, s, b = (jnp.asarray(a) for a in lin)
    g, bt = (jnp.asarray(a) for a in ln) if prologue == "ln" else (None, None)
    return np.asarray(jax_exact(lambda xx: jim.fused_int8_matmul(
        xx, q, s, b, g, bt, prologue=prologue, interpret=True,
        static_scale=None if sx is None else jnp.asarray(sx), **kw),
        jnp.asarray(x).astype(dtype)), np.float32)


def _port_k5(x, lin, ln, prologue, sx, dtype, **kw):
    g, bt = (_t(a) for a in ln) if prologue == "ln" else (None, None)
    got = im.fused_int8_matmul(_t(x).to(getattr(torch, dtype)), *(_t(a) for a in lin), g, bt,
                               prologue=prologue, static_scale=None if sx is None else _t(sx),
                               **kw)
    assert got.dtype == getattr(torch, dtype)
    return got.float().numpy()


def _hold(got, ref, dtype):
    if dtype == "bfloat16":
        np.testing.assert_array_equal(got, ref)
        return
    d = np.abs(got - ref)
    rows = (d > F32_TOL * np.abs(ref) + F32_TOL).any(-1).mean()
    assert rows <= F32_FLIP_ROWS, rows
    assert d.max() <= F32_MAX_ERR * np.abs(ref).max(), d.max()


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("static", [False, True], ids=["dynamic", "static"])
@pytest.mark.parametrize("prologue", ["ln", "gelu", "gelu_poly", "id"])
def test_chain_above_the_limit_matches_jax(inputs, monkeypatch, prologue, static, dtype):
    """M = 8448 > 8192: the port's K5 computes JAX's chain, under HYT_INT8_EP
    unset and "bf16" (read at each call in both packages)."""
    x, lin, ln = inputs
    sx = np.float32(0.031) if static else None
    for ep in (None, "bf16"):
        if ep is None:
            monkeypatch.delenv("HYT_INT8_EP", raising=False)
        else:
            monkeypatch.setenv("HYT_INT8_EP", ep)
        ref = _jax_k5(x, lin, ln, prologue, sx, dtype)
        _hold(_port_k5(x, lin, ln, prologue, sx, dtype), ref, dtype)


def test_force_picks_the_form(inputs, monkeypatch):
    """``force``: "xla" takes the chain below the limit, "pallas" the kernel
    form above it, as JAX's keyword does (its Pallas kernel in interpret
    mode; the kernel form at the K5 parity test's 2^-8, bf16 out)."""
    x, lin, ln = inputs
    monkeypatch.delenv("HYT_INT8_EP", raising=False)
    small = x[:256]
    ref = _jax_k5(small, lin, ln, "ln", None, "bfloat16", force="xla")
    np.testing.assert_array_equal(_port_k5(small, lin, ln, "ln", None, "bfloat16",
                                           force="xla"), ref)
    big = x[:1024]
    monkeypatch.setattr(jim, "FUSED_GEMM_MAX_M", 512)
    monkeypatch.setattr(im, "FUSED_GEMM_MAX_M", 512)
    ref = _jax_k5(big, lin, ln, "ln", None, "bfloat16", force="pallas", tm=256, tn=48)
    got = _port_k5(big, lin, ln, "ln", None, "bfloat16", force="pallas")
    np.testing.assert_allclose(got, ref, rtol=2.0 ** -8, atol=2.0 ** -8)
    with pytest.raises(ValueError, match="force"):
        _port_k5(small, lin, ln, "ln", None, "bfloat16", force="chain")


def test_parent_form_is_not_the_chain(inputs, monkeypatch):
    """The control: the kernel form (the port's K5 before the chain was
    ported, which ran it at every M) at M = 8448 is not JAX's result there,
    so the bit-equality above is not a property of any form."""
    x, lin, ln = inputs
    monkeypatch.delenv("HYT_INT8_EP", raising=False)
    ref = _jax_k5(x, lin, ln, "ln", None, "bfloat16")
    got = _port_k5(x, lin, ln, "ln", None, "bfloat16", force="pallas")
    assert (got != ref).mean() > 0.1


def test_infer_frames_crossing_the_limit_matches_jax(monkeypatch):
    """A tiny int8 infer_frames slice with FUSED_GEMM_MAX_M lowered in both
    packages below its flat row count, dynamic scales: every K5 call takes
    the chain (JAX's collapsed-M vmap rule, the port's flat M), at the bf16
    slice's limits (tests/test_torch_pipeline.py). JAX's fused dispatch runs
    on a TPU only: the test gives it quant._on_tpu, the einsum attention
    (HYT_ATTN=xla) and the exact GELU (HYT_GELU=exact), the port fused=True."""
    import dataclasses

    from hamer_yolo_tpu.core import quant as jquant
    from hamer_yolo_tpu.pipeline.frame import infer_frames as jax_infer_frames
    from hamer_yolo_tpu_torch.pipeline.frame import infer_frames
    from test_torch_bridge import mano_pair, np_tree, pipeline_params, tiny_configs, to_port
    from test_torch_pipeline import _check_frame, _inputs

    jm, tm = mano_pair()
    imgs, hws, Ks = _inputs()
    jcfg, tcfg = tiny_configs("bfloat16")
    params = jax.tree_util.tree_map(jnp.asarray, pipeline_params(jcfg, seed=2))
    params["hamer"]["backbone"] = jax.jit(jquant.quantize_vit_params)(params["hamer"]["backbone"])
    jcfg = dataclasses.replace(jcfg, hamer=dataclasses.replace(jcfg.hamer, int8_backbone=True))
    tcfg = dataclasses.replace(tcfg, hamer=dataclasses.replace(
        tcfg.hamer, int8_backbone=True, vit=dataclasses.replace(tcfg.hamer.vit, fused_attn=True)))
    rows = imgs.shape[0] * tcfg.max_hands * tcfg.hamer.vit.num_tokens
    monkeypatch.setattr(jim, "FUSED_GEMM_MAX_M", rows // 2)
    monkeypatch.setattr(im, "FUSED_GEMM_MAX_M", rows // 2)
    monkeypatch.setattr(jquant, "_on_tpu", lambda: True)
    monkeypatch.setenv("HYT_ATTN", "xla")
    monkeypatch.setenv("HYT_GELU", "exact")
    chains = []
    chain_ref = im.fused_int8_chain_ref
    monkeypatch.setattr(im, "fused_int8_chain_ref",
                        lambda *a, **kw: chains.append(1) or chain_ref(*a, **kw))
    ref = np_tree(jax_exact(lambda i, h, k: jax_infer_frames(params, jm, i, h, k, jcfg),
                            imgs, hws, Ks))
    got = np_tree(infer_frames(to_port(params), tm, torch.from_numpy(imgs), torch.from_numpy(hws),
                               torch.from_numpy(Ks), tcfg))
    assert len(chains) == 4 * tcfg.hamer.vit.depth  # qkv, proj, fc1, fc2 of every block
    assert ref["valid"].any(), "no valid slot: the comparison would be empty"
    for b in range(imgs.shape[0]):
        _check_frame({k: v[b] for k, v in got.items()}, {k: v[b] for k, v in ref.items()},
                     "bfloat16", f"frame {b}")
