"""The int8 GEMM launch alone (ops/int8_matmul.int8_gemm_ref, the plain
version of csrc/int8_gemm.cu's GEMM) against the JAX package's matching
steps, and the K-major weight copies the card's GEMM reads.

Each epilogue is held to the JAX step that computes it, on an int8 input
given directly (where the JAX step quantizes first, its input is the int8
values times a power of two, which that quantize maps back exactly), with
the JAX side in interpret mode and compiled as ``jax_exact`` compiles it:
EPI_DEQ_ROW against K5's ``_kernel`` (static and per-row scales), EPI_GELU_Q
against the GEMM half of ``_mlp1_kernel`` (its LN prologue made the
identity), EPI_DEQ_FOLD and EPI_RESID against ``_mlp2_kernel`` (FOLD with a
zero residual), EPI_PROJ against ``tok + int8_dot_prequant``, the unfused
step K3's proj epilogue is bit-identical to. Tolerances are the existing
int8 tests' (tests/test_torch_int8_kernels.py)."""
import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl

from hamer_yolo_tpu.core import quant as jquant
from hamer_yolo_tpu.ops import int8_matmul as jm
from hamer_yolo_tpu_torch.core import nn, quant
from hamer_yolo_tpu_torch.models.vit import init_vit
from hamer_yolo_tpu_torch.ops import int8_matmul as im
from test_torch_bridge import jax_exact, to_port
from test_torch_int8_kernels import _linear, _np, _t
from test_torch_int8_vit import _setup

torch.set_num_threads(1)

M, K, N = 96, 256, 384
POW2 = np.float32(2.0 ** -5)  # q * POW2 quantizes back to q exactly


def _operands(seed, K=K, N=N):
    rng = np.random.default_rng(seed)
    q = rng.integers(-127, 128, (M, K)).astype(np.int8)
    q[:, 0] = 127  # every row's absmax is 127: a per-row scale of ~POW2
    w, ws, b = _linear(rng, K, N)
    return rng, q, w, ws, b


def _tol(dtype):
    # f32: the JAX package's 1e-5; bf16: one rounding of the same f32 value
    return 1e-5 if dtype == "float32" else 2.0 ** -8


def _mlp_call(kernel, args, out_dtype, tm=32):
    """One of K4's pallas_calls on full-width blocks of tm rows, in
    interpret mode (fused_int8_mlp_block's specs)."""
    Mx = args[0].shape[0]
    specs = [pl.BlockSpec((tm, a.shape[1]), lambda i: (i, 0)) if a.shape[0] == Mx
             else pl.BlockSpec(a.shape, lambda i: (0, 0)) for a in args]
    Nout = args[1].shape[1]
    return pl.pallas_call(kernel, grid=(Mx // tm,), in_specs=specs,
                          out_specs=pl.BlockSpec((tm, Nout), lambda i: (i, 0)),
                          out_shape=jax.ShapeDtypeStruct((Mx, Nout), out_dtype),
                          interpret=True)(*args)


class TestEpiloguesMatchJax:
    @pytest.mark.parametrize("static", [False, True], ids=["per_row", "static"])
    @pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
    def test_deq_row_matches_k5(self, static, dtype):
        _, q, w, ws, b = _operands(30)
        x = q.astype(np.float32) * POW2
        ref = jax_exact(lambda xx: jm.fused_int8_matmul(
            xx, jnp.asarray(w), jnp.asarray(ws), jnp.asarray(b), prologue="id", tm=32, tn=128,
            interpret=True, static_scale=jnp.asarray(POW2) if static else None),
            jnp.asarray(x).astype(dtype))
        if static:
            kw = {"s": _t(POW2)}
        else:  # fused_int8_matmul_ref's per-row scale
            scale = torch.clamp(_t(x).abs().amax(-1) * im.RECIP_127, min=1e-8)
            assert torch.equal(im.quantize_rows_ref(_t(x), scale[:, None]), _t(q))
            kw = {"row_scale": scale}
        got = im.int8_gemm_ref(_t(q), _t(w), im.EPI_DEQ_ROW, _t(ws), _t(b),
                               out_dtype=getattr(torch, dtype), **kw)
        assert got.dtype == getattr(torch, dtype) and got.shape == (M, N)
        np.testing.assert_allclose(_np(got), np.asarray(ref, np.float32), rtol=_tol(dtype),
                                   atol=_tol(dtype))

    @pytest.mark.parametrize("gelu", ["gelu", "gelu_poly"])
    def test_gelu_q_matches_mlp1(self, gelu, monkeypatch):
        _, q, w, ws, b = _operands(31, N=512)
        x = q.astype(np.float32) * POW2
        s2 = np.float32(0.021)
        prologue = jm._prologue_f32
        # _mlp1_kernel's GEMM half: its LN prologue made the identity
        monkeypatch.setattr(jm, "_prologue_f32", lambda v, p, g, bt: v if p == "ln"
                            else prologue(v, p, g, bt))
        args = (jnp.asarray(x), jnp.asarray(w), jnp.asarray(ws).reshape(1, -1),
                jnp.asarray(b).reshape(1, -1), jnp.ones((1, K), jnp.float32),
                jnp.zeros((1, K), jnp.float32), jnp.asarray(POW2).reshape(1, 1),
                jnp.asarray(s2).reshape(1, 1))
        ref = jax_exact(lambda *a: _mlp_call(functools.partial(jm._mlp1_kernel, gelu=gelu), a,
                                             jnp.int8), *args)
        got = im.int8_gemm_ref(_t(q), _t(w), im.EPI_GELU_Q, _t(ws), _t(b), s=_t(POW2),
                               out_scale=_t(s2), gelu=gelu)
        assert got.dtype == torch.int8
        # int8 within 1 (tests/test_pallas_kernels.py:127): a value on a
        # rounding boundary may land on either side
        diff = np.abs(got.numpy().astype(np.int32) - np.asarray(ref, np.int32))
        assert diff.max() <= 1 and (diff > 0).mean() < 0.01

    @pytest.mark.parametrize("epi", ["fold", "resid"])
    @pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
    def test_fold_and_resid_match_mlp2(self, epi, dtype):
        rng, q, w, ws, b = _operands(32)
        s2 = np.float32(0.021)
        tok = (rng.normal(size=(M, N)).astype(np.float32) if epi == "resid"
               else np.zeros((M, N), np.float32))
        tok_j = jnp.asarray(tok).astype(dtype)
        args = (jnp.asarray(q), jnp.asarray(w), jnp.asarray(ws).reshape(1, -1),
                jnp.asarray(b).reshape(1, -1), jnp.asarray(s2).reshape(1, 1), tok_j)
        ref = jax_exact(lambda *a: _mlp_call(jm._mlp2_kernel, a, tok_j.dtype), *args)
        tok_t = _t(np.asarray(tok_j, np.float32)).to(getattr(torch, dtype))
        if epi == "resid":
            got = im.int8_gemm_ref(_t(q), _t(w), im.EPI_RESID, _t(ws), _t(b), s=_t(s2),
                                   res=tok_t, out_dtype=tok_t.dtype)
        else:
            got = im.int8_gemm_ref(_t(q), _t(w), im.EPI_DEQ_FOLD, _t(ws), _t(b), s=_t(s2),
                                   out_dtype=tok_t.dtype)
        assert got.dtype == tok_t.dtype
        np.testing.assert_allclose(_np(got), np.asarray(ref, np.float32), rtol=_tol(dtype),
                                   atol=_tol(dtype))

    @pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
    def test_proj_matches_prequant_residual(self, dtype):
        rng, q, w, ws, b = _operands(33)
        sp = np.float32(0.012)
        tok = jnp.asarray(rng.normal(size=(M, N)).astype(np.float32)).astype(dtype)
        ref = jax_exact(lambda t, a: t + jm.int8_dot_prequant(
            a, jnp.asarray(w), jnp.asarray(ws), jnp.asarray(b), jnp.asarray(sp),
            out_dtype=t.dtype), tok, jnp.asarray(q))
        tok_t = _t(np.asarray(tok, np.float32)).to(getattr(torch, dtype))
        got = im.int8_gemm_ref(_t(q), _t(w), im.EPI_PROJ, _t(ws), _t(b), s=_t(sp), res=tok_t,
                               out_dtype=tok_t.dtype)
        assert got.dtype == tok_t.dtype
        np.testing.assert_allclose(_np(got), np.asarray(ref, np.float32), rtol=_tol(dtype),
                                   atol=_tol(dtype))


class TestKmajorWeights:
    def test_copy_is_the_transpose(self):
        w = _t(np.random.default_rng(34).integers(-127, 128, (96, 160)).astype(np.int8))
        wt = im.kmajor_weight(w)
        assert wt.dtype == torch.int8 and wt.shape == (160, 96)
        assert wt.is_contiguous() and wt.data_ptr() % 16 == 0
        assert torch.equal(wt, w.t())

    def test_made_once_per_weight(self):
        w = _t(np.random.default_rng(35).integers(-127, 128, (64, 48)).astype(np.int8))
        before = im.kmajor_weight.transposes
        first = im.kmajor_weight(w)
        assert im.kmajor_weight(w) is first and im.kmajor_weight.transposes == before + 1
        w[0, 0] = -w[0, 0] - 1  # an in-place change makes the copy anew
        again = im.kmajor_weight(w)
        assert im.kmajor_weight.transposes == before + 2 and torch.equal(again, w.t())

    def test_freed_with_its_weight(self):
        w = torch.zeros((32, 16), dtype=torch.int8)
        im.kmajor_weight(w)
        key = (id(w), "kmajor")
        assert key in nn._DERIVED
        del w
        assert key not in nn._DERIVED

    @pytest.mark.parametrize("scales", ["static", "dynamic"])
    def test_prepared_tree_makes_no_copy_in_a_forward(self, scales):
        """On the CPU no K-major copy is made: not by quantize_vit_params
        (it makes them for weights on the card only) and not by two forwards
        (the plain versions read JAX's (K, N) weights); and the int8 ViT still
        matches JAX's fused int8 ViT at the JAX package's tolerance
        (tests/test_int8_fused.py:509-510). The card's side:
        tests/test_torch_cuda.py::test_int8_vit_makes_kmajor_copies_once."""
        jcfg, tcfg, trees, x, _ = _setup()
        port = to_port(trees[scales])
        im.kmajor_weight.transposes = 0
        quant.quantize_vit_params(init_vit(torch.Generator().manual_seed(0), tcfg))
        assert im.kmajor_weight.transposes == 0
        ref = jax_exact(lambda p, xx: jquant.vit_forward_int8(p, xx, jcfg, fused=True,
                                                              interpret=True),
                        trees[scales], jnp.asarray(x))
        for _ in range(2):
            got = quant.vit_forward_int8(port, torch.from_numpy(x), tcfg, fused=True)
            np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=0.05, atol=0.05)
        assert im.kmajor_weight.transposes == 0
