"""The int8 path's kernels (K3, K4, K5, K7) and quantizers: the port's plain
versions against the JAX package's Pallas kernels in interpret mode, on
the same numpy-made inputs and int8 weights. Tolerances are the JAX
package's own (tests/test_int8_fused.py, tests/test_pallas_kernels.py)."""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from hamer_yolo_tpu.core import quant as jquant
from hamer_yolo_tpu.ops.attention_pallas import fused_int8_attn_proj_block as jax_k3
from hamer_yolo_tpu.ops.attention_pallas import fused_short_attention as jax_k7
from hamer_yolo_tpu.ops.int8_matmul import fused_int8_matmul as jax_k5
from hamer_yolo_tpu.ops.int8_matmul import fused_int8_mlp_block as jax_k4
from hamer_yolo_tpu_torch.core import quant
from hamer_yolo_tpu_torch.core.nn import weak_scalar
from hamer_yolo_tpu_torch.ops import int8_matmul as im
from hamer_yolo_tpu_torch.core.bridge import from_jax_params
from hamer_yolo_tpu_torch.ops.attn_proj_block import fused_int8_attn_proj_block
from hamer_yolo_tpu_torch.ops.int8_matmul import (fused_int8_matmul, fused_int8_mlp_block,
                                                  int8_dot_prequant)
from hamer_yolo_tpu_torch.ops.short_attention import fused_short_attention, softmax_attention_qkv
from test_torch_bridge import jax_exact

torch.set_num_threads(1)


def _t(a):
    return torch.from_numpy(np.array(a))


def _np(t):
    return t.detach().float().numpy() if isinstance(t, torch.Tensor) else np.asarray(t, np.float32)


def _linear(rng, K, N, scale=0.05):
    """A JAX-quantized (K, N) weight, its scales and a bias, as numpy."""
    wq = jax.tree_util.tree_map(np.asarray, jquant.quantize_weight_int8(
        jnp.asarray(rng.normal(size=(K, N)).astype(np.float32) * scale)))
    return wq["q"], wq["scale"], (0.1 * rng.normal(size=N)).astype(np.float32)


def _ln(rng, K):
    return ((1.0 + 0.1 * rng.normal(size=K)).astype(np.float32),
            (0.1 * rng.normal(size=K)).astype(np.float32))


class TestQuantizers:
    def test_weight_quantizer_bit_identical(self):
        # compiled, as the JAX CLI runs quantize_vit_params (eager JAX
        # divides by 127; compiled, it multiplies by f32(1 / 127))
        w = np.random.default_rng(0).normal(size=(96, 160)).astype(np.float32)
        ref = jax.jit(jquant.quantize_weight_int8)(jnp.asarray(w))
        got = quant.quantize_weight_int8(_t(w))
        assert got["q"].dtype == torch.int8
        np.testing.assert_array_equal(got["q"].numpy(), np.asarray(ref["q"]))
        np.testing.assert_array_equal(got["scale"].numpy(), np.asarray(ref["scale"]))

    @pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
    def test_act_quantizer_bit_identical(self, dtype):
        x = (np.random.default_rng(1).normal(size=(6, 40, 64)) * 3).astype(np.float32)
        xj = jnp.asarray(x).astype(dtype)
        q_ref, s_ref = jax_exact(jquant.quantize_act_int8, xj)
        q, s = quant.quantize_act_int8(_t(x).to(getattr(torch, dtype)))
        np.testing.assert_array_equal(q.numpy(), np.asarray(q_ref))
        np.testing.assert_array_equal(_np(s), np.asarray(s_ref, np.float32))

    @pytest.mark.parametrize("static", [False, True], ids=["dynamic", "static"])
    def test_int8_linear(self, static):
        rng = np.random.default_rng(2)
        q, s, b = _linear(rng, 64, 48)
        x = rng.normal(size=(3, 20, 64)).astype(np.float32)
        sx = np.float32(0.027) if static else None
        ref = jquant.int8_linear({"q": jnp.asarray(q), "scale": jnp.asarray(s)}, jnp.asarray(x),
                                 jnp.asarray(b), None if sx is None else jnp.asarray(sx))
        got = quant.int8_linear({"q": _t(q), "scale": _t(s)}, _t(x), _t(b),
                                None if sx is None else _t(sx))
        np.testing.assert_allclose(_np(got), np.asarray(ref), rtol=1e-5, atol=1e-5)

    def test_int8_dot_prequant_matches_jax(self):
        from hamer_yolo_tpu.ops.int8_matmul import int8_dot_prequant as jax_prequant

        rng = np.random.default_rng(3)
        q, s, b = _linear(rng, 64, 32)
        xq = rng.integers(-127, 128, (3, 8, 64)).astype(np.int8)
        sx = np.float32(0.03)
        ref = jax_prequant(jnp.asarray(xq), jnp.asarray(q), jnp.asarray(s), jnp.asarray(b),
                           jnp.asarray(sx), out_dtype=jnp.float32)
        got = int8_dot_prequant(_t(xq), _t(q), _t(s), _t(b), _t(sx), out_dtype=torch.float32)
        np.testing.assert_allclose(_np(got), np.asarray(ref), rtol=1e-5, atol=1e-5)


class TestBridgeAndStats:
    def _tree(self):
        from hamer_yolo_tpu.models.vit import ViTConfig, init_vit

        cfg = ViTConfig(img_size=(32, 32), patch_size=16, patch_padding=0, embed_dim=64,
                        depth=2, num_heads=4, compute_dtype="float32")
        pq = jquant.quantize_vit_params(init_vit(jax.random.PRNGKey(0), cfg))
        x = jnp.asarray(np.random.default_rng(4).normal(size=(2, 32, 32, 3)).astype(np.float32))
        stats = jquant.collect_vit_act_stats(pq, x, cfg)
        return jquant.attach_static_act_scales(pq, stats), stats

    def test_quantized_scale_attached_tree_loads(self):
        ps, _ = self._tree()
        port = from_jax_params(jax.tree_util.tree_map(np.asarray, ps))
        blk, jblk = port["blocks"][1], ps["blocks"][1]
        assert blk["attn"]["qkv"]["wq"]["q"].dtype == torch.int8
        np.testing.assert_array_equal(blk["attn"]["qkv"]["wq"]["q"].numpy(),
                                      np.asarray(jblk["attn"]["qkv"]["wq"]["q"]))
        for lin in (blk["attn"]["proj"], blk["mlp"]["fc2"]):
            assert lin["sx"].shape == () and lin["sx"].dtype == torch.float32
        assert float(blk["mlp"]["fc1"]["sx"]) == float(jblk["mlp"]["fc1"]["sx"])
        n = len(jax.tree_util.tree_leaves(ps))
        assert n == len([t for t in jax.tree_util.tree_leaves(port) if isinstance(t, torch.Tensor)])

    def test_other_int8_leaves_still_raise(self):
        with pytest.raises(KeyError, match="bridge: no mapping"):
            from_jax_params({"wq": {"q": np.zeros((2, 2, 2), np.int8)}})
        with pytest.raises(KeyError, match="bridge: no mapping"):
            from_jax_params({"layer": {"idx": np.zeros(4, np.int32)}})

    def test_stats_npz_both_ways(self, tmp_path):
        _, stats = self._tree()
        jax_file, port_file = str(tmp_path / "jax.npz"), str(tmp_path / "port.npz")
        jquant.save_act_stats(jax_file, jax.device_get(stats))
        got = quant.load_act_stats(jax_file)
        for a, b in zip(got["blocks"], stats["blocks"]):
            assert set(a) == set(b) == set(quant.STAT_KEYS)
            for k in a:
                assert float(a[k]) == float(b[k])
        quant.save_act_stats(port_file, got)
        back = jquant.load_act_stats(port_file)
        for a, b in zip(back["blocks"], stats["blocks"]):
            for k in a:
                assert float(a[k]) == float(b[k])


# On the limits against JAX: compiled for the CPU, JAX contracts a * b + c
# into FMAs and sums in its own order, so a prologue output (LN, GELU)
# differs from the plain version's in the last bit in about half the
# elements. Where such a value sits within an ulp of a rounding midpoint, the
# two quantize it to neighbouring int8 values and one row of the product
# moves by one int8 step (about 5e-3 here). That happens in roughly one of
# 10^5 prologue outputs; the seeded inputs below have none, so the JAX
# package's own limits hold as they are.
class TestK5:
    @pytest.mark.parametrize("prologue", ["ln", "gelu", "gelu_poly", "id"])
    @pytest.mark.parametrize("static", [False, True], ids=["dynamic", "static"])
    @pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
    def test_plain_version_matches_jax(self, prologue, static, dtype):
        rng = np.random.default_rng(11)
        M, K, N = 96, 256, 384
        x = rng.normal(size=(M, K)).astype(np.float32)
        q, s, b = _linear(rng, K, N)
        g, bt = _ln(rng, K)
        sx = np.float32(0.031) if static else None
        ln = prologue == "ln"
        ref = jax_exact(lambda xx: jax_k5(
            xx, jnp.asarray(q), jnp.asarray(s), jnp.asarray(b),
            jnp.asarray(g) if ln else None, jnp.asarray(bt) if ln else None,
            prologue=prologue, tm=64, tn=128, interpret=True,
            static_scale=None if sx is None else jnp.asarray(sx)),
            jnp.asarray(x).astype(dtype))
        before = fused_int8_matmul.launches
        got = fused_int8_matmul(_t(x).to(getattr(torch, dtype)), _t(q), _t(s), _t(b),
                                _t(g) if ln else None, _t(bt) if ln else None,
                                prologue=prologue, static_scale=None if sx is None else _t(sx))
        assert fused_int8_matmul.launches == before  # the plain version counts no launch
        assert got.dtype == getattr(torch, dtype) and got.shape == (M, N)
        # f32: the JAX package's 1e-5 (test_int8_fused.py:57-58); bf16 out:
        # both round the same f32 value, so one bf16 rounding apart at most
        tol = 1e-5 if dtype == "float32" else 2.0 ** -8
        np.testing.assert_allclose(_np(got), np.asarray(ref, np.float32), rtol=tol, atol=tol)


class TestK4:
    @pytest.mark.parametrize("gelu", ["gelu", "gelu_poly"])
    def test_plain_version_matches_jax(self, gelu):
        rng = np.random.default_rng(6)
        B, N, K, H = 2, 40, 128, 512
        tok = rng.normal(size=(B, N, K)).astype(np.float32)
        q1, s1, b1 = _linear(rng, K, H)
        q2, s2, b2 = _linear(rng, H, K, scale=0.02)
        g, bt = _ln(rng, K)
        sx1, sx2 = np.float32(0.034), np.float32(0.021)
        ref = jax_k4(jnp.asarray(tok), jnp.asarray(q1), jnp.asarray(s1), jnp.asarray(b1),
                     jnp.asarray(q2), jnp.asarray(s2), jnp.asarray(b2), jnp.asarray(g),
                     jnp.asarray(bt), jnp.asarray(sx1), jnp.asarray(sx2), interpret=True,
                     tm=32, gelu=gelu)
        got = fused_int8_mlp_block(_t(tok), _t(q1), _t(s1), _t(b1), _t(q2), _t(s2), _t(b2),
                                   _t(g), _t(bt), _t(sx1), _t(sx2), gelu=gelu)
        np.testing.assert_allclose(_np(got), np.asarray(ref), rtol=1e-5, atol=1e-5)


class TestK7:
    def _qkv(self, B=3, h=2, N=40, hd=16):
        rng = np.random.default_rng(7)
        return [rng.normal(size=(B, h, N, hd)).astype(np.float32) for _ in range(3)]

    def test_bf16_matches_jax(self):
        q, k, v = (a.astype(jnp.bfloat16) for a in self._qkv())
        ref = jax_exact(lambda *t: jax_k7(*t, interpret=True), *(jnp.asarray(a) for a in (q, k, v)))
        got = fused_short_attention(*(_t(a.astype(np.float32)).bfloat16() for a in (q, k, v)))
        assert got.dtype == torch.bfloat16
        # one bf16 rounding of an f32 result that agrees to f32 sum order
        np.testing.assert_allclose(_np(got), np.asarray(ref, np.float32), rtol=2.0 ** -8,
                                   atol=2.0 ** -8)

    @pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
    def test_out_scale_matches_jax(self, dtype):
        q, k, v = (jnp.asarray(a).astype(dtype) for a in self._qkv())
        sx = jnp.asarray(0.011, jnp.float32)
        ref = jax_exact(lambda *t: jax_k7(*t, interpret=True, out_scale=sx), q, k, v)
        got = fused_short_attention(*(_t(np.asarray(a, np.float32)).to(getattr(torch, dtype))
                                      for a in (q, k, v)), out_scale=_t(np.float32(0.011)))
        assert got.dtype == torch.int8
        # int8 within 1 (test_pallas_kernels.py:127): a value on a rounding
        # boundary may land on either side
        diff = np.abs(got.numpy().astype(np.int32) - np.asarray(ref, np.int32))
        assert diff.max() <= 1 and (diff > 0).mean() < 0.01

    # The CUDA kernel's edges: one and two 64-key accumulators and one past,
    # the 256-key limit and one short of it, head widths 16 to 128, and q and
    # k scaled by 8 so that the max subtraction decides the result.
    @pytest.mark.parametrize("N,hd,mult", [(64, 64, 1), (65, 64, 1), (128, 128, 1),
                                           (255, 16, 1), (256, 128, 1), (192, 80, 8),
                                           (65, 16, 8), (256, 64, 8)],
                             ids=["n64", "n65", "n128_hd128", "n255_hd16", "n256_hd128",
                                  "vith_x8", "n65_hd16_x8", "n256_x8"])
    @pytest.mark.parametrize("out", ["bf16", "out_scale"])
    def test_edge_shapes_match_jax(self, N, hd, mult, out):
        rng = np.random.default_rng(N + hd)
        q, k, v = (rng.normal(size=(1, 2, N, hd)).astype(np.float32) for _ in range(3))
        q, k = q * mult, k * mult
        qkv = [jnp.asarray(a).astype(jnp.bfloat16) for a in (q, k, v)]
        sx = np.float32(0.011) if out == "out_scale" else None
        ref = jax_exact(lambda *t: jax_k7(*t, interpret=True,
                                          out_scale=None if sx is None else jnp.asarray(sx)),
                        *qkv)
        got = fused_short_attention(*(_t(np.asarray(a, np.float32)).bfloat16() for a in qkv),
                                    out_scale=None if sx is None else _t(sx))
        assert got.shape == (1, 2, N, hd)
        if sx is None:  # as test_bf16_matches_jax
            np.testing.assert_allclose(_np(got), np.asarray(ref, np.float32), rtol=2.0 ** -8,
                                       atol=2.0 ** -8)
        else:  # as test_out_scale_matches_jax
            diff = np.abs(got.numpy().astype(np.int32) - np.asarray(ref, np.int32))
            assert diff.max() <= 1 and (diff > 0).mean() < 0.01

    def test_qkv_forms_match_jax(self):
        from hamer_yolo_tpu.ops.attention_pallas import softmax_attention_qkv as jax_sa

        qkv = np.random.default_rng(8).normal(size=(4, 24, 3 * 2 * 16)).astype(np.float32)
        sx = np.float32(0.02)
        for force in ("xla", "pallas_direct"):
            ref = jax_sa(jnp.asarray(qkv), 2, force=force, interpret=True)
            got = softmax_attention_qkv(_t(qkv), 2, force=force)
            np.testing.assert_allclose(_np(got), np.asarray(ref), atol=1e-5)
            ref = jax_sa(jnp.asarray(qkv), 2, force=force, interpret=True, out_scale=sx)
            got = softmax_attention_qkv(_t(qkv), 2, force=force, out_scale=_t(sx))
            diff = np.abs(got.numpy().astype(np.int32) - np.asarray(ref, np.int32))
            assert got.dtype == torch.int8 and diff.max() <= 1 and (diff > 0).mean() < 0.01


class TestK3:
    @pytest.mark.parametrize("N,K,h", [(16, 128, 4), (12, 64, 4)], ids=["N16", "N12_tiny"])
    @pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
    def test_plain_version_matches_jax(self, N, K, h, dtype):
        rng = np.random.default_rng(9)
        B = 2
        tok = rng.normal(size=(B, N, K)).astype(np.float32)
        q, s, b = _linear(rng, K, 3 * K)
        pq, ps, pb = _linear(rng, K, K)
        g, bt = _ln(rng, K)
        sq, sp = np.float32(0.03), np.float32(0.012)
        ref = jax_exact(lambda t: jax_k3(
            t, jnp.asarray(q), jnp.asarray(s), jnp.asarray(b), jnp.asarray(g), jnp.asarray(bt),
            jnp.asarray(sq), jnp.asarray(sp), jnp.asarray(pq), jnp.asarray(ps), jnp.asarray(pb),
            h, interpret=True), jnp.asarray(tok).astype(dtype))
        got = fused_int8_attn_proj_block(_t(tok).to(getattr(torch, dtype)), _t(q), _t(s), _t(b),
                                         _t(g), _t(bt), _t(sq), _t(sp), _t(pq), _t(ps), _t(pb), h)
        assert got.dtype == getattr(torch, dtype)
        # f32: the JAX package's 1e-5 (test_int8_fused.py:434-435); bf16
        # tokens: the residual sum rounds once to bf16 on both sides
        tol = 1e-5 if dtype == "float32" else 2.0 ** -8
        np.testing.assert_allclose(_np(got), np.asarray(ref, np.float32), rtol=tol, atol=tol)


class TestLimits:
    """The limits the card holds K3, K4 and K5 to against their plain
    versions (ops/int8_matmul.check_against_plain) pass a plain version that
    takes its sums in another order and fail one that skips a step."""

    def _k5(self, rng, skip_eps=False, f64_sums=False):
        x = torch.from_numpy(rng.normal(size=(384, 1280)).astype(np.float32)).bfloat16()
        q, s, b = (_t(a) for a in _linear(rng, 1280, 1280))
        g, bt = (_t(a) for a in _ln(rng, 1280))
        ref = im.fused_int8_matmul_ref(x, q, s, b, g, bt, prologue="ln")
        xf = x.double() if f64_sums else x.float()
        mu = xf.mean(-1, keepdim=True)
        var = ((xf - mu) ** 2).mean(-1, keepdim=True)
        xl = ((xf - mu) * torch.rsqrt(var + (0.0 if skip_eps else 1e-6))).float() * g + bt
        sc = torch.clamp(xl.abs().amax(-1, keepdim=True) * im.RECIP_127, min=1e-8)
        got = (im.int_dot(im.quantize_rows_ref(xl, sc), q) * sc * s + b).bfloat16()
        return got, ref

    @pytest.mark.parametrize("skip_eps", [False, True], ids=["f64_sums", "no_eps"])
    def test_k5_limits(self, skip_eps):
        got, ref = self._k5(np.random.default_rng(20), skip_eps=skip_eps, f64_sums=not skip_eps)
        if skip_eps:
            with pytest.raises(AssertionError, match="disagrees"):
                im.check_against_plain(got, ref, "K5")
        else:
            im.check_against_plain(got, ref, "K5")

    @pytest.mark.parametrize("fault", ["f64_softmax", "p_unrounded", "crop_unprojected"])
    def test_k3_limits(self, fault):
        from hamer_yolo_tpu_torch.ops import attn_proj_block as apb

        rng = np.random.default_rng(21)
        B, N, K, h = 2, 192, 1280, 16
        tok = torch.from_numpy(rng.normal(size=(B, N, K)).astype(np.float32)).bfloat16()
        q, s, b = (_t(a) for a in _linear(rng, K, 3 * K))
        pq, ps, pb = (_t(a) for a in _linear(rng, K, K))
        g, bt = (_t(a) for a in _ln(rng, K))
        sq, sp = torch.tensor(0.03), torch.tensor(0.012)
        args = (q, s, b, g, bt, sq, sp, pq, ps, pb, h)
        qkv, aq, out = apb.fused_int8_attn_proj_block_steps(tok, *args)
        if fault == "crop_unprojected":  # crop 1 keeps its residual only
            out = out.clone()
            out[1] = tok[1]
        else:
            # the attention with its softmax in f64 and p rounded (a sound
            # kernel's sum order), or with p left unrounded before p.v
            x = qkv.reshape(B, N, 3, h, K // h)
            qs = (x[:, :, 0] * weak_scalar((K // h) ** -0.5, torch.bfloat16)).double()
            logits = torch.einsum("bnhd,bmhd->bhnm", qs, x[:, :, 1].double())
            e = torch.exp(logits - logits.amax(-1, keepdim=True))
            p = (e / e.sum(-1, keepdim=True)).float()
            p = p.bfloat16().float() if fault == "f64_softmax" else p
            res = torch.einsum("bhnm,bmhd->bnhd", p, x[:, :, 2].float())
            aq = torch.clamp(torch.round(res * (1.0 / sp)), -127, 127).to(torch.int8)
            aq = aq.reshape(B * N, K)
            out = tok + ((im.int_dot(aq, pq) * sp * ps + pb).bfloat16().reshape(B, N, K))
        if fault == "f64_softmax":
            apb.check_against_plain((qkv, aq, out), tok, *args)
        else:  # caught in the step at fault
            step = "attention" if fault == "p_unrounded" else "proj"
            with pytest.raises(AssertionError, match=f"K3's {step} step disagrees"):
                apb.check_against_plain((qkv, aq, out), tok, *args)
