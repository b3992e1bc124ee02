"""K3's opt-in forms against the JAX package on the CPU: the softmax flavours
(HYT_SOFTMAX=exp2|exp2p) and the int8 attention products
(HYT_ATTN_MATH=int8), the port's plain versions against JAX's Pallas kernel
in interpret mode on the same numpy-made inputs, at the tolerances of the K3
parity test (tests/test_torch_int8_kernels.py::TestK3: 1e-5 f32 tokens, 2^-8
bf16); the switches read through core/quant's dispatch as JAX reads them;
and the limit the card holds the int8 products' attention step to
(ops/attn_proj_block.int8_products_steps), from both sides."""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from hamer_yolo_tpu.core import quant as jquant
from hamer_yolo_tpu.ops.attention_pallas import fused_int8_attn_proj_block as jax_k3
from hamer_yolo_tpu_torch.core import quant
from hamer_yolo_tpu_torch.ops import attn_proj_block as apb
from hamer_yolo_tpu_torch.ops import int8_matmul as im
from hamer_yolo_tpu_torch.ops.attn_proj_block import fused_int8_attn_proj_block
from hamer_yolo_tpu_torch.ops.short_attention import (attn_math_flavor, flavoured_attention_ref,
                                                      softmax_flavor)
from test_torch_bridge import jax_exact, to_port
from test_torch_int8_kernels import _linear, _ln, _np, _t
from test_torch_optin_kernels import block, spy  # noqa: F401 (fixtures)

torch.set_num_threads(1)

FORMS = [("exp2", "bf16"), ("exp2p", "bf16"), ("exp", "int8"), ("exp2", "int8")]


def _k3_inputs(rng, B, N, K):
    tok = rng.normal(size=(B, N, K)).astype(np.float32)
    q, s, b = _linear(rng, K, 3 * K)
    pq, ps, pb = _linear(rng, K, K)
    g, bt = _ln(rng, K)
    return tok, (q, s, b, g, bt, np.float32(0.03), np.float32(0.012), pq, ps, pb)


@pytest.mark.parametrize("softmax,attn_math", FORMS, ids=[f"{s}-{m}" for s, m in FORMS])
@pytest.mark.parametrize("N,K,h", [(16, 128, 4), (12, 64, 4)], ids=["N16", "N12_tiny"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_k3_form_matches_jax(softmax, attn_math, N, K, h, dtype):
    tok, args = _k3_inputs(np.random.default_rng(9), 2, N, K)
    ref = jax_exact(lambda t: jax_k3(t, *(jnp.asarray(a) for a in args), h, interpret=True,
                                     softmax=softmax, attn_math=attn_math),
                    jnp.asarray(tok).astype(dtype))
    got = fused_int8_attn_proj_block(_t(tok).to(getattr(torch, dtype)), *(_t(a) for a in args), h,
                                     softmax=softmax, attn_math=attn_math)
    assert got.dtype == getattr(torch, dtype)
    tol = 1e-5 if dtype == "float32" else 2.0 ** -8
    np.testing.assert_allclose(_np(got), np.asarray(ref, np.float32), rtol=tol, atol=tol)


def test_int8_products_take_exp2p_as_exp2():
    """Under the int8 products JAX's kernel has no exp2p branch: exp2p is
    exp2 (its e is quantized as p either way)."""
    rng = np.random.default_rng(3)
    q, k, v = (torch.from_numpy(rng.normal(size=(2, 2, 24, 16)).astype(np.float32)).bfloat16()
               for _ in range(3))
    assert torch.equal(flavoured_attention_ref(q, k, v, 0.01, "exp2p", "int8"),
                       flavoured_attention_ref(q, k, v, 0.01, "exp2", "int8"))


@pytest.mark.parametrize("env", [{"HYT_SOFTMAX": "exp2p"}, {"HYT_ATTN_MATH": "int8"},
                                 {"HYT_SOFTMAX": "exp2", "HYT_ATTN_MATH": "int8"},
                                 {"HYT_SOFTMAX": "bogus", "HYT_ATTN_MATH": "bf16"}],
                         ids=["exp2p", "int8", "int8-exp2", "unknown"])
def test_dispatch_reads_the_switches_as_jax(block, spy, monkeypatch, env):  # noqa: F811
    """core/quant.int8_block_attn_residual hands K3 the switches' form, as
    JAX's hands its kernel softmax_flavor() and attn_math_flavor() (an
    unknown value is the default in both)."""
    blocks, tok = block
    for name, value in env.items():
        monkeypatch.setenv(name, value)
    monkeypatch.delenv("HYT_ATTN", raising=False)
    want = (env.get("HYT_SOFTMAX") if env.get("HYT_SOFTMAX") in ("exp2", "exp2p") else "exp",
            env.get("HYT_ATTN_MATH", "bf16"))
    assert (softmax_flavor(), attn_math_flavor()) == want
    seen = []
    k3 = quant.fused_int8_attn_proj_block
    monkeypatch.setattr(quant, "fused_int8_attn_proj_block", lambda *a, **kw: seen.append(
        (kw["softmax"], kw["attn_math"])) or k3(*a, **kw))
    ref = jax_exact(lambda b, t: jquant.int8_block_attn_residual(b, t, 4, interpret=True),
                    blocks["static"], jnp.asarray(tok))
    got = quant.int8_block_attn_residual(to_port(blocks["static"]), _t(tok), 4)
    assert seen == [want]
    # the JAX package's own limit for its dispatch arms (test_int8_fused.py:373-409)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=0.05, atol=0.05)


class TestLimits:
    """The int8 products' limits of check_against_plain. The attention step's:
    a plain version that takes its softmax in f64 (a sound kernel's other sum
    order) passes; one that leaves p unrounded before pi . vi, or quantizes
    v by q's scale, fails. The end-to-end one (MAX_ERR_OVER_MEAN times the
    steps): the f64 softmax passes; p left unrounded, and one crop whose proj
    output is left out, fail. Steps past MAX_INT8_PRODUCTS_STEPS raise."""

    B, N, K, h = 2, 192, 1280, 16

    def _inputs(self, sp=0.012):
        rng = np.random.default_rng(21)
        B, N, K = self.B, self.N, self.K
        tok = torch.from_numpy(rng.normal(size=(B, N, K)).astype(np.float32)).bfloat16()
        q, s, b = (_t(a) for a in _linear(rng, K, 3 * K))
        pq, ps, pb = (_t(a) for a in _linear(rng, K, K))
        g, bt = (_t(a) for a in _ln(rng, K))
        return tok, (q, s, b, g, bt, torch.tensor(0.03), torch.tensor(sp), pq, ps, pb, self.h)

    def _steps(self, fault):
        """(qkv, aq, out) of a plain version with ``fault`` planted."""
        B, N, K, h = self.B, self.N, self.K, self.h
        tok, args = self._inputs()
        sp, pq, ps, pb = args[6:10]
        qkv, _, _ = apb.fused_int8_attn_proj_block_steps(tok, *args, attn_math="int8")
        x = qkv.reshape(B, N, 3, h, K // h).permute(2, 0, 3, 1, 4).float()  # (3, B, h, N, hd)
        scale = [torch.amax(torch.abs(t), dim=(-2, -1), keepdim=True) * im.RECIP_127 + 1e-12
                 for t in x]
        if fault == "v_by_q_scale":
            scale[2] = scale[0]
        qi, ki, vi = (torch.round(t * (1.0 / sc)) for t, sc in zip(x, scale))
        qs = float(np.float32((K // h) ** -0.5))
        logits = (qi.double() @ ki.double().transpose(-1, -2)).float() * (qs * (scale[0] *
                                                                                scale[1]))
        if fault in ("f64_softmax", "crop_dropped"):
            ld = logits.double()
            e = torch.exp(ld - ld.amax(-1, keepdim=True))
            pi = torch.round(e / e.sum(-1, keepdim=True) * 127.0).float()
        else:
            e = torch.exp(logits - logits.amax(-1, keepdim=True))
            pi = e * (1.0 / e.sum(-1, keepdim=True)) * 127.0
            pi = pi if fault == "p_unrounded" else torch.round(pi)
        res = (pi.double() @ vi.double()).float() * ((scale[2] * im.RECIP_127) * (1.0 / sp))
        aq = torch.clamp(torch.round(res), -127, 127).to(torch.int8)
        aq = aq.permute(0, 2, 1, 3).reshape(B * N, K)
        out = apb._proj_ref(aq, tok, pq, ps, pb, sp)
        if fault == "crop_dropped":
            out = out.clone()
            out[1] = tok[1].to(out.dtype)
        return tok, args, (qkv, aq, out)

    @pytest.mark.parametrize("fault", ["f64_softmax", "p_unrounded", "v_by_q_scale"])
    def test_int8_products_limits(self, fault):
        tok, args, (qkv, aq, out) = self._steps(fault)
        if fault == "f64_softmax":
            r = apb.check_against_plain((qkv, aq, out), tok, *args, attn_math="int8")
            assert r["attention_max_abs_err"] <= r["attention_limit_steps"]
        else:
            with pytest.raises(AssertionError, match="attention step disagrees"):
                apb.check_against_plain((qkv, aq, out), tok, *args, attn_math="int8")

    @pytest.mark.parametrize("fault", ["f64_softmax", "p_unrounded", "crop_dropped"])
    def test_int8_products_end_to_end_limit(self, fault):
        tok, args, (qkv, _, out) = self._steps(fault)
        steps = apb.int8_products_steps(qkv, self.B, self.h, args[6])
        assert 1 < steps <= apb.MAX_INT8_PRODUCTS_STEPS
        if fault == "f64_softmax":
            r = apb.check_end_to_end(out, tok, *args, attn_math="int8", steps=steps)
            assert r["err_over_mean"] <= apb.end_to_end_limit(steps)
        else:
            with pytest.raises(AssertionError, match=r"K3 \(int8\) disagrees"):
                apb.check_end_to_end(out, tok, *args, attn_math="int8", steps=steps)

    def test_int8_products_steps_are_capped(self):
        tok, args = self._inputs(sp=0.001)
        qkv, _, _ = apb.fused_int8_attn_proj_block_steps(tok, *args, attn_math="int8")
        with pytest.raises(ValueError, match="past the 8"):
            apb.int8_products_steps(qkv, self.B, self.h, args[6])
