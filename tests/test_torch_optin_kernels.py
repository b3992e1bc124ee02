"""The opt-in kernels (K6, K8, K9, K10), f32 attention inputs and the int8
dispatch under JAX's switches: the port's plain versions against the JAX
package's Pallas kernels in interpret mode, on the same numpy-made inputs.
Tolerances are the JAX package's own (tests/test_pallas_kernels.py,
tests/test_int8_fused.py) or tighter, as stated at each."""
import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from hamer_yolo_tpu.core import quant as jquant
from hamer_yolo_tpu.models.vit import ViTConfig as JViT
from hamer_yolo_tpu.models.vit import init_vit as jinit_vit
from hamer_yolo_tpu.ops.attention_pallas import fused_int8_attn_block as jax_k6
from hamer_yolo_tpu.ops.attention_pallas import fused_qkv_attention as jax_k8
from hamer_yolo_tpu.ops.attention_pallas import fused_short_attention as jax_k7
from hamer_yolo_tpu.ops.attention_pallas import softmax_attention_qkv as jax_sa
from hamer_yolo_tpu.ops.int8_matmul import fused_int8_mlp_block1 as jax_k10
from hamer_yolo_tpu.ops.mano_pallas import mano_lbs_fused as jax_k9
from hamer_yolo_tpu_torch.core import quant
from hamer_yolo_tpu_torch.geometry.rotations import aa_to_rotmat
from hamer_yolo_tpu_torch.models.mano import lbs
from hamer_yolo_tpu_torch.ops import attn_block_int8, mano_lbs, short_attention
from hamer_yolo_tpu_torch.ops import int8_matmul as im
from hamer_yolo_tpu_torch.ops.attn_block_int8 import fused_int8_attn_block
from hamer_yolo_tpu_torch.ops.int8_matmul import (fused_int8_mlp_block1,
                                                  fused_int8_mlp_block1_ref,
                                                  fused_int8_mlp_block_ref)
from hamer_yolo_tpu_torch.ops.mano_lbs import mano_lbs_fused, mano_lbs_fused_ref
from hamer_yolo_tpu_torch.ops.short_attention import (fused_qkv_attention, fused_short_attention,
                                                      softmax_attention_qkv)
from test_torch_bridge import jax_exact, mano_pair, numpy_params, to_port
from test_torch_int8_kernels import _linear, _ln, _np, _t

torch.set_num_threads(1)


def _int8_close(got: torch.Tensor, ref) -> None:
    """int8 within 1 (tests/test_pallas_kernels.py:127), on under 1% of
    elements: a value on a rounding boundary may land on either side."""
    assert got.dtype == torch.int8
    diff = np.abs(got.numpy().astype(np.int32) - np.asarray(ref, np.int32))
    assert diff.max() <= 1 and (diff > 0).mean() < 0.01


def _mano_inputs(S, nb, seed=0):
    rng = np.random.default_rng(seed)
    betas = rng.normal(size=(S, nb)).astype(np.float32)
    aa = torch.from_numpy((0.5 * rng.normal(size=(S * 16, 3))).astype(np.float32))
    return betas, aa_to_rotmat(aa).reshape(S, 16, 3, 3).numpy()


class TestK9:
    @pytest.mark.parametrize("S,nb", [(5, 10), (2, 4)], ids=["nb10", "nb4"])
    def test_plain_version_matches_jax(self, S, nb):
        jm, tm = mano_pair()
        betas, rotmats = _mano_inputs(S, nb)
        ref_v, ref_j = jax_k9(jm, jnp.asarray(betas), jnp.asarray(rotmats), interpret=True)
        before = mano_lbs_fused.launches
        verts, joints = mano_lbs_fused(tm, _t(betas), _t(rotmats))
        assert mano_lbs_fused.launches == before  # the plain version counts no launch
        assert verts.shape == (S, 778, 3) and joints.shape == (S, 16, 3)
        # f32 sums in another order on coordinates of about 0.1 m; the JAX
        # package's own test allows 1e-3 / 1e-4 (test_pallas_kernels.py:216-217)
        np.testing.assert_allclose(verts.numpy(), np.asarray(ref_v), rtol=0, atol=1e-5)
        np.testing.assert_allclose(joints.numpy(), np.asarray(ref_j), rtol=0, atol=1e-5)

    @pytest.mark.parametrize("nb", [10, 4])
    def test_fk_ref_matches_jax_fk(self, nb):
        """The plain kinematics in the kernel's order (the cached per-model
        constants, the chain one depth level at a time) against the JAX
        package's _fk: f32 sums in another order on joints of about 0.1 m."""
        from hamer_yolo_tpu.ops.mano_pallas import _fk as jax_fk

        jm, tm = mano_pair()
        betas, rotmats = _mano_inputs(7, nb, seed=3)
        ref_a, ref_j = jax_fk(jm, jnp.asarray(betas), jnp.asarray(rotmats))
        made = mano_lbs.fk_constants.made
        A_flat, joints = mano_lbs.fk_ref(tm, _t(betas), _t(rotmats))
        mano_lbs.fk_ref(tm, _t(betas), _t(rotmats))
        assert mano_lbs.fk_constants.made <= made + 1  # once per model and nb
        assert mano_lbs.fk_levels(tm.parents) == ((1, 4, 7, 10, 13), (2, 5, 8, 11, 14),
                                                  (3, 6, 9, 12, 15))
        np.testing.assert_allclose(joints.numpy(), np.asarray(ref_j), rtol=0, atol=1e-6)
        np.testing.assert_allclose(A_flat.numpy(), np.asarray(ref_a), rtol=0, atol=1e-6)

    def test_plain_version_matches_lbs(self):
        _, tm = mano_pair()
        betas, rotmats = _mano_inputs(6, 10, seed=1)
        verts, joints = mano_lbs_fused_ref(tm, _t(betas), _t(rotmats))
        ref_v, ref_j = lbs(tm, _t(betas), _t(rotmats))
        np.testing.assert_allclose(verts.numpy(), ref_v.numpy(), rtol=0, atol=1e-5)
        np.testing.assert_allclose(joints.numpy(), ref_j.numpy(), rtol=0, atol=1e-5)


class TestF32Attention:
    def test_k7_f32_matches_jax(self):
        rng = np.random.default_rng(7)
        q, k, v = (rng.normal(size=(3, 2, 40, 16)).astype(np.float32) for _ in range(3))
        ref = jax_k7(*(jnp.asarray(a) for a in (q, k, v)), interpret=True)
        got = fused_short_attention(_t(q), _t(k), _t(v))
        assert got.dtype == torch.float32
        # the JAX test's own limit (test_pallas_kernels.py:41-50)
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-5)


class TestK8:
    @pytest.mark.parametrize("h,hd", [(2, 16), (3, 24)], ids=["h2_hd16", "h3_hd24"])
    def test_f32_matches_jax(self, h, hd):
        qkv = np.random.default_rng(8).normal(size=(4, 24, 3 * h * hd)).astype(np.float32)
        ref = jax_k8(jnp.asarray(qkv), h, interpret=True)
        before = fused_qkv_attention.launches
        got = fused_qkv_attention(_t(qkv), h)
        assert fused_qkv_attention.launches == before
        assert got.shape == (4, 24, h * hd) and got.dtype == torch.float32
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-5)

    def test_bf16_matches_jax(self):
        qkv = np.random.default_rng(9).normal(size=(3, 40, 3 * 2 * 16)).astype(np.float32)
        ref = jax_exact(lambda x: jax_k8(x, 2, interpret=True), jnp.asarray(qkv).astype("bfloat16"))
        got = fused_qkv_attention(_t(qkv).bfloat16(), 2)
        assert got.dtype == torch.bfloat16
        # one bf16 rounding of an f32 result that agrees to f32 sum order
        np.testing.assert_allclose(_np(got), np.asarray(ref, np.float32), rtol=2.0 ** -8,
                                   atol=2.0 ** -8)

    @pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
    @pytest.mark.parametrize("h,hd", [(2, 16), (3, 24)], ids=["h2_hd16", "h3_hd24"])
    def test_out_scale_matches_jax(self, h, hd, dtype):
        qkv = jnp.asarray(np.random.default_rng(10).normal(size=(4, 24, 3 * h * hd))
                          .astype(np.float32)).astype(dtype)
        sx = jnp.asarray(0.011, jnp.float32)
        ref = jax_exact(lambda x: jax_k8(x, h, interpret=True, out_scale=sx), qkv)
        got = fused_qkv_attention(_t(np.asarray(qkv, np.float32)).to(getattr(torch, dtype)), h,
                                  out_scale=_t(np.float32(0.011)))
        _int8_close(got, ref)

    def test_softmax_attention_qkv_fusedqkv_matches_jax(self):
        qkv = np.random.default_rng(11).normal(size=(4, 24, 3 * 2 * 16)).astype(np.float32)
        sx = np.float32(0.02)
        ref = jax_sa(jnp.asarray(qkv), 2, force="pallas_fusedqkv", interpret=True)
        got = softmax_attention_qkv(_t(qkv), 2, force="pallas_fusedqkv")
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-5)
        ref = jax_sa(jnp.asarray(qkv), 2, force="pallas_fusedqkv", interpret=True, out_scale=sx)
        _int8_close(softmax_attention_qkv(_t(qkv), 2, force="pallas_fusedqkv", out_scale=_t(sx)),
                    ref)
        # "pallas" (once refused here) is K7 on the crop batch, as JAX's
        # custom_vmap form computes it; a force JAX does not know raises
        ref = jax_sa(jnp.asarray(qkv), 2, force="pallas", interpret=True)
        got = softmax_attention_qkv(_t(qkv), 2, force="pallas")
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-5)
        with pytest.raises(ValueError, match="force 'megaproj'"):
            softmax_attention_qkv(_t(qkv), 2, force="megaproj")


def _k6_inputs(rng, B, N, K):
    tok = rng.normal(size=(B, N, K)).astype(np.float32)
    q, s, b = _linear(rng, K, 3 * K)
    g, bt = _ln(rng, K)
    return tok, (q, s, b, g, bt, np.float32(0.03), np.float32(0.012))


class TestK6:
    @pytest.mark.parametrize("N,K,h", [(16, 128, 4), (12, 64, 4)], ids=["N16", "N12_tiny"])
    @pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
    def test_plain_version_matches_jax(self, N, K, h, dtype):
        tok, args = _k6_inputs(np.random.default_rng(12), 2, N, K)
        ref = jax_exact(lambda t: jax_k6(t, *(jnp.asarray(a) for a in args), h, interpret=True),
                        jnp.asarray(tok).astype(dtype))
        before = fused_int8_attn_block.launches
        got = fused_int8_attn_block(_t(tok).to(getattr(torch, dtype)), *(_t(a) for a in args), h)
        assert fused_int8_attn_block.launches == before
        assert got.shape == (2, N, K)
        _int8_close(got, ref)


def _mlp_inputs(rng, B, N, K, H):
    tok = rng.normal(size=(B, N, K)).astype(np.float32)
    q1, s1, b1 = _linear(rng, K, H)
    q2, s2, b2 = _linear(rng, H, K, scale=0.02)
    g, bt = _ln(rng, K)
    return tok, (q1, s1, b1, q2, s2, b2, g, bt, np.float32(0.034), np.float32(0.021))


class TestK10:
    @pytest.mark.parametrize("gelu", ["gelu", "gelu_poly"])
    def test_plain_version_matches_jax(self, gelu):
        tok, args = _mlp_inputs(np.random.default_rng(13), 2, 40, 128, 512)
        ref = jax_k10(jnp.asarray(tok), *(jnp.asarray(a) for a in args), interpret=True, tm=32,
                      gelu=gelu, hc=128)
        before = fused_int8_mlp_block1.launches
        got = fused_int8_mlp_block1(_t(tok), *(_t(a) for a in args), gelu=gelu, hc=128)
        assert fused_int8_mlp_block1.launches == before
        # the JAX package's limit for K4 (test_int8_fused.py), as K4's test here
        np.testing.assert_allclose(_np(got), np.asarray(ref), rtol=1e-5, atol=1e-5)

    # hc64 is the card kernel's chunk at this K (one CTA of 64 columns), hcH
    # its chunk at ViT-H's K (8 CTAs)
    @pytest.mark.parametrize("hc", [128, 256, 512, 200, 64],
                             ids=["hc128", "hc256", "hcH", "hc200_to_H", "hc64"])
    @pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
    def test_plain_version_equals_k4s(self, hc, dtype):
        """int32 partial sums: whatever the chunk, K10 is K4 bit for bit
        (H % hc != 0 takes hc = H, as JAX does)."""
        tok, args = _mlp_inputs(np.random.default_rng(14), 2, 40, 128, 512)
        tok = _t(tok).to(getattr(torch, dtype))
        args = tuple(_t(a) for a in args)
        got = fused_int8_mlp_block1_ref(tok, *args, gelu="gelu_poly", hc=hc)
        assert got.dtype == tok.dtype
        assert torch.equal(got, fused_int8_mlp_block_ref(tok, *args, gelu="gelu_poly"))


    def test_cluster_plan_covers_every_width(self):
        """Every K the kernel takes (multiples of 16 up to 1280) gets a cluster
        of at most 8 CTAs, none idle, whose 160 columns each cover K; wider K
        raises."""
        for K in range(16, im.MLP1_MAX_K + 1, 16):
            c = im.mlp1_cluster(K)
            assert 1 <= c <= im.MLP1_MAX_CLUSTER
            assert (c - 1) * im.MLP1_COLS_PER_CTA < K <= c * im.MLP1_COLS_PER_CTA
        assert im.mlp1_cluster(1280) == 8
        with pytest.raises(ValueError, match="at most 1280"):
            im.mlp1_cluster(1296)


class TestLimits:
    """The limits the card holds K9 and K6 to against their plain versions
    pass a version that takes its sums in another order and fail one that
    skips a step."""

    @pytest.mark.parametrize("fault", ["f64_sums", "no_translation"])
    def test_k9_limit(self, fault):
        _, tm = mano_pair()
        betas, rotmats = (_t(a) for a in _mano_inputs(16, 10, seed=2))
        ref, _ = mano_lbs_fused_ref(tm, betas, rotmats)
        sd, pd, pf, A, _ = mano_lbs._plain_inputs(tm, betas, rotmats)
        if fault == "no_translation":
            A = torch.cat([A[..., :9], torch.zeros_like(A[..., 9:])], dim=-1)
        got = mano_lbs.blend_skin_ref(*(t.double() for t in (
            betas, pf, A, tm.v_template, sd, pd, tm.weights))).float()
        if fault == "f64_sums":
            assert mano_lbs.check_against_plain(got, ref)["max_abs_err"] < 1e-6
        else:
            with pytest.raises(AssertionError, match="K9 disagrees"):
                mano_lbs.check_against_plain(got, ref)

    @pytest.mark.parametrize("fault", ["f64_softmax", "p_unrounded"])
    def test_k6_limits(self, fault):
        from hamer_yolo_tpu_torch.core.nn import weak_scalar

        B, N, K, h = 2, 192, 1280, 16
        tok, args = _k6_inputs(np.random.default_rng(22), B, N, K)
        tok, args = _t(tok).bfloat16(), tuple(_t(a) for a in args) + (h,)
        qkv, _ = attn_block_int8.fused_int8_attn_block_steps(tok, *args)
        # the attention with its softmax in f64 and p rounded (a sound
        # kernel's sum order), or with p left unrounded before p.v
        x = qkv.reshape(B, N, 3, h, K // h)
        qs = (x[:, :, 0] * weak_scalar((K // h) ** -0.5, torch.bfloat16)).double()
        logits = torch.einsum("bnhd,bmhd->bhnm", qs, x[:, :, 1].double())
        e = torch.exp(logits - logits.amax(-1, keepdim=True))
        p = (e / e.sum(-1, keepdim=True)).float()
        p = p.bfloat16().float() if fault == "f64_softmax" else p
        res = torch.einsum("bhnm,bmhd->bnhd", p, x[:, :, 2].float())
        aq = torch.clamp(torch.round(res * (1.0 / args[6])), -127, 127).to(torch.int8)
        steps = (qkv, aq.reshape(B * N, K))
        if fault == "f64_softmax":
            attn_block_int8.check_against_plain(steps, tok, *args)
        else:
            with pytest.raises(AssertionError, match="K6's attention step disagrees"):
                attn_block_int8.check_against_plain(steps, tok, *args)


# ------------------------------------------------------------ the dispatch
SHAPE = dict(img_size=(32, 32), patch_size=16, patch_padding=0, embed_dim=128, depth=1,
             num_heads=4, compute_dtype="float32")


@pytest.fixture(scope="module")
def block():
    """One quantized ViT block with calibrated static scales, made by the JAX
    package (compiled), and f32 tokens."""
    jcfg = JViT(**SHAPE)
    params = jax.tree_util.tree_map(jnp.asarray, numpy_params(lambda k: jinit_vit(k, jcfg), 3))
    pq = jax.jit(jquant.quantize_vit_params)(params)
    x = np.random.default_rng(4).normal(size=(2, 32, 32, 3)).astype(np.float32)
    stats = jax_exact(lambda p, xx: jquant.collect_vit_act_stats(p, xx, jcfg), pq, jnp.asarray(x))
    ps = jax.jit(jquant.attach_static_act_scales)(pq, stats)
    tok = np.random.default_rng(5).normal(size=(3, 24, 128)).astype(np.float32)
    return {"static": ps["blocks"][0], "dynamic": pq["blocks"][0]}, tok


def _drop_sx(blk, *names):
    """``blk`` (numpy or jax leaves) without the static scales of ``names``."""
    out = {**blk, "attn": dict(blk["attn"]), "mlp": dict(blk["mlp"])}
    for n in names:
        part = "attn" if n in ("qkv", "proj") else "mlp"
        out[part][n] = {k: v for k, v in blk[part][n].items() if k != "sx"}
    return out


@pytest.fixture
def spy(monkeypatch):
    """Counts the calls each kernel wrapper gets from the dispatch."""
    calls = {}

    def wrap(mod, name, key):
        fn = getattr(mod, name)

        @functools.wraps(fn)
        def counted(*a, **kw):
            calls[key] = calls.get(key, 0) + 1
            return fn(*a, **kw)
        monkeypatch.setattr(mod, name, counted)

    wrap(quant, "fused_int8_attn_proj_block", "K3")
    wrap(quant, "fused_int8_mlp_block", "K4")
    wrap(quant, "fused_int8_matmul", "K5")
    wrap(quant, "fused_int8_attn_block", "K6")
    wrap(short_attention, "fused_short_attention", "K7")
    wrap(short_attention, "fused_qkv_attention", "K8")
    wrap(quant, "fused_int8_mlp_block1", "K10")
    wrap(quant, "int8_dot_prequant", "prequant")
    return calls


# (HYT_ATTN, HYT_ATTN_PREQUANT, the block's scales, the wrappers reached)
ATTN_CASES = [
    (None, None, "static", {"K3": 1}),
    ("megaproj", None, "static", {"K3": 1}),
    ("megakernel", None, "static", {"K6": 1, "prequant": 1}),
    ("pallas_fusedqkv", None, "static", {"K5": 1, "K8": 1, "prequant": 1}),
    ("pallas_direct", None, "static", {"K5": 1, "K7": 1, "prequant": 1}),
    ("xla", None, "static", {"K5": 2}),
    (None, "0", "static", {"K5": 2, "K7": 1}),
    ("megakernel", None, "proj_only", {"K5": 1, "K7": 1, "prequant": 1}),
    ("megakernel", None, "dynamic", {"K5": 2}),
    (None, None, "dynamic", {"K5": 2, "K7": 1}),
    ("pallas_fusedqkv", None, "dynamic", {"K5": 2, "K8": 1}),
    ("megaproj", None, "dynamic", {"K5": 2}),
]


@pytest.mark.parametrize("env,prequant,scales,want", ATTN_CASES,
                         ids=[f"{e}-{p}-{s}" for e, p, s, _ in ATTN_CASES])
def test_attn_dispatch_matches_jax(block, spy, monkeypatch, env, prequant, scales, want):
    blocks, tok = block
    blk = _drop_sx(blocks["static"], "qkv") if scales == "proj_only" else blocks[scales]
    for name, value in (("HYT_ATTN", env), ("HYT_ATTN_PREQUANT", prequant)):
        if value is None:
            monkeypatch.delenv(name, raising=False)
        else:
            monkeypatch.setenv(name, value)
    # JAX's _attn_math does not hand ``interpret`` on, so its K8 arm without a
    # static proj scale runs only on a TPU: give it interpret mode here
    from hamer_yolo_tpu.ops import attention_pallas as jap
    jax_fusedqkv = jap.fused_qkv_attention
    monkeypatch.setattr(jap, "fused_qkv_attention", lambda x, h, interpret=False, **kw:
                        jax_fusedqkv(x, h, interpret=True, **kw))
    ref = jax_exact(lambda b, t: jquant.int8_block_attn_residual(b, t, 4, interpret=True),
                    blk, jnp.asarray(tok))
    got = quant.int8_block_attn_residual(to_port(blk), _t(tok), 4)
    assert spy == want
    # the JAX package's own limit for its dispatch arms (test_int8_fused.py:373-409)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=0.05, atol=0.05)


@pytest.mark.parametrize("env", ["pallas", "auto"])
def test_attn_dispatch_refuses_what_is_not_ported(monkeypatch, env):
    """What neither package computes under HYT_ATTN=pallas|auto: the int8
    epilogue (out_scale) of the attention, a ValueError in both, where JAX's
    softmax_attention_qkv reads the switch and the port's takes the form the
    dispatch read from it. (The forms themselves, once refused here, run:
    test_attn_dispatch_pallas_auto_matches_jax.)"""
    monkeypatch.setenv("HYT_ATTN", env)
    qkv = np.random.default_rng(13).normal(size=(4, 12, 3 * 2 * 16)).astype(np.float32)
    with pytest.raises(ValueError, match="out_scale"):
        jax_sa(jnp.asarray(qkv), 2, out_scale=jnp.float32(0.02))
    with pytest.raises(ValueError, match="out_scale"):
        softmax_attention_qkv(_t(qkv), 2, force=env, out_scale=_t(np.float32(0.02)))


@pytest.mark.parametrize("env", ["pallas", "auto"])
def test_attn_dispatch_pallas_auto_matches_jax(block, spy, monkeypatch, env):
    """HYT_ATTN=pallas|auto run as JAX's do: K5, the attention, K5, with
    "pallas" the attention on K7 and "auto" on the einsum (fewer than
    MIN_PALLAS_CROPS crops, and on the CPU), static and dynamic scales
    alike."""
    from hamer_yolo_tpu.ops import attention_pallas as jap

    blocks, tok = block
    monkeypatch.setenv("HYT_ATTN", env)
    # JAX's custom_vmap form hands ``interpret`` False to its kernel: give it
    # interpret mode here
    jax_k7_fn = jap.fused_short_attention
    monkeypatch.setattr(jap, "fused_short_attention", lambda *a, interpret=False, **kw:
                        jax_k7_fn(*a, interpret=True, **kw))
    for scales in ("static", "dynamic"):
        spy.clear()
        ref = jax_exact(lambda b, t: jquant.int8_block_attn_residual(b, t, 4, interpret=True),
                        blocks[scales], jnp.asarray(tok))
        got = quant.int8_block_attn_residual(to_port(blocks[scales]), _t(tok), 4)
        assert spy == ({"K5": 2, "K7": 1} if env == "pallas" else {"K5": 2}), scales
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=0.05, atol=0.05)


def test_auto_and_pallas_forms_match_jax():
    """softmax_attention_qkv's "auto": the einsum below MIN_PALLAS_CROPS
    crops and off the card (JAX's off a TPU without interpret mode), so at
    64 crops on the CPU too; "pallas" and "auto" take no out_scale, a
    ValueError in both packages."""
    qkv = np.random.default_rng(13).normal(size=(64, 12, 3 * 2 * 16)).astype(np.float32)
    assert short_attention.MIN_PALLAS_CROPS == 64
    ref = jax_sa(jnp.asarray(qkv), 2, force="auto")
    got = softmax_attention_qkv(_t(qkv), 2, force="auto")
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-5)
    for force in ("pallas", "auto"):
        with pytest.raises(ValueError, match="out_scale"):
            jax_sa(jnp.asarray(qkv), 2, force=force, out_scale=jnp.float32(0.02))
        with pytest.raises(ValueError, match="out_scale"):
            softmax_attention_qkv(_t(qkv), 2, force=force, out_scale=_t(np.float32(0.02)))


MLP_CASES = [
    (None, "static", {"K4": 1}),
    ("megakernel", "static", {"K4": 1}),
    ("megakernel1", "static", {"K10": 1}),
    ("off", "static", {"K5": 2}),
    (None, "dynamic", {"K5": 2}),
    ("megakernel1", "fc1_only", {"K5": 2}),
]


@pytest.mark.parametrize("env,scales,want", MLP_CASES, ids=[f"{e}-{s}" for e, s, _ in MLP_CASES])
def test_mlp_dispatch_matches_jax(block, spy, monkeypatch, env, scales, want):
    blocks, tok = block
    blk = _drop_sx(blocks["static"], "fc2") if scales == "fc1_only" else blocks[scales]
    if env is None:
        monkeypatch.delenv("HYT_INT8_MLP", raising=False)
    else:
        monkeypatch.setenv("HYT_INT8_MLP", env)
    monkeypatch.setenv("HYT_INT8_MLP_HC", "256")
    ref = jax_exact(lambda b, t: jquant.int8_block_mlp_residual(b, t, interpret=True),
                    blk, jnp.asarray(tok))
    got = quant.int8_block_mlp_residual(to_port(blk), _t(tok))
    assert spy == want
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=0.05, atol=0.05)
