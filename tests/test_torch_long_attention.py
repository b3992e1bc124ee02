"""Attention past 256 keys: the port's plain versions of K7 and K2, which
the card's key-block kernels are held to, against the JAX package's Pallas
kernels in interpret mode, and a 2-block ViT with 266 tokens through
vit_forward against JAX's, on both of the port's paths (the plain attention
and K2's twin). Tolerances are those of the existing K7, K2 and ViT tests
(tests/test_torch_int8_kernels.py, tests/test_torch_attn_block.py). K3
under the int8 attention products past 256 keys against JAX's kernel, at
the tolerances of tests/test_torch_kernel_flavours.py; the int8 products'
two plain steps (the pre-pass and the attention launch) against the
one-step arithmetic, and the pre-pass's blocked tile order."""
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
from hamer_yolo_tpu.ops.attention_pallas import fused_int8_attn_proj_block as jax_k3
from hamer_yolo_tpu.ops.attention_pallas import fused_short_attention as jax_k7
from hamer_yolo_tpu_torch.models.vit import ViTConfig, vit_forward
from hamer_yolo_tpu_torch.ops import int8_matmul as im
from hamer_yolo_tpu_torch.ops import short_attention as sa
from hamer_yolo_tpu_torch.ops.attn_block import fused_bf16_attn_block
from hamer_yolo_tpu_torch.ops.attn_proj_block import fused_int8_attn_proj_block
from hamer_yolo_tpu_torch.ops.short_attention import fused_short_attention
from test_torch_bridge import jax_exact, numpy_params, to_port
from test_torch_int8_kernels import _np, _t
from test_torch_kernel_flavours import _k3_inputs

torch.set_num_threads(1)


@pytest.mark.parametrize("N", [257, 320, 577])
@pytest.mark.parametrize("hd", [64, 80])
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_k7_twin_beyond_256_keys_matches_jax(N, hd, dtype):
    rng = np.random.default_rng(N + hd)
    q, k, v = (rng.normal(size=(1, 2, N, hd)).astype(np.float32) for _ in range(3))
    qkv = [jnp.asarray(a).astype(dtype) for a in (q, k, v)]
    ref = jax_exact(lambda *t: jax_k7(*t, interpret=True), *qkv)
    tdt = getattr(torch, dtype)
    got = fused_short_attention(*(torch.from_numpy(np.array(a, np.float32)).to(tdt) for a in qkv))
    assert got.shape == (1, 2, N, hd) and got.dtype == tdt
    # as tests/test_torch_int8_kernels.py::TestK7::test_bf16_matches_jax: one
    # bf16 rounding of an f32 result that agrees to f32 sum order (f32
    # inputs skip that rounding and sit far inside it)
    np.testing.assert_allclose(got.float().numpy(), np.asarray(ref, np.float32), rtol=2.0 ** -8,
                               atol=2.0 ** -8)


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_k2_twin_beyond_256_keys_matches_pallas_interpret(dtype):
    rng = np.random.default_rng(11)
    B, N, K, h = 1, 266, 48, 2
    tok = rng.normal(size=(B, N, K)).astype(np.float32)
    w = (rng.normal(size=(K, 3 * K)) * K ** -0.5).astype(np.float32)
    b, g, beta = (rng.normal(size=n).astype(np.float32) for n in (3 * K, K, K))
    g = 1.0 + 0.1 * g
    jdt, tdt = (jnp.bfloat16, torch.bfloat16) if dtype == "bfloat16" else (jnp.float32,
                                                                          torch.float32)
    ref = jax_attention_pallas.fused_bf16_attn_block(
        jnp.asarray(tok).astype(jdt), jnp.asarray(w), jnp.asarray(b), jnp.asarray(g),
        jnp.asarray(beta), h, interpret=True)
    got = fused_bf16_attn_block(torch.from_numpy(tok).to(tdt), torch.from_numpy(w),
                                torch.from_numpy(b), torch.from_numpy(g),
                                torch.from_numpy(beta), h)
    assert got.dtype == tdt and got.shape == (B, N, K)
    # Both round at the same points (LN f32 -> bf16, qkv f32 + bias -> bf16,
    # bf16 q * bf16 scale, p -> bf16): the bf16 tolerance of
    # tests/test_torch_attn_block.py::test_twin_matches_pallas_interpret for
    # either token dtype, since at 266 x 3 x 48 qkv values an f32 sum taken in
    # another order flips some bf16 q, k or v, which moves f32 outputs too.
    np.testing.assert_allclose(got.float().numpy(), np.asarray(ref.astype(jnp.float32)),
                               rtol=1e-2, atol=1e-2)


def _vit_setup():
    """A 2-block bf16 ViT at img_size (304, 224): 19 x 14 = 266 tokens."""
    kw = dict(img_size=(304, 224), embed_dim=64, depth=2, num_heads=4, compute_dtype="bfloat16")
    jcfg, tcfg = JaxViTConfig(**kw), ViTConfig(**kw)
    assert tcfg.num_tokens == 266
    params = numpy_params(lambda k: jax_init_vit(k, jcfg), seed=5)
    x = np.random.default_rng(5).normal(size=(2, 304, 224, 3)).astype(np.float32)
    return jcfg, tcfg, params, x


@pytest.mark.parametrize("fused", [False, True], ids=["plain", "k2_twin"])
def test_vit_beyond_256_tokens_matches_jax(fused, monkeypatch):
    """As test_torch_attn_block's test_vit_plain_path_matches_jax and
    test_vit_fused_path_matches_jax, at 266 tokens: JAX's plain path against
    the port's plain path, and JAX's K2 (in interpret mode) against K2's
    twin."""
    monkeypatch.setenv("HYT_ATTN_BF16", "megakernel" if fused else "off")
    monkeypatch.setattr(jax_attention_pallas, "fused_bf16_attn_block",
                        partial(jax_attention_pallas.fused_bf16_attn_block, interpret=True))
    jcfg, tcfg, params, x = _vit_setup()
    jp = jax.tree_util.tree_map(jnp.asarray, params)
    ref = jax_exact(lambda i: jax_vit_forward(jp, i, jcfg), jnp.asarray(x))
    got = vit_forward(to_port(params), torch.from_numpy(x), replace(tcfg, fused_attn=fused))
    ref = np.asarray(ref.astype(jnp.float32))
    assert got.shape == ref.shape == (2, 266, 64)
    # the JAX package's bf16 tolerance (tests/test_pallas_kernels.py:164-167)
    np.testing.assert_allclose(got.float().numpy(), ref, rtol=0.05, atol=0.05)


@pytest.mark.parametrize("N", [257, 300])
@pytest.mark.parametrize("softmax", ["exp", "exp2"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_k3_int8_products_beyond_256_keys_match_jax(N, softmax, dtype):
    """As tests/test_torch_kernel_flavours.py::test_k3_form_matches_jax, past
    the 256 keys the card's old int8-products kernel stopped at."""
    K, h = 64, 4
    tok, args = _k3_inputs(np.random.default_rng(N), 1, N, K)
    ref = jax_exact(lambda t: jax_k3(t, *(jnp.asarray(a) for a in args), h, interpret=True,
                                     softmax=softmax, attn_math="int8"),
                    jnp.asarray(tok).astype(dtype))
    got = fused_int8_attn_proj_block(_t(tok).to(getattr(torch, dtype)), *(_t(a) for a in args), h,
                                     softmax=softmax, attn_math="int8")
    assert got.dtype == getattr(torch, dtype) and got.shape == (1, N, K)
    tol = 1e-5 if dtype == "float32" else 2.0 ** -8
    np.testing.assert_allclose(_np(got), np.asarray(ref, np.float32), rtol=tol, atol=tol)


def _one_step_int8_products(q, k, v, out_scale, exp2):
    """The int8 products in one step, as the port computed them before the
    split (JAX's arithmetic, attention_pallas.py:466-506)."""
    hd = q.shape[-1]
    x = [t.float() for t in (q, k, v)]
    sc = [torch.amax(torch.abs(t), dim=(-2, -1), keepdim=True) * im.RECIP_127 + 1e-12 for t in x]
    qi, ki, vi = (torch.round(t * (1.0 / s)) for t, s in zip(x, sc))
    qs = float(np.float32(hd ** -0.5 * sa.LOG2E if exp2 else hd ** -0.5))
    logits = (qi.double() @ ki.double().transpose(-1, -2)).float() * (qs * (sc[0] * sc[1]))
    e = (torch.exp2 if exp2 else torch.exp)(logits - logits.amax(-1, keepdim=True))
    pi = torch.round(e * (1.0 / e.sum(-1, keepdim=True)) * 127.0)
    res = (pi.double() @ vi.double()).float() * ((sc[2] * im.RECIP_127) * (1.0 / out_scale))
    return torch.clamp(torch.round(res), -127, 127).to(torch.int8)


@pytest.mark.parametrize("N", [1, 12, 192, 300])
@pytest.mark.parametrize("softmax", ["exp", "exp2"])
def test_int8_products_split_composes_bit_for_bit(N, softmax):
    """quantize_heads_ref then int8_products_attention_ref (the pre-pass and
    the attention launch) equal the one-step arithmetic bit for bit, and
    flavoured_attention_ref is their composition; hd 80 pads to 96 in Qi and
    Ki and to 80 in Vt, N to 64 keys, with zeros, and the attention leaves
    the pad keys out (garbage planted there changes nothing)."""
    B, h, hd = 2, 3, 80
    rng = np.random.default_rng(N)
    q, k, v = (torch.from_numpy(3.0 * rng.normal(size=(B, h, N, hd)).astype(np.float32))
               .bfloat16() for _ in range(3))
    sx = torch.tensor(0.011)
    scales, qi, ki, vt = sa.quantize_heads_ref(q, k, v)
    Nk = -(-N // 64) * 64
    assert sa.int8_tile_dims(N, hd) == (Nk, 96, 80)
    assert scales.shape == (B, h, 3) and scales.dtype == torch.float32
    assert qi.shape == ki.shape == (B, h, Nk, 96) and vt.shape == (B, h, 80, Nk)
    assert all(t.dtype == torch.int8 for t in (qi, ki, vt))
    for t in (qi, ki):
        assert not t[..., N:, :].any() and not t[..., hd:].any()
    assert not vt[..., N:].any()
    want = _one_step_int8_products(q, k, v, 0.011, softmax == "exp2")
    got = sa.int8_products_attention_ref(scales, qi, ki, vt, N, hd, sx, softmax)
    assert torch.equal(got, want)
    assert torch.equal(sa.flavoured_attention_ref(q, k, v, sx, softmax, "int8"), want)
    junk = [t.clone() for t in (qi, ki, vt)]
    for t in junk[:2]:
        t[..., N:, :] = 77
        t[..., hd:] = 0  # the pad columns are summed, so they must stay zero
    junk[2][..., N:] = -55
    assert torch.equal(sa.int8_products_attention_ref(scales, *junk, N, hd, sx, softmax), want)


@pytest.mark.parametrize("N,hd", [(70, 24), (130, 80), (5, 8), (300, 128)])
def test_blocked_tiles_unblock_to_the_plain_layout(N, hd):
    """blocked_to_plain inverts the pre-pass's write order: the byte each
    thread of quantize_heads_kernel writes (csrc/attention_flavours.cu, chunk
    j of 16 bytes), placed by the kernel's own index arithmetic, lands at
    quantize_heads_ref's element."""
    B, H = 2, 2
    rng = np.random.default_rng(N + hd)
    q, k, v = (torch.from_numpy(rng.normal(size=(B, H, N, hd)).astype(np.float32)).bfloat16()
               for _ in range(3))
    _, qi, ki, vt = sa.quantize_heads_ref(q, k, v)
    Nk, Hk, Hv = sa.int8_tile_dims(N, hd)
    tiles = np.zeros(B * H * Nk * (2 * Hk + Hv), np.int8)
    # Qi, Ki: chunk j -> row ((j >> 3) // KC) * 8 + (j & 7), bytes (j >> 3) % KC * 16 ..
    KC = Hk // 16
    j = np.arange(Nk * Hk // 16)
    r, c0 = ((j >> 3) // KC) * 8 + (j & 7), ((j >> 3) % KC) * 16
    cols = c0[:, None] + np.arange(16)
    for w, t in enumerate((qi, ki)):
        tiles[:2 * B * H * Nk * Hk].reshape(2, B, H, -1)[w] = \
            t.numpy()[:, :, r[:, None], cols].reshape(B, H, -1)
    # Vt: chunk j -> row ((j >> 5) % NR) * 8 + (j & 7), keys from
    # ((j >> 5) // NR) * 64 + ((j >> 3) & 3) * 16
    NR = Hv // 8
    j = np.arange(Nk * Hv // 16)
    n, key0 = ((j >> 5) % NR) * 8 + (j & 7), ((j >> 5) // NR) * 64 + ((j >> 3) & 3) * 16
    keys = key0[:, None] + np.arange(16)
    tiles[2 * B * H * Nk * Hk:] = vt.numpy()[:, :, n[:, None], keys].reshape(-1)
    got = sa.blocked_to_plain(torch.from_numpy(tiles), B, H, N, hd)
    assert all(torch.equal(a, b) for a, b in zip(got, (qi, ki, vt)))
