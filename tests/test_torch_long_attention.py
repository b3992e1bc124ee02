"""Attention past 256 keys: the port's plain versions of K7 and K2, which
the card's key-block kernels are held to, against the JAX package's Pallas
kernels in interpret mode, and a 2-block ViT with 266 tokens through
vit_forward against JAX's, on both of the port's paths (the plain attention
and K2's twin). Tolerances are those of the existing K7, K2 and ViT tests
(tests/test_torch_int8_kernels.py, tests/test_torch_attn_block.py)."""
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
from hamer_yolo_tpu.ops.attention_pallas import fused_short_attention as jax_k7
from hamer_yolo_tpu_torch.models.vit import ViTConfig, vit_forward
from hamer_yolo_tpu_torch.ops.attn_block import fused_bf16_attn_block
from hamer_yolo_tpu_torch.ops.short_attention import fused_short_attention
from test_torch_bridge import jax_exact, numpy_params, to_port

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
