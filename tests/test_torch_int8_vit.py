"""The int8 ViT against the JAX package: a 2-block vit_forward_int8 on the
kernels' plain versions (fused=True) and on the unfused composition
(fused=False), with dynamic and with calibrated static scales, and the
calibration stats. Weights are made with numpy, quantized and calibrated by
the JAX package (compiled), and loaded through core/bridge.py."""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from hamer_yolo_tpu.core import quant as jquant
from hamer_yolo_tpu.models.vit import ViTConfig as JViT
from hamer_yolo_tpu.models.vit import init_vit as jinit_vit
from hamer_yolo_tpu_torch.core import quant
from hamer_yolo_tpu_torch.models.vit import ViTConfig
from test_torch_bridge import jax_exact, numpy_params, to_port

torch.set_num_threads(1)

# The JAX package's int8 ViT test config (tests/test_int8_fused.py:498-500)
SHAPE = dict(img_size=(32, 32), patch_size=16, patch_padding=0, embed_dim=128, depth=2,
             num_heads=4)


def _setup(dtype="float32", seed=0):
    jcfg, tcfg = JViT(**SHAPE, compute_dtype=dtype), ViTConfig(**SHAPE, compute_dtype=dtype)
    params = jax.tree_util.tree_map(jnp.asarray, numpy_params(lambda k: jinit_vit(k, jcfg), seed))
    pq = jax.jit(jquant.quantize_vit_params)(params)
    x = np.random.default_rng(seed + 1).normal(size=(2, 32, 32, 3)).astype(np.float32)
    stats = jax_exact(lambda p, xx: jquant.collect_vit_act_stats(p, xx, jcfg), pq, jnp.asarray(x))
    ps = jax.jit(jquant.attach_static_act_scales)(pq, stats)
    return jcfg, tcfg, {"dynamic": pq, "static": ps}, x, stats


@pytest.mark.parametrize("scales", ["static", "dynamic"])
def test_fused_matches_jax_fused(scales):
    """Kernel math: the port's plain versions (K3 + K4 with static scales,
    K5 + K7 + K5 and K5 twice without) against JAX's Pallas kernels in
    interpret mode, at the JAX package's tolerance for its fused int8 ViT
    (tests/test_int8_fused.py:509-510)."""
    jcfg, tcfg, trees, x, _ = _setup()
    ref = jax_exact(lambda p, xx: jquant.vit_forward_int8(p, xx, jcfg, fused=True, interpret=True),
                    trees[scales], jnp.asarray(x))
    got = quant.vit_forward_int8(to_port(trees[scales]), torch.from_numpy(x), tcfg, fused=True)
    assert got.shape == ref.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=0.05, atol=0.05)


@pytest.mark.parametrize("scales", ["static", "dynamic"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_unfused_matches_jax_unfused(scales, dtype):
    """The unfused composition (int8_linear, the einsum attention) in the
    compute dtype against JAX's fused=False, compiled with excess precision
    off. Both quantize the same values by the same rule; they part only
    where XLA's FMA contraction, summation order or rsqrt moves an LN or
    attention output across an int8 rounding midpoint, which moves one row
    by one int8 step and carries on through the residual stream. Limits: in
    f32, 1e-3 on all but 1% of elements (those rows) and 0.05 on every
    element; in bf16, where each op rounds to 8 bits, the bf16 ViT
    tolerance of the JAX package (tests/test_pallas_kernels.py:164-167)."""
    jcfg, tcfg, trees, x, _ = _setup(dtype)
    ref = np.asarray(jax_exact(lambda p, xx: jquant.vit_forward_int8(p, xx, jcfg, fused=False),
                               trees[scales], jnp.asarray(x)), np.float32)
    got = quant.vit_forward_int8(to_port(trees[scales]), torch.from_numpy(x), tcfg,
                                 fused=False).float().numpy()
    if dtype == "float32":
        assert np.isclose(got, ref, rtol=1e-3, atol=1e-3).mean() > 0.99
        np.testing.assert_allclose(got, ref, rtol=0.05, atol=0.05)
    else:
        np.testing.assert_allclose(got, ref, rtol=0.05, atol=0.05)


def test_collect_act_stats_matches_jax():
    """The calibration stats: absmax values of the same activations, equal
    to f32 reassociation (1e-5 relative) unless an upstream int8 flip (see
    above) moved a later block's activations, which stays well inside the
    margin a static scale leaves (1e-3 relative)."""
    jcfg, tcfg, trees, x, stats = _setup()
    got = quant.collect_vit_act_stats(to_port(trees["dynamic"]), torch.from_numpy(x), tcfg)
    assert len(got["blocks"]) == len(stats["blocks"]) == 2
    for a, b in zip(got["blocks"], stats["blocks"]):
        assert set(a) == set(b) == set(quant.STAT_KEYS)
        for k in a:
            np.testing.assert_allclose(float(a[k]), float(b[k]), rtol=1e-3, err_msg=k)
    ps = to_port(trees["static"])
    mine = quant.attach_static_act_scales(to_port(trees["dynamic"]), got)
    for blk, ref in zip(mine["blocks"], ps["blocks"]):
        np.testing.assert_allclose(float(blk["mlp"]["fc2"]["sx"]), float(ref["mlp"]["fc2"]["sx"]),
                                   rtol=1e-3)


@pytest.mark.parametrize("env", [None, "0", "1"])
def test_int8_fused_switch_matches_jax(env, monkeypatch):
    """HYT_INT8_FUSED: where neither ``fused`` nor cfg.fused_attn decides,
    the kernels run where the tokens are on the card (JAX: on a TPU) unless
    the switch is "0". The decision against a stand-in for a card tensor,
    then vit_forward_int8 (fused=None) against JAX's with the switch set and
    JAX's quant._on_tpu given True (its "0" takes the unfused composition,
    the CPU's path here; HYT_ATTN=xla keeps its on-TPU attention default
    off the Pallas kernel), at the unfused test's bf16 limit. On the CPU the
    port's tokens take the unfused composition whatever the switch says, so
    the forward comparison holds the composition "0" selects, and only the
    stand-in reads the switch; on the card
    tests/test_torch_cuda.py::test_int8_vit_on_cuda_under_hyt_int8_fused_0
    reads it."""
    from types import SimpleNamespace

    if env is None:
        monkeypatch.delenv("HYT_INT8_FUSED", raising=False)
    else:
        monkeypatch.setenv("HYT_INT8_FUSED", env)
    jcfg, tcfg, trees, x, _ = _setup("bfloat16")
    on_card = SimpleNamespace(is_cuda=True)
    assert quant.default_fused(on_card, tcfg) == (env != "0")
    assert quant.default_fused(on_card, ViTConfig(**SHAPE, fused_attn=True))
    assert not quant.default_fused(torch.zeros(1), tcfg)
    if env == "0":
        monkeypatch.setattr(jquant, "_on_tpu", lambda: True)
        monkeypatch.setenv("HYT_ATTN", "xla")
    ref = np.asarray(jax_exact(lambda p, xx: jquant.vit_forward_int8(p, xx, jcfg),
                               trees["dynamic"], jnp.asarray(x)), np.float32)
    got = quant.vit_forward_int8(to_port(trees["dynamic"]), torch.from_numpy(x), tcfg)
    np.testing.assert_allclose(got.float().numpy(), ref, rtol=0.05, atol=0.05)
