"""The port's CUDA kernels against their plain twins on the card.

These need an NVIDIA GPU with nvcc (marker ``cuda``) and skip elsewhere.
The file imports no JAX, so it also runs on a machine without it:

    python -m pytest tests/test_torch_cuda.py -m cuda -q
"""
import dataclasses

import numpy as np
import pytest
import torch

from hamer_yolo_tpu_torch.geometry.boxes import box_iou
from hamer_yolo_tpu_torch.models.vit import ViTConfig, init_vit, vit_forward
from hamer_yolo_tpu_torch.ops.attn_block import (check_against_twin, fused_bf16_attn_block,
                                                  fused_bf16_attn_block_ref)
from hamer_yolo_tpu_torch.ops.nms import greedy_nms_keep, greedy_nms_keep_ref

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernels have no CPU mode)")
    return torch.device("cuda")


def _boxes(rng, B, K, near=False):
    if near:  # clusters shifted by quarter pixels: IoUs exactly on a threshold
        base = rng.uniform(0, 500, (B, K // 4, 1, 2)).astype(np.float32)
        shift = rng.choice(np.float32([0.0, 0.25, 0.5, 0.75]), (B, K // 4, 4, 2))
        xy1 = (base + shift).reshape(B, -1, 2)
        return np.concatenate([xy1, xy1 + np.float32(40.0)], axis=-1).astype(np.float32)
    boxes = np.zeros((B, K, 4), np.float32)
    boxes[..., :2] = rng.uniform(0, 600, (B, K, 2))
    boxes[..., 2:] = boxes[..., :2] + rng.uniform(10, 120, (B, K, 2))
    return boxes


@pytest.mark.parametrize("K", [64, 252, 512])
@pytest.mark.parametrize("near", [False, True], ids=["random", "at_threshold"])
def test_nms_kernel_matches_twin(dev, K, near):
    rng = np.random.default_rng(K)
    boxes = torch.from_numpy(_boxes(rng, 4, K, near)).to(dev)
    active = torch.from_numpy((rng.uniform(0, 1, (4, K)) > 0.2).astype(np.float32)).to(dev)
    thr = float(box_iou(boxes[0, :1], boxes[0, 1:2])[0, 0]) if near else 0.45
    before = greedy_nms_keep.launches
    got = greedy_nms_keep(boxes, active, thr)
    torch.cuda.synchronize()
    assert greedy_nms_keep.launches == before + 1
    assert torch.equal(got, greedy_nms_keep_ref(boxes, active, thr))


# (B, N, K, heads): ViT-H; head widths 64 and 32; ragged N with hd 24 padded
# to 32 in shared memory; the tiny config's N = 12, hd = 16.
@pytest.mark.parametrize("B,N,K,h", [(8, 192, 1280, 16), (3, 64, 128, 2), (2, 80, 96, 3),
                                     (2, 50, 72, 3), (4, 12, 64, 4)])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "f32"])
def test_attn_block_kernel_matches_twin(dev, B, N, K, h, dtype):
    rng = np.random.default_rng(N)
    f = lambda *s: torch.from_numpy(rng.normal(size=s).astype(np.float32)).to(dev)  # noqa: E731
    tok = f(B, N, K).to(dtype)
    args = (f(K, 3 * K) * K ** -0.5, 0.1 * f(3 * K), 1.0 + 0.1 * f(K), 0.1 * f(K), h)
    before = fused_bf16_attn_block.launches
    got = fused_bf16_attn_block(tok, *args)
    torch.cuda.synchronize()
    assert fused_bf16_attn_block.launches == before + 1
    assert got.dtype == dtype and got.shape == (B, N, K)
    # the limits and their reasons: ops/attn_block.py, above check_against_twin
    check_against_twin(got, fused_bf16_attn_block_ref(tok, *args))


def test_attn_block_kernel_rejects_what_it_does_not_take(dev):
    tok = torch.zeros((2, 12, 64), dtype=torch.bfloat16, device=dev)
    w = torch.zeros((64, 192), device=dev)
    vec = torch.zeros(64, device=dev)
    with pytest.raises(ValueError, match="unsupported shapes"):  # 16 heads of width 4
        fused_bf16_attn_block(tok, w, torch.zeros(192, device=dev), vec, vec, 16)
    with pytest.raises(ValueError, match="bf16 or f32 tokens"):
        fused_bf16_attn_block(tok.half(), w, None, vec, vec, 4)
    with pytest.raises(ValueError, match="unsupported shapes"):  # LN vectors of the wrong width
        fused_bf16_attn_block(tok, w, None, vec[:32], vec, 4)
    with pytest.raises(ValueError, match="every tensor must be on"):  # bias left on the host
        fused_bf16_attn_block(tok, w, torch.zeros(192), vec, vec, 4)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("img_size", [(64, 48), (256, 192)], ids=["N12", "N192"])
def test_vit_on_cuda_runs_k2(dev, dtype, img_size):
    """A ViT on the card runs K2 in every block whatever its dtype, and
    agrees with the same ViT on the CPU through K2's twin."""
    cfg = ViTConfig(img_size=img_size, embed_dim=64, depth=2, num_heads=4, compute_dtype=dtype)
    params = init_vit(torch.Generator().manual_seed(0), cfg)
    x = torch.from_numpy(np.random.default_rng(0).normal(size=(2, *img_size, 3)).astype(np.float32))
    before = fused_bf16_attn_block.launches
    got = vit_forward(_to(params, dev), x.to(dev), cfg)
    torch.cuda.synchronize()
    assert fused_bf16_attn_block.launches == before + cfg.depth
    ref = vit_forward(params, x, dataclasses.replace(cfg, fused_attn=True))
    assert got.dtype == ref.dtype and torch.isfinite(got).all()
    # two blocks carry single bf16 flips on through f32 or bf16 residuals
    # and LayerNorms: the JAX package's bf16 tolerance
    # (tests/test_pallas_kernels.py:164-167)
    torch.testing.assert_close(got.float().cpu(), ref.float(), rtol=0.05, atol=0.05)


def _to(tree, dev):
    if isinstance(tree, dict):
        return {k: _to(v, dev) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_to(v, dev) for v in tree]
    return None if tree is None else tree.to(dev)


def test_nms_kernel_rejects_host_mask(dev):
    boxes = torch.zeros((1, 8, 4), device=dev)
    with pytest.raises(ValueError, match="active on cpu"):
        greedy_nms_keep(boxes, torch.ones((1, 8)), 0.5)
