"""The port's CUDA kernels against their plain twins on the card.

These need an NVIDIA GPU with nvcc (marker ``cuda``) and skip elsewhere.
The file imports no JAX, so it also runs on a machine without it:

    python -m pytest tests/test_torch_cuda.py -m cuda -q
"""
import dataclasses

import numpy as np
import pytest
import torch

from hamer_yolo_tpu_torch.core import nn, quant
from hamer_yolo_tpu_torch.geometry.boxes import box_iou
from hamer_yolo_tpu_torch.models.vit import ViTConfig, init_vit, vit_forward
from hamer_yolo_tpu_torch.ops.attn_block import (check_against_twin, fused_bf16_attn_block,
                                                  fused_bf16_attn_block_ref)
from hamer_yolo_tpu_torch.ops import attn_block_int8, attn_proj_block, mano_lbs
from hamer_yolo_tpu_torch.ops import int8_matmul as im
from hamer_yolo_tpu_torch.ops.attn_block_int8 import fused_int8_attn_block
from hamer_yolo_tpu_torch.ops.attn_proj_block import fused_int8_attn_proj_block
from hamer_yolo_tpu_torch.ops.int8_matmul import (check_against_plain, fused_int8_matmul,
                                                  fused_int8_matmul_ref, fused_int8_mlp_block,
                                                  fused_int8_mlp_block1,
                                                  fused_int8_mlp_block1_ref,
                                                  fused_int8_mlp_block_ref)
from hamer_yolo_tpu_torch.ops.mano_lbs import mano_lbs_fused, mano_lbs_fused_ref
from hamer_yolo_tpu_torch.ops.pointnet import smallest_k
from hamer_yolo_tpu_torch.ops.nms import (MAX_K, greedy_nms_keep, greedy_nms_keep_mask,
                                          greedy_nms_keep_ref, non_max_suppression)
from hamer_yolo_tpu_torch.ops.short_attention import (flavoured_attention_ref,
                                                      fused_qkv_attention,
                                                      fused_qkv_attention_ref,
                                                      fused_short_attention,
                                                      fused_short_attention_ref,
                                                      int8_products_attention, launch_attention,
                                                      quantize_heads, quantize_heads_ref)
from test_torch_train_pairs import CASES as TRAIN_CASES, card_against_cpu

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


@pytest.mark.parametrize("B", [1, 4, 16])
@pytest.mark.parametrize("K", [64, 252, 512, 1000, 1024, 2048])
@pytest.mark.parametrize("near", [False, True], ids=["random", "at_threshold"])
def test_nms_kernel_matches_twin(dev, K, near, B):
    rng = np.random.default_rng(K)
    boxes = torch.from_numpy(_boxes(rng, B, K, near)).to(dev)
    active = torch.from_numpy((rng.uniform(0, 1, (B, K)) > 0.2).astype(np.float32)).to(dev)
    thr = float(box_iou(boxes[0, :1], boxes[0, 1:2])[0, 0]) if near else 0.45
    before = greedy_nms_keep.launches
    got = greedy_nms_keep(boxes, active, thr)
    torch.cuda.synchronize()
    assert greedy_nms_keep.launches == before + 1
    ref = greedy_nms_keep_ref(boxes, active, thr)
    assert torch.equal(got, ref)
    assert torch.equal(greedy_nms_keep_mask(boxes, active > 0.5, thr), ref > 0.5)


def _edge_case(rng, name, B, K):
    """(boxes, active, thr) of one edge case of K1 (tests/test_torch_nms.py
    holds the same cases against JAX on the CPU)."""
    boxes = _boxes(rng, B, K)
    active = (rng.uniform(0, 1, (B, K)) > 0.2).astype(np.float32)
    thr = 0.45
    if name == "all_inactive":
        active[:] = 0
    elif name == "all_active_disjoint":
        x = np.arange(K, dtype=np.float32) * 50
        boxes = np.broadcast_to(np.stack([x, x * 0, x + 40, x * 0 + 40], -1), (B, K, 4)).copy()
        active[:] = 1
    elif name == "identical":
        boxes[:] = boxes[:, :1]
        active[:, :3] = 0
    elif name == "degenerate":  # x2 < x1 or y2 < y1: negative areas
        flip = rng.uniform(0, 1, (B, K)) < 0.3
        boxes[flip] = boxes[flip][:, [2, 1, 0, 3]]
        flip = rng.uniform(0, 1, (B, K)) < 0.3
        boxes[flip] = boxes[flip][:, [0, 3, 2, 1]]
    elif name == "negative_thr":
        thr = -0.1
    elif name == "nan_thr":
        thr = float("nan")
    return boxes.astype(np.float32), active, thr


@pytest.mark.parametrize("K", [96, 1000, 2048])
@pytest.mark.parametrize("case", ["all_inactive", "all_active_disjoint", "identical",
                                  "degenerate", "negative_thr", "nan_thr"])
def test_nms_kernel_edge_cases(dev, case, K):
    boxes, active, thr = _edge_case(np.random.default_rng(K), case, 3, K)
    boxes, active = torch.from_numpy(boxes).to(dev), torch.from_numpy(active).to(dev)
    got = greedy_nms_keep(boxes, active, thr)
    torch.cuda.synchronize()
    ref = greedy_nms_keep_ref(boxes, active, thr)
    assert torch.equal(got, ref)
    assert torch.equal(greedy_nms_keep_mask(boxes, active > 0.5, thr), ref > 0.5)
    want = {"all_inactive": 0, "all_active_disjoint": 3 * K, "identical": 3, "negative_thr": 3,
            "nan_thr": int(active.sum())}
    if case in want:
        assert int(got.sum()) == want[case]


def test_nms_kernel_rejects_k_past_its_limit(dev):
    boxes = torch.zeros((1, MAX_K + 1, 4), device=dev)
    with pytest.raises(ValueError, match=f"outside 1..{MAX_K}"):
        greedy_nms_keep(boxes, torch.ones((1, MAX_K + 1), device=dev), 0.5)
    with pytest.raises(ValueError, match="bool active"):
        greedy_nms_keep_mask(boxes[:, :8], torch.ones((1, 8), device=dev), 0.5)


@pytest.mark.parametrize("max_nms_static", [512, 1024, MAX_K])
def test_non_max_suppression_on_card_matches_cpu(dev, max_nms_static):
    """Up to MAX_K candidates on the card (K1 took 512 before): the same
    detections as the CPU twin."""
    rng = np.random.default_rng(max_nms_static)
    N, nc = max_nms_static + 300, 3
    pred = np.zeros((2, N, 5 + nc), np.float32)
    pred[..., :2] = rng.uniform(20, 600, (2, N, 2))
    pred[..., 2:4] = rng.uniform(8, 120, (2, N, 2))
    pred[..., 4:] = rng.uniform(0, 1, (2, N, 1 + nc))
    kw = dict(conf_thres=0.25, iou_thres=0.45, agnostic=False, max_det=300,
              max_nms_static=max_nms_static)
    before = greedy_nms_keep.launches
    got = non_max_suppression(torch.from_numpy(pred).to(dev), **kw)
    torch.cuda.synchronize()
    assert greedy_nms_keep.launches == before + 1
    ref = non_max_suppression(torch.from_numpy(pred), **kw)
    for k in ("boxes", "scores", "classes", "valid"):
        assert torch.equal(getattr(got, k).cpu(), getattr(ref, k)), k
    assert ref.valid.any()


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


# (B, N, K, heads) at the main path's M = B N: 1 frame of 4 crops (768), 4
# frames (3072) and 16 (12288), one crop (192) and a ragged M (B 3, N 100,
# 300 rows: a partial 128-row tile); ViT-H's K = 1280 (16 heads of 80) and
# K = 192 (3 heads of 64, three 64-wide K steps).
K2_M_CASES = [pytest.param(B, N, K, h, id=f"M{B * N}_K{K}")
              for K, h in ((1280, 16), (192, 3))
              for B, N in ((1, 192), (4, 192), (16, 192), (64, 192), (3, 100))]


@pytest.mark.parametrize("B,N,K,h", K2_M_CASES)
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "f32"])
def test_attn_block_kernel_at_the_paths_rows(dev, B, N, K, h, dtype):
    rng = np.random.default_rng(B * N + K)
    f = lambda *s: torch.from_numpy(rng.normal(size=s).astype(np.float32)).to(dev)  # noqa: E731
    tok = f(B, N, K).to(dtype)
    args = (f(K, 3 * K) * K ** -0.5, 0.1 * f(3 * K), 1.0 + 0.1 * f(K), 0.1 * f(K), h)
    got = fused_bf16_attn_block(tok, *args)
    torch.cuda.synchronize()
    assert got.dtype == dtype and got.shape == (B, N, K)
    check_against_twin(got, fused_bf16_attn_block_ref(tok, *args))


# N past the single-pass attention kernel's 256 keys: the key-block form
@pytest.mark.parametrize("B,N,K,h", [(2, 257, 256, 4), (2, 320, 240, 3), (1, 577, 1280, 16),
                                     (2, 1024, 256, 4)], ids=["n257", "n320", "n577", "n1024"])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "f32"])
def test_attn_block_kernel_beyond_256_keys(dev, B, N, K, h, dtype):
    rng = np.random.default_rng(N)
    f = lambda *s: torch.from_numpy(rng.normal(size=s).astype(np.float32)).to(dev)  # noqa: E731
    tok = f(B, N, K).to(dtype)
    args = (f(K, 3 * K) * K ** -0.5, 0.1 * f(3 * K), 1.0 + 0.1 * f(K), 0.1 * f(K), h)
    got = fused_bf16_attn_block(tok, *args)
    torch.cuda.synchronize()
    assert got.dtype == dtype and got.shape == (B, N, K)
    check_against_twin(got, fused_bf16_attn_block_ref(tok, *args))


def test_vit_casts_weights_once(dev):
    """A bf16 ViT on the card casts its weights to bf16 in the first forward
    (K2's qkv weight and its TMA map, proj, fc1, fc2) and never again."""
    cfg = ViTConfig(img_size=(64, 48), embed_dim=64, depth=2, num_heads=4)
    params = _to(init_vit(torch.Generator().manual_seed(0), cfg), dev)
    x = torch.from_numpy(np.random.default_rng(0).normal(size=(2, 64, 48, 3)).astype(np.float32))
    casts = []
    for _ in range(2):
        before = nn.cast_weight.casts
        vit_forward(params, x.to(dev), cfg)
        torch.cuda.synchronize()
        casts.append(nn.cast_weight.casts - before)
    assert casts[0] >= 4 * cfg.depth and casts[1] == 0, casts


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
@pytest.mark.parametrize("img_size", [(64, 48), (256, 192), (304, 224)],
                         ids=["N12", "N192", "N266"])
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


# ------------------------------------------------------- the int8 kernels
def _qlinear(rng, dev, K, N, scale=0.05):
    w = quant.quantize_weight_int8(torch.from_numpy(
        (rng.normal(size=(K, N)) * scale).astype(np.float32)))
    b = torch.from_numpy((0.1 * rng.normal(size=N)).astype(np.float32))
    return w["q"].to(dev), w["scale"].to(dev), b.to(dev)


def _vec(rng, dev, K, mean=0.0):
    return torch.from_numpy((mean + 0.1 * rng.normal(size=K)).astype(np.float32)).to(dev)


@pytest.mark.parametrize("M,K,N", [(3072, 1280, 3840), (384, 5120, 1280), (24, 64, 192)],
                         ids=["vith_qkv", "vith_fc2", "tiny"])
@pytest.mark.parametrize("prologue", ["ln", "gelu", "gelu_poly", "id"])
@pytest.mark.parametrize("static", [False, True], ids=["dynamic", "static"])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "f32"])
def test_k5_matches_plain(dev, M, K, N, prologue, static, dtype):
    rng = np.random.default_rng(M + K)
    x = torch.from_numpy(rng.normal(size=(M, K)).astype(np.float32)).to(dev).to(dtype)
    q, s, b = _qlinear(rng, dev, K, N)
    g, bt = _vec(rng, dev, K, 1.0), _vec(rng, dev, K)
    sx = torch.tensor(0.03, device=dev) if static else None
    before = fused_int8_matmul.launches
    got = fused_int8_matmul(x, q, s, b, g, bt, prologue=prologue, static_scale=sx)
    torch.cuda.synchronize()
    assert fused_int8_matmul.launches == before + 1
    assert got.dtype == dtype and got.shape == (M, N)
    check_against_plain(got, fused_int8_matmul_ref(x, q, s, b, g, bt, prologue=prologue,
                                                   static_scale=sx), "K5")


@pytest.mark.parametrize("M,K", [(3072, 1280), (24, 64)], ids=["vith", "tiny"])
@pytest.mark.parametrize("gelu", ["gelu", "gelu_poly"])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "f32"])
def test_k4_matches_plain(dev, M, K, gelu, dtype):
    rng = np.random.default_rng(M)
    tok = torch.from_numpy(rng.normal(size=(M // 24, 24, K)).astype(np.float32)).to(dev)
    tok = tok.to(dtype)
    q1, s1, b1 = _qlinear(rng, dev, K, 4 * K)
    q2, s2, b2 = _qlinear(rng, dev, 4 * K, K, scale=0.02)
    args = (q1, s1, b1, q2, s2, b2, _vec(rng, dev, K, 1.0), _vec(rng, dev, K),
            torch.tensor(0.034, device=dev), torch.tensor(0.021, device=dev))
    before = fused_int8_mlp_block.launches
    got = fused_int8_mlp_block(tok, *args, gelu=gelu)
    torch.cuda.synchronize()
    assert fused_int8_mlp_block.launches == before + 1 and got.dtype == dtype
    check_against_plain(got, fused_int8_mlp_block_ref(tok, *args, gelu=gelu), "K4")


# ------------------------------------------------- the int8 GEMM launch alone
# (M, K, N): one row; the edges of a 64-row warpgroup and a 128-row tile; K
# shorter than one 128-byte ring stage (16, 48) and longer than the ring
# (1280 and 5120: 10 and 40 stages, so every mbarrier phase comes round);
# N from one 16-column vector to ViT-H's widths; ViT-H's M = 3072 and 12288.
GEMM_SHAPES = {"m1": (1, 16, 16), "m63_k48": (63, 48, 192), "m64": (64, 1280, 1280),
               "m65_k5120": (65, 5120, 1280), "m129_n3840": (129, 1280, 3840),
               "m129_k48_n5120": (129, 48, 5120), "m65_k16_n3840": (65, 16, 3840),
               "vith_fc1": (3072, 1280, 5120), "vith_fc2": (3072, 5120, 1280),
               "m12288_qkv": (12288, 1280, 3840), "m12288_fc2": (12288, 5120, 1280)}
# epilogue -> (EPI_*, per-row scales, GELU); EPI_GELU_Q writes int8
GEMM_EPILOGUES = {"deq_row": (im.EPI_DEQ_ROW, False, None),
                  "deq_row_per_row": (im.EPI_DEQ_ROW, True, None),
                  "deq_fold": (im.EPI_DEQ_FOLD, False, None), "resid": (im.EPI_RESID, False, None),
                  "proj": (im.EPI_PROJ, False, None), "gelu_q_poly": (im.EPI_GELU_Q, False, "gelu_poly"),
                  "gelu_q_exact": (im.EPI_GELU_Q, False, "gelu")}
GEMM_CASES = [pytest.param(shape, epi, dtype, id=f"{sname}-{ename}-{dname}")
              for sname, shape in GEMM_SHAPES.items() for ename, epi in GEMM_EPILOGUES.items()
              for dname, dtype in (("bf16", torch.bfloat16), ("f32", torch.float32))
              if epi[0] != im.EPI_GELU_Q or dname == "bf16"]


def _gemm_operands(rng, dev, M, K, N, epi, dtype):
    """Random int8 operands, scales, bias and the epilogue's extra inputs."""
    code, per_row, gelu = epi
    a = torch.from_numpy(rng.integers(-127, 128, (M, K)).astype(np.int8)).to(dev)
    w = torch.from_numpy(rng.integers(-127, 128, (K, N)).astype(np.int8)).to(dev)
    ws = torch.from_numpy((1e-4 + 1e-3 * rng.random(N)).astype(np.float32)).to(dev)
    kw = {"row_scale": (torch.from_numpy((1e-3 + 0.02 * rng.random(M)).astype(np.float32))
                        .to(dev) if per_row else None),
          "s": None if per_row else torch.tensor([0.02], device=dev),
          "res": (torch.from_numpy(rng.normal(size=(M, N)).astype(np.float32)).to(dev).to(dtype)
                  if code in (im.EPI_RESID, im.EPI_PROJ) else None),
          "out_scale": torch.tensor([0.05], device=dev) if code == im.EPI_GELU_Q else None}
    return a, w, ws, _vec(rng, dev, N), kw


@pytest.mark.parametrize("shape,epi,dtype", GEMM_CASES)
def test_int8_gemm_matches_plain(dev, shape, epi, dtype):
    """The GEMM launch alone against int8_gemm_ref on the same int8 input:
    bit for bit (exact int32 sums, the same f32 op order), except EPI_GELU_Q,
    whose GELU may sit within an ulp of an int8 rounding midpoint: +-1 on at
    most MAX_FRAC_INT8_FLIPPED of elements."""
    M, K, N = shape
    code, _, gelu = epi
    rng = np.random.default_rng(M + K + N)
    a, w, ws, b, kw = _gemm_operands(rng, dev, M, K, N, epi, dtype)
    out = torch.empty((M, N), dtype=torch.int8 if code == im.EPI_GELU_Q else dtype, device=dev)
    im.int8_gemm(a, w, code, out, ws, b, gelu_poly=gelu == "gelu_poly", **kw)
    torch.cuda.synchronize()
    ref = im.int8_gemm_ref(a, w, code, ws, b, gelu=gelu or "gelu", out_dtype=dtype, **kw)
    assert out.dtype == ref.dtype
    if code == im.EPI_GELU_Q:
        check_against_plain(out, ref, "the int8 GEMM with EPI_GELU_Q")
    else:
        assert torch.equal(out, ref), float((out.float() - ref.float()).abs().max())


@pytest.mark.parametrize("shape", [(300, 48, 208), (20000, 48, 208), (20000, 16, 16)],
                         ids=["m300_k48_n208", "m20000_k48_n208", "m20000_k16_n16"])
def test_int8_gemm_ragged_tiles_match_plain(dev, shape):
    """N = 208 leaves part of the last column tile; at M = 20000 the 314 and
    157 tiles outnumber the CTAs (one an SM), so CTAs walk two or three
    tiles, ring stages and mbarrier phases carrying over from tile to
    tile."""
    M, K, N = shape
    rng = np.random.default_rng(M + N)
    epi = GEMM_EPILOGUES["resid"]
    a, w, ws, b, kw = _gemm_operands(rng, dev, M, K, N, epi, torch.bfloat16)
    out = torch.empty((M, N), dtype=torch.bfloat16, device=dev)
    im.int8_gemm(a, w, im.EPI_RESID, out, ws, b, **kw)
    torch.cuda.synchronize()
    assert torch.equal(out, im.int8_gemm_ref(a, w, im.EPI_RESID, ws, b, **kw))


def test_int8_gemm_kmajor_copy_made_once(dev):
    """The first launch on a weight makes its K-major copy and TMA map; later
    launches reuse them, and the card's copy is the transpose."""
    rng = np.random.default_rng(7)
    a, w, ws, b, kw = _gemm_operands(rng, dev, 70, 64, 48, GEMM_EPILOGUES["deq_fold"],
                                     torch.bfloat16)
    out = torch.empty((70, 48), dtype=torch.bfloat16, device=dev)
    before = im.kmajor_weight.transposes
    for _ in range(3):
        im.int8_gemm(a, w, im.EPI_DEQ_FOLD, out, ws, b, **kw)
    assert im.kmajor_weight.transposes == before + 1
    wt = im.kmajor_weight(w)
    assert wt.is_cuda and wt.is_contiguous() and wt.data_ptr() % 16 == 0
    assert torch.equal(wt, w.t())


@pytest.mark.parametrize("scales", ["static", "dynamic"])
def test_int8_vit_makes_kmajor_copies_once(dev, scales):
    """Quantized on the card, the int8 ViT's tree has every K-major copy (4 a
    block) and two forwards make none; quantized on the CPU and moved to the
    card, it makes them in its first forward and none in its second."""
    cfg = ViTConfig(img_size=(64, 48), embed_dim=64, depth=2, num_heads=4)
    vit = init_vit(torch.Generator().manual_seed(0), cfg)
    x = torch.from_numpy(np.random.default_rng(0).normal(size=(3, 64, 48, 3)).astype(np.float32))
    x = x.to(dev)
    before = im.kmajor_weight.transposes
    on_card = quant.quantize_vit_params(_to(vit, dev))
    assert im.kmajor_weight.transposes == before + 4 * cfg.depth
    moved = _to(quant.quantize_vit_params(vit), dev)
    if scales == "static":
        stats = quant.collect_vit_act_stats(on_card, x, cfg)
        on_card = quant.attach_static_act_scales(on_card, stats)
        moved = quant.attach_static_act_scales(moved, stats)
    for tree, first in ((on_card, 0), (moved, 4 * cfg.depth)):
        for want in (first, 0):
            before = im.kmajor_weight.transposes
            got = quant.vit_forward_int8(tree, x, cfg)
            torch.cuda.synchronize()
            assert im.kmajor_weight.transposes - before == want
            assert torch.isfinite(got).all()


def test_int8_gemm_rejects_what_it_does_not_take(dev):
    rng = np.random.default_rng(8)
    a, w, ws, b, kw = _gemm_operands(rng, dev, 32, 64, 48, GEMM_EPILOGUES["resid"],
                                     torch.bfloat16)
    out = torch.empty((32, 48), dtype=torch.bfloat16, device=dev)
    with pytest.raises(ValueError, match="the weight must be int8"):
        im.int8_gemm(a, w.t().contiguous(), im.EPI_RESID, out, ws, b, **kw)  # (N, K)
    with pytest.raises(ValueError, match="the weight must be int8"):
        im.int8_gemm(a, w.float(), im.EPI_RESID, out, ws, b, **kw)
    with pytest.raises(ValueError, match="multiples of 16"):
        im.int8_gemm(a[:, :56], w[:56], im.EPI_RESID, out, ws, b, **kw)
    with pytest.raises(ValueError, match="multiples of 16"):
        im.int8_gemm(a, w[:, :40], im.EPI_RESID, out[:, :40], ws[:40], b[:40],
                     **{**kw, "res": kw["res"][:, :40]})
    wide = torch.empty((32, 56), dtype=torch.bfloat16, device=dev)
    with pytest.raises(ValueError, match="16-byte aligned"):  # starts 2 bytes in
        im.int8_gemm(a, w, im.EPI_RESID, wide.view(-1)[1:1 + 32 * 48].view(32, 48), ws, b,
                     **kw)
    with pytest.raises(ValueError, match="contiguous"):
        im.int8_gemm(a, w, im.EPI_RESID, wide[:, :48], ws, b, **kw)
    with pytest.raises(ValueError, match="the residual must be"):
        im.int8_gemm(a, w, im.EPI_RESID, out, ws, b, **{**kw, "res": kw["res"].float()})
    with pytest.raises(RuntimeError, match="CUDA error"):  # EPI_GELU_Q writes int8
        im.int8_gemm(a, w, im.EPI_GELU_Q, out, ws, b, s=kw["s"],
                     out_scale=torch.tensor([0.05], device=dev))


# (B, h, N, hd, mult): ViT-H, the tiny config, ragged N with hd 24 padded to
# 32 in shared memory; the bf16 kernel's edges: one and two 64-key
# accumulators and one key past, the single-pass kernel's 256 keys and one
# short of it, head widths 16 to 128; past 256 keys, the key-block form with
# one key past a block, a ragged last block and whole blocks; q and k scaled
# by mult = 8 so that the max subtraction decides the result.
ATTN_SHAPES = {"vith": (16, 16, 192, 80, 1), "tiny": (3, 4, 12, 16, 1), "ragged": (2, 3, 70, 24, 1),
               "n64": (2, 2, 64, 64, 1), "n65": (2, 2, 65, 64, 1),
               "n128_hd128": (2, 2, 128, 128, 1), "n255_hd16": (2, 2, 255, 16, 1),
               "n256_hd128": (2, 2, 256, 128, 1), "vith_x8": (16, 16, 192, 80, 8),
               "n65_hd16_x8": (2, 2, 65, 16, 8), "n256_x8": (2, 2, 256, 64, 8),
               "n257": (2, 2, 257, 64, 1), "n320_hd80": (2, 2, 320, 80, 1),
               "n577_hd128": (2, 2, 577, 128, 1), "n1024_hd16": (2, 2, 1024, 16, 1),
               "n577_hd80_x8": (3, 2, 577, 80, 8)}


def _qkv_heads(rng, B, N, h, hd, mult, dev):
    """(B, N, 3, h, hd) f32 on ``dev``, q and k scaled by ``mult``."""
    qkv = rng.normal(size=(B, N, 3, h, hd)).astype(np.float32)
    qkv[:, :, :2] *= mult
    return torch.from_numpy(qkv).to(dev)


@pytest.mark.parametrize("B,h,N,hd,mult", list(ATTN_SHAPES.values()), ids=list(ATTN_SHAPES))
@pytest.mark.parametrize("int8_out", [False, True], ids=["bf16", "out_scale"])
def test_k7_matches_plain(dev, B, h, N, hd, mult, int8_out):
    rng = np.random.default_rng(N)
    qkv = _qkv_heads(rng, B, N, h, hd, mult, dev)
    q, k, v = (qkv[:, :, i].transpose(1, 2).to(torch.bfloat16) for i in range(3))
    sx = torch.tensor(0.011, device=dev) if int8_out else None
    before = fused_short_attention.launches
    got = fused_short_attention(q, k, v, out_scale=sx)
    torch.cuda.synchronize()
    assert fused_short_attention.launches == before + 1
    ref = fused_short_attention_ref(q, k, v, out_scale=sx)
    assert got.dtype == ref.dtype and got.shape == ref.shape
    if int8_out:
        check_against_plain(got, ref, "K7")
    else:  # the limits of K2's attention, whose math this is (ops/attn_block.py)
        check_against_twin(got, ref)


@pytest.mark.parametrize("B,h,N,hd,mult", [ATTN_SHAPES[k] for k in ("vith", "ragged", "n256_hd128")],
                         ids=["vith", "ragged", "n256_hd128"])
def test_k7_f32_output_in_k2_strides(dev, B, h, N, hd, mult):
    """bf16 q, k, v into an f32 output through the (B, N, h, hd) strides K2
    hands in: the f32 epilogue writes the values the bf16 one rounds."""
    rng = np.random.default_rng(N + 3)
    qkv = _qkv_heads(rng, B, N, h, hd, mult, dev).to(torch.bfloat16)
    q, k, v = (qkv[:, :, i].transpose(1, 2) for i in range(3))
    out = torch.full((B, N, h * hd), float("nan"), device=dev)
    launch_attention(q, k, v, out.reshape(B, N, h, hd).transpose(1, 2), None, "test")
    torch.cuda.synchronize()
    k7 = fused_short_attention(q, k, v).transpose(1, 2).reshape(B, N, h * hd)
    assert torch.equal(out.to(torch.bfloat16), k7)
    check_against_twin(out, fused_short_attention_ref(q, k, v).transpose(1, 2).reshape(B, N, -1))


def test_attention_rejects_what_it_does_not_take(dev):
    q = torch.zeros((1, 2, 64, 136), dtype=torch.bfloat16, device=dev)
    with pytest.raises(ValueError, match="hd <= 128"):
        fused_short_attention(q, q, q)
    q = torch.zeros((1, 2, 64, 64), dtype=torch.bfloat16, device=dev)
    out = torch.empty((1, 64, 2 * 64 + 4), dtype=torch.bfloat16, device=dev)[:, :, :128]
    with pytest.raises(ValueError, match="must be multiples of 8"):  # output rows of 132
        launch_attention(q, q, q, out.reshape(1, 64, 2, 64).transpose(1, 2), None, "test")


@pytest.mark.parametrize("prologue", ["ln", "gelu", "gelu_poly", "id"])
@pytest.mark.parametrize("M,force", [(8448, None), (384, "xla")], ids=["above_limit", "forced"])
def test_k5_chain_matches_plain(dev, monkeypatch, M, force, prologue):
    """K5's chain form (above FUSED_GEMM_MAX_M rows, or forced): bf16 tokens
    bit for bit with its plain version, both HYT_INT8_EP values, dynamic and
    static; f32 tokens at check_against_plain's limits (the f32 LN's sums in
    another order)."""
    rng = np.random.default_rng(M)
    q, s, b = _qlinear(rng, dev, 128, 96)
    g, bt = _vec(rng, dev, 128, 1.0), _vec(rng, dev, 128)
    x = torch.from_numpy((2.0 * rng.normal(size=(M, 128))).astype(np.float32)).to(dev)
    for ep in (None, "bf16"):
        if ep is None:
            monkeypatch.delenv("HYT_INT8_EP", raising=False)
        else:
            monkeypatch.setenv("HYT_INT8_EP", ep)
        for dtype in (torch.bfloat16, torch.float32):
            for sx in (None, torch.tensor(0.031, device=dev)):
                im.fused_int8_matmul.variant_launches.clear()
                got = fused_int8_matmul(x.to(dtype), q, s, b, g, bt, prologue=prologue,
                                        static_scale=sx, force=force)
                torch.cuda.synchronize()
                assert im.fused_int8_matmul.variant_launches == {
                    "chain" if ep is None else "chain bf16": 1}
                ref = fused_int8_matmul_ref(x.to(dtype), q, s, b, g, bt, prologue=prologue,
                                            static_scale=sx, force=force)
                if dtype == torch.bfloat16:
                    assert torch.equal(got, ref), (ep, sx)
                else:
                    check_against_plain(got, ref, "K5 chain")


K3_FORMS = [("exp", "bf16"), ("exp2", "bf16"), ("exp2p", "bf16"), ("exp", "int8"),
            ("exp2", "int8")]


# (dtype, B, N, K, h): ViT-H and the tiny config in both token dtypes, and
# 432 tokens (a 384 x 288 crop) in ViT-H's bf16. With f32 tokens at 432
# every form, the default too, reads 18% of output rows beyond one f32
# rounding (limit 15%): a row holds 1280 outputs of as many int8 attention
# values, and more keys flip more of them (ROADMAP F31).
K3_SHAPES = {"bf16-vith": (torch.bfloat16, 16, 192, 1280, 16),
             "bf16-tiny": (torch.bfloat16, 4, 12, 64, 4),
             "f32-vith": (torch.float32, 16, 192, 1280, 16),
             "f32-tiny": (torch.float32, 4, 12, 64, 4),
             "bf16-n432": (torch.bfloat16, 2, 432, 1280, 16)}


@pytest.mark.parametrize("softmax,attn_math", K3_FORMS, ids=[f"{s}-{m}" for s, m in K3_FORMS])
@pytest.mark.parametrize("dtype,B,N,K,h", list(K3_SHAPES.values()), ids=list(K3_SHAPES))
def test_k3_matches_plain(dev, B, N, K, h, dtype, softmax, attn_math):
    rng = np.random.default_rng(N + K)
    tok = torch.from_numpy(rng.normal(size=(B, N, K)).astype(np.float32)).to(dev).to(dtype)
    q, s, b = _qlinear(rng, dev, K, 3 * K)
    pq, ps, pb = _qlinear(rng, dev, K, K)
    args = (q, s, b, _vec(rng, dev, K, 1.0), _vec(rng, dev, K), torch.tensor(0.03, device=dev),
            torch.tensor(0.012, device=dev), pq, ps, pb, h)
    form = {"softmax": softmax, "attn_math": attn_math}
    before = fused_int8_attn_proj_block.launches
    got = fused_int8_attn_proj_block(tok, *args, **form)
    torch.cuda.synchronize()
    assert fused_int8_attn_proj_block.launches == before + 1 and got.dtype == dtype
    steps = attn_proj_block.fused_int8_attn_proj_block_steps(tok, *args, **form)
    assert fused_int8_attn_proj_block.launches == before + 1  # the steps count no launch
    assert torch.equal(steps[2], got)
    # the end-to-end limit and each launch against its step's plain version
    # (ops/attn_proj_block.py)
    attn_proj_block.check_against_plain(steps, tok, *args, **form)


@pytest.mark.parametrize("B,h,N,hd,mult", list(ATTN_SHAPES.values()), ids=list(ATTN_SHAPES))
@pytest.mark.parametrize("softmax", ["exp", "exp2"])
def test_k3_int8_products_match_plain(dev, B, h, N, hd, mult, softmax):
    """K3's attention step under the int8 products (HYT_ATTN_MATH=int8) at
    every attention shape: the pre-pass's scales and int8 tiles bit-equal to
    quantize_heads_ref, the output within check_against_plain's limit for
    the step (attn_proj_block.int8_products_steps of the same heads), the
    pre-pass and the attention launch counted once."""
    rng = np.random.default_rng(N + hd)
    qkv = _qkv_heads(rng, B, N, h, hd, mult, dev).to(torch.bfloat16)
    q, k, v = (qkv[:, :, i].transpose(1, 2) for i in range(3))
    got, ref = quantize_heads(q, k, v), quantize_heads_ref(q, k, v)
    torch.cuda.synchronize()
    for name, a, b in zip(("scales", "qi", "ki", "vt"), got, ref):
        assert a.shape == b.shape and torch.equal(a, b), name
    sx = torch.tensor(0.011, device=dev)
    before = int8_products_attention.launches
    out = int8_products_attention(q, k, v, sx, softmax)
    torch.cuda.synchronize()
    assert int8_products_attention.launches == before + 1
    assert out.shape == (B, h, N, hd) and out.dtype == torch.int8
    steps = attn_proj_block.int8_products_steps(qkv.reshape(B * N, 3 * h * hd), B, h, sx)
    attn_proj_block._check_int8_steps(out, flavoured_attention_ref(q, k, v, sx, softmax, "int8"),
                                      steps, "K3 (int8)")


def test_k3_int8_products_take_2048_keys(dev):
    """N = 2048 (32 key blocks, three sweeps each) launches and agrees."""
    rng = np.random.default_rng(2048)
    qkv = _qkv_heads(rng, 1, 2048, 2, 64, 1, dev).to(torch.bfloat16)
    q, k, v = (qkv[:, :, i].transpose(1, 2) for i in range(3))
    sx = torch.tensor(0.011, device=dev)
    out = int8_products_attention(q, k, v, sx)
    torch.cuda.synchronize()
    steps = attn_proj_block.int8_products_steps(qkv.reshape(2048, -1), 1, 2, sx)
    attn_proj_block._check_int8_steps(out, flavoured_attention_ref(q, k, v, sx, "exp", "int8"),
                                      steps, "K3 (int8)")


def test_int8_kernels_reject_what_they_do_not_take(dev):
    x = torch.zeros((4, 72), device=dev)
    q, s = torch.zeros((72, 32), dtype=torch.int8, device=dev), torch.ones(32, device=dev)
    with pytest.raises(ValueError, match="multiple of 16"):
        fused_int8_matmul(x, q, s)
    with pytest.raises(ValueError, match="bf16 or f32"):
        fused_int8_matmul(x[:, :64].half(), q[:64], s)
    with pytest.raises(ValueError, match="the weight must be int8"):
        fused_int8_matmul(x[:, :64], q[:64].float(), s)
    with pytest.raises(ValueError, match="static scale is on cpu"):
        fused_int8_matmul(x[:, :64], q[:64], s, static_scale=torch.tensor(0.1))
    qkv = torch.zeros((2, 3, 12, 16), dtype=torch.bfloat16, device=dev)
    with pytest.raises(ValueError, match="one float dtype, bf16 or f32"):
        fused_short_attention(qkv.half(), qkv.half(), qkv.half())
    with pytest.raises(ValueError, match="one float dtype, bf16 or f32"):
        fused_short_attention(qkv, qkv.float(), qkv)


@pytest.mark.parametrize("img_size", [(64, 48), (256, 192)], ids=["N12", "N192"])
def test_int8_vit_on_cuda_runs_the_kernels(dev, img_size):
    """The int8 ViT on the card: static scales run K3 and K4 once per block
    and no K2; without scales K5 four times and K7 once per block. Each
    agrees with the same blocks on the CPU through the plain versions, fed
    the card's own embedded tokens (cuDNN's bf16 patch embedding differs
    from the CPU's in the last bit, which alone flips int8 values)."""
    from hamer_yolo_tpu_torch.models.vit import embed_tokens

    cfg = ViTConfig(img_size=img_size, embed_dim=64, depth=2, num_heads=4)
    params = quant.quantize_vit_params(init_vit(torch.Generator().manual_seed(0), cfg))
    x = torch.from_numpy(np.random.default_rng(0).normal(size=(3, *img_size, 3)).astype(np.float32))
    before = fused_short_attention.launches
    stats = quant.collect_vit_act_stats(_to(params, dev), x.to(dev), cfg)
    assert fused_short_attention.launches == before + cfg.depth  # calibration runs K7
    static = quant.attach_static_act_scales(params, _to(stats, torch.device("cpu")))
    for tree, counts in ((static, {"K3": 1, "K4": 1, "K5": 0, "K7": 0}),
                         (params, {"K3": 0, "K4": 0, "K5": 4, "K7": 1})):
        fns = {"K2": fused_bf16_attn_block, "K3": fused_int8_attn_proj_block,
               "K4": fused_int8_mlp_block, "K5": fused_int8_matmul, "K7": fused_short_attention}
        before = {k: f.launches for k, f in fns.items()}
        got = quant.vit_forward_int8(_to(tree, dev), x.to(dev), cfg)
        torch.cuda.synchronize()
        ran = {k: f.launches - before[k] for k, f in fns.items()}
        assert ran == {"K2": 0, **{k: n * cfg.depth for k, n in counts.items()}}, ran
        tok = embed_tokens(_to(tree, dev), x.to(dev), cfg).cpu()
        # the card's GELU flavour on the CPU too
        ref = quant.vit_blocks_int8(tree, tok, cfg, fused=True, gelu="gelu_poly").float()
        got = got.float().cpu()
        assert torch.isfinite(got).all()
        # int8 flips where a sum in another order crosses a rounding
        # midpoint, carried through two bf16 blocks: the JAX package's limit
        # for int8 rounding flips (tests/test_int8_fused.py:330-334)
        assert torch.isclose(got, ref, rtol=0.02, atol=0.02).float().mean() > 0.99
        torch.testing.assert_close(got, ref, rtol=0.2, atol=0.1)


def test_int8_vit_on_cuda_under_hyt_int8_fused_0(dev, monkeypatch):
    """HYT_INT8_FUSED=0 on the card: the int8 ViT takes the unfused
    composition (no K3, K4 or K5; the attention on K7, JAX's "pallas_direct"
    on a TPU), and agrees with the same composition on the CPU (K7's plain
    version there, by HYT_ATTN=pallas_direct) fed the card's embedded
    tokens, at the fused test's limits."""
    from hamer_yolo_tpu_torch.models.vit import embed_tokens

    monkeypatch.setenv("HYT_INT8_FUSED", "0")
    monkeypatch.delenv("HYT_ATTN", raising=False)
    cfg = ViTConfig(img_size=(256, 192), embed_dim=64, depth=2, num_heads=4)
    params = quant.quantize_vit_params(init_vit(torch.Generator().manual_seed(0), cfg))
    x = torch.from_numpy(np.random.default_rng(0).normal(size=(3, 256, 192, 3)).astype(np.float32))
    fns = {"K2": fused_bf16_attn_block, "K3": fused_int8_attn_proj_block,
           "K4": fused_int8_mlp_block, "K5": fused_int8_matmul, "K7": fused_short_attention}
    before = {k: f.launches for k, f in fns.items()}
    got = quant.vit_forward_int8(_to(params, dev), x.to(dev), cfg)
    torch.cuda.synchronize()
    ran = {k: f.launches - before[k] for k, f in fns.items()}
    assert ran == {"K2": 0, "K3": 0, "K4": 0, "K5": 0, "K7": cfg.depth}, ran
    tok = embed_tokens(_to(params, dev), x.to(dev), cfg).cpu()
    monkeypatch.setenv("HYT_ATTN", "pallas_direct")
    ref = quant.vit_blocks_int8(params, tok, cfg, fused=False).float()
    got = got.float().cpu()
    assert torch.isfinite(got).all()
    close = torch.isclose(got, ref, rtol=0.02, atol=0.02).float().mean()
    assert close > 0.99, close
    torch.testing.assert_close(got, ref, rtol=0.2, atol=0.1)


# ------------------------------------------------- the opt-in kernel paths
# f32 attention against its plain version: both take f32 products and sums
# of 80 and 192 terms in another order; outputs of magnitude <= 1.
F32_ATTN_ATOL = 2e-5


@pytest.mark.parametrize("B,h,N,hd", [(16, 16, 192, 80), (3, 4, 12, 16), (2, 3, 70, 24),
                                      (2, 2, 577, 80), (1, 2, 1024, 128)],
                         ids=["vith", "tiny", "ragged", "n577", "n1024_hd128"])
@pytest.mark.parametrize("int8_out", [False, True], ids=["f32", "out_scale"])
def test_k7_f32_inputs_match_plain(dev, B, h, N, hd, int8_out):
    rng = np.random.default_rng(N + 1)
    qkv = torch.from_numpy(rng.normal(size=(B, N, 3, h, hd)).astype(np.float32)).to(dev)
    q, k, v = (qkv[:, :, i].transpose(1, 2) for i in range(3))
    sx = torch.tensor(0.011, device=dev) if int8_out else None
    before = fused_short_attention.launches
    got = fused_short_attention(q, k, v, out_scale=sx)
    torch.cuda.synchronize()
    assert fused_short_attention.launches == before + 1
    ref = fused_short_attention_ref(q, k, v, out_scale=sx)
    assert got.dtype == ref.dtype and got.shape == ref.shape
    if int8_out:
        check_against_plain(got, ref, "K7 f32")
    else:
        torch.testing.assert_close(got, ref, rtol=0, atol=F32_ATTN_ATOL)


# f32 inputs take the shapes at unit scale: F32_ATTN_ATOL holds for logits of
# unit scale.
K8_CASES = [pytest.param(kind, *shape, id=f"{kind}-{name}")
            for kind in ("bf16", "bf16_int8", "f32", "f32_int8")
            for name, shape in ATTN_SHAPES.items()
            if kind.startswith("bf16") or shape[4] == 1]


@pytest.mark.parametrize("kind,B,h,N,hd,mult", K8_CASES)
def test_k8_matches_plain(dev, kind, B, h, N, hd, mult):
    rng = np.random.default_rng(N + 2)
    qkv = _qkv_heads(rng, B, N, h, hd, mult, dev).reshape(B, N, 3 * h * hd)
    qkv = qkv.to(torch.bfloat16 if kind.startswith("bf16") else torch.float32)
    sx = torch.tensor(0.011, device=dev) if kind.endswith("int8") else None
    before, k7 = fused_qkv_attention.launches, fused_short_attention.launches
    got = fused_qkv_attention(qkv, h, out_scale=sx)
    torch.cuda.synchronize()
    assert fused_qkv_attention.launches == before + 1
    assert fused_short_attention.launches == k7  # K8 counts as K8 only
    ref = fused_qkv_attention_ref(qkv, h, out_scale=sx)
    assert got.dtype == ref.dtype and got.shape == ref.shape == (B, N, h * hd)
    assert got.is_contiguous()
    if sx is not None:
        check_against_plain(got, ref, "K8")
    elif kind == "bf16":  # the limits of K2's attention, whose math this is
        check_against_twin(got, ref)
    else:
        torch.testing.assert_close(got, ref, rtol=0, atol=F32_ATTN_ATOL)
    # the same device code as K7 on views of the same tensor: bit-identical
    x = qkv.reshape(B, N, 3, h, hd)
    k7_out = fused_short_attention(*(x[:, :, i].transpose(1, 2) for i in range(3)), out_scale=sx)
    assert torch.equal(k7_out.transpose(1, 2).reshape(B, N, h * hd), got)


@pytest.mark.parametrize("B,N,K,h", [(16, 192, 1280, 16), (4, 12, 64, 4)], ids=["vith", "tiny"])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "f32"])
def test_k6_matches_plain(dev, B, N, K, h, dtype):
    rng = np.random.default_rng(N + K + 1)
    tok = torch.from_numpy(rng.normal(size=(B, N, K)).astype(np.float32)).to(dev).to(dtype)
    q, s, b = _qlinear(rng, dev, K, 3 * K)
    args = (q, s, b, _vec(rng, dev, K, 1.0), _vec(rng, dev, K), torch.tensor(0.03, device=dev),
            torch.tensor(0.012, device=dev), h)
    before, k3 = fused_int8_attn_block.launches, fused_int8_attn_proj_block.launches
    got = fused_int8_attn_block(tok, *args)
    torch.cuda.synchronize()
    assert fused_int8_attn_block.launches == before + 1
    assert fused_int8_attn_proj_block.launches == k3
    assert got.dtype == torch.int8 and got.shape == (B, N, K)
    steps = attn_block_int8.fused_int8_attn_block_steps(tok, *args)
    assert fused_int8_attn_block.launches == before + 1  # the steps count no launch
    assert torch.equal(steps[1].reshape(B, N, K), got)
    attn_block_int8.check_against_plain(steps, tok, *args)


# ViT-H's rows at B = 4; K = 256 (a cluster of 2), 128 and 64 (one CTA);
# ragged rows (1, 17, 3 x 577) at ViT-H's width; K = 80 and 144, multiples
# of 16 but not of the 160 columns a CTA takes.
K10_CASES = {"vith": (3072, 1280), "k256": (384, 256), "k128_ragged_rows": (40, 128),
             "tiny": (24, 64), "m1": (1, 1280), "m17": (17, 1280), "m1731": (1731, 1280),
             "k80": (40, 80), "k144": (40, 144)}


@pytest.mark.parametrize("M,K", list(K10_CASES.values()), ids=list(K10_CASES))
@pytest.mark.parametrize("gelu", ["gelu", "gelu_poly"])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "f32"])
def test_k10_equals_k4_bit_for_bit(dev, M, K, gelu, dtype):
    rng = np.random.default_rng(M + 1)
    tok = torch.from_numpy(rng.normal(size=(M, 1, K)).astype(np.float32)).to(dev).to(dtype)
    q1, s1, b1 = _qlinear(rng, dev, K, 4 * K)
    q2, s2, b2 = _qlinear(rng, dev, 4 * K, K, scale=0.02)
    args = (q1, s1, b1, q2, s2, b2, _vec(rng, dev, K, 1.0), _vec(rng, dev, K),
            torch.tensor(0.034, device=dev), torch.tensor(0.021, device=dev))
    before, k4 = fused_int8_mlp_block1.launches, fused_int8_mlp_block.launches
    got = fused_int8_mlp_block1(tok, *args, gelu=gelu)
    torch.cuda.synchronize()
    assert fused_int8_mlp_block1.launches == before + 1
    assert fused_int8_mlp_block.launches == k4 and got.dtype == dtype
    assert torch.equal(got, fused_int8_mlp_block(tok, *args, gelu=gelu))
    check_against_plain(got, fused_int8_mlp_block1_ref(tok, *args, gelu=gelu), "K10")


# H not a multiple of the kernel's chunk (64 columns a CTA): one CTA, two,
# three (an odd cluster: its chunk ends inside a 128-byte block) and eight.
@pytest.mark.parametrize("K,H", [(64, 208), (256, 400), (480, 720), (1280, 1296)],
                         ids=["c1", "c2", "c3", "c8"])
@pytest.mark.parametrize("gelu", ["gelu", "gelu_poly"])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "f32"])
def test_k10_ragged_h_chunk(dev, K, H, gelu, dtype):
    assert H % (im.MLP1_FC1_COLS * im.mlp1_cluster(K))
    rng = np.random.default_rng(5)
    tok = torch.from_numpy(rng.normal(size=(3, 70, K)).astype(np.float32)).to(dev).to(dtype)
    q1, s1, b1 = _qlinear(rng, dev, K, H)
    q2, s2, b2 = _qlinear(rng, dev, H, K, scale=0.02)
    args = (q1, s1, b1, q2, s2, b2, _vec(rng, dev, K, 1.0), _vec(rng, dev, K),
            torch.tensor(0.034, device=dev), torch.tensor(0.021, device=dev))
    assert torch.equal(fused_int8_mlp_block1(tok, *args, gelu=gelu),
                       fused_int8_mlp_block(tok, *args, gelu=gelu))


def test_k10_makes_kmajor_copies_once(dev):
    """K10 reads both weights through their K-major copies (those of K4's
    GEMMs): the first call makes them, later calls none."""
    rng = np.random.default_rng(9)
    K, H = 256, 1024
    tok = torch.from_numpy(rng.normal(size=(4, 50, K)).astype(np.float32)).to(dev).bfloat16()
    q1, s1, b1 = _qlinear(rng, dev, K, H)
    q2, s2, b2 = _qlinear(rng, dev, H, K, scale=0.02)
    args = (q1, s1, b1, q2, s2, b2, _vec(rng, dev, K, 1.0), _vec(rng, dev, K),
            torch.tensor(0.034, device=dev), torch.tensor(0.021, device=dev))
    before = im.kmajor_weight.transposes
    first = fused_int8_mlp_block1(tok, *args)
    assert im.kmajor_weight.transposes == before + 2
    again = fused_int8_mlp_block1(tok, *args)
    fused_int8_mlp_block(tok, *args)  # K4's GEMMs take the same copies
    torch.cuda.synchronize()
    assert im.kmajor_weight.transposes == before + 2
    assert torch.equal(first, again)


def _mano_inputs(rng, dev, S, nb=10):
    from hamer_yolo_tpu_torch.core.mano_assets import synthetic_mano_model
    from hamer_yolo_tpu_torch.geometry.rotations import aa_to_rotmat
    from hamer_yolo_tpu_torch.models.mano import ManoModel

    data = synthetic_mano_model(0)
    if nb > data["shapedirs"].shape[-1]:  # a wider shape space than MANO's 10
        data["shapedirs"] = rng.normal(scale=1e-3, size=(778, 3, nb)).astype(np.float32)
    model = ManoModel.from_arrays(data, dev)
    betas = torch.from_numpy(rng.normal(size=(S, nb)).astype(np.float32)).to(dev)
    aa = torch.from_numpy((0.5 * rng.normal(size=(S * 16, 3))).astype(np.float32)).to(dev)
    return model, betas, aa_to_rotmat(aa).reshape(S, 16, 3, 3)


@pytest.mark.parametrize("S,nb", [(16, 10), (1, 10), (5, 4), (64, 10), (16, 64), (1, 64)],
                         ids=["s16", "s1", "nb4", "s64", "s16_nb64", "s1_nb64"])
def test_k9_matches_plain(dev, S, nb):
    from hamer_yolo_tpu_torch.models.mano import lbs

    model, betas, rotmats = _mano_inputs(np.random.default_rng(S), dev, S, nb)
    mano_lbs_fused(model, betas, rotmats)  # makes the model's constants
    made = mano_lbs.fk_constants.made
    before = mano_lbs_fused.launches
    verts, joints = mano_lbs_fused(model, betas, rotmats)
    assert mano_lbs_fused.launches == before + 1
    assert mano_lbs.fk_constants.made == made
    ref_v, ref_j = mano_lbs_fused_ref(model, betas, rotmats)
    assert verts.shape == (S, 778, 3) and joints.shape == (S, 16, 3)
    mano_lbs.check_against_plain(verts, ref_v)
    mano_lbs.check_against_plain(joints, ref_j, "K9's joints")
    lbs_v, lbs_j = lbs(model, betas, rotmats)
    torch.testing.assert_close(verts, lbs_v, rtol=0, atol=1e-5)
    torch.testing.assert_close(joints, lbs_j, rtol=0, atol=1e-5)


# K9's launches by name in a profile, in a process of its own (see _K1_PROFILE)
_K9_PROFILE = """
import numpy as np
import torch
from hamer_yolo_tpu_torch.geometry.rotations import aa_to_rotmat
from hamer_yolo_tpu_torch.core.mano_assets import synthetic_mano_model
from hamer_yolo_tpu_torch.models.mano import ManoModel
from hamer_yolo_tpu_torch.ops.mano_lbs import mano_lbs_fused

dev = torch.device("cuda")
for S, nb in ((16, 10), (1, 10), (5, 4), (64, 10), (16, 64), (1, 64)):
    rng = np.random.default_rng(S)
    data = synthetic_mano_model(0)
    if nb > data["shapedirs"].shape[-1]:  # as _mano_inputs
        data["shapedirs"] = rng.normal(scale=1e-3, size=(778, 3, nb)).astype(np.float32)
    model = ManoModel.from_arrays(data, dev)
    betas = torch.from_numpy(rng.normal(size=(S, nb)).astype(np.float32)).to(dev)
    aa = torch.from_numpy((0.5 * rng.normal(size=(S * 16, 3))).astype(np.float32)).to(dev)
    rotmats = aa_to_rotmat(aa).reshape(S, 16, 3, 3)
    mano_lbs_fused(model, betas, rotmats)
    torch.cuda.synchronize()
    for _ in range(3):  # now and then the profiler records no device activity at all
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
            mano_lbs_fused(model, betas, rotmats)
            torch.cuda.synchronize()
        kernels = [e.name for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
        if kernels:
            break
    assert len(kernels) == 1 and "mano_lbs_kernel" in kernels[0], (S, nb, kernels)
"""


def test_k9_is_one_launch(dev):
    """K9 is one device kernel a call at test_k9_matches_plain's shapes, by
    name in a profile (in a process of its own: on the card a profiler
    session after enough other work in a process can record no device
    activity, which failed test_k9_matches_plain's in-process check once)."""
    import os
    import subprocess
    import sys

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, PYTHONPATH=repo + os.pathsep + os.environ.get("PYTHONPATH", ""))
    res = subprocess.run([sys.executable, "-c", _K9_PROFILE], cwd=repo, env=env,
                         capture_output=True, text=True, timeout=600)
    assert res.returncode == 0, res.stdout[-2000:] + res.stderr[-3000:]


def test_optin_kernels_reject_what_they_do_not_take(dev):
    model, betas, rotmats = _mano_inputs(np.random.default_rng(0), dev, 2)
    with pytest.raises(ValueError, match="f32 betas and rotmats"):
        mano_lbs_fused(model, betas.double(), rotmats)
    with pytest.raises(ValueError, match="rotmats on cpu"):
        mano_lbs_fused(model, betas, rotmats.cpu())
    qkv = torch.zeros((2, 12, 3 * 4 * 16), dtype=torch.bfloat16, device=dev)
    with pytest.raises(ValueError, match="one float dtype, bf16 or f32"):
        fused_qkv_attention(qkv.half(), 4)
    with pytest.raises(ValueError, match="multiple of 8"):
        fused_qkv_attention(qkv[:, :, :3 * 4 * 12], 4)
    rng = np.random.default_rng(1)
    tok = torch.zeros((2, 12, 64), device=dev)
    q1, s1, b1 = _qlinear(rng, dev, 64, 256)
    q2, s2, b2 = _qlinear(rng, dev, 256, 64)
    vec, sx = torch.ones(64, device=dev), torch.tensor(0.03, device=dev)
    with pytest.raises(ValueError, match="bf16 or f32 tokens"):
        fused_int8_mlp_block1(tok.half(), q1, s1, b1, q2, s2, b2, vec, vec, sx, sx)
    with pytest.raises(ValueError, match="int8 .K, H. and .H, K. on"):
        fused_int8_mlp_block1(tok, q1, s1, b1, q2.cpu(), s2, b2, vec, vec, sx, sx)
    with pytest.raises(ValueError, match="static scale is on cpu"):
        fused_int8_mlp_block1(tok, q1, s1, b1, q2, s2, b2, vec, vec, sx.cpu(), sx)
    q, s, b = _qlinear(rng, dev, 64, 192)
    with pytest.raises(ValueError, match="static scale is on cpu"):
        fused_int8_attn_block(tok, q, s, b, vec, vec, sx, sx.cpu(), 4)
    with pytest.raises(ValueError, match="unsupported shapes"):
        fused_int8_attn_block(tok, q[:, :160], s[:160], b[:160], vec, vec, sx, sx, 4)


def test_int8_dynamic_vit_on_f32_tokens(dev):
    """The int8 ViT without static scales on f32 tokens: K5 and K7 on f32
    rows, against the plain versions on the CPU fed the same tokens."""
    cfg = ViTConfig(img_size=(64, 48), embed_dim=64, depth=2, num_heads=4,
                    compute_dtype="float32")
    params = quant.quantize_vit_params(init_vit(torch.Generator().manual_seed(0), cfg))
    tok = torch.from_numpy(np.random.default_rng(0).normal(size=(3, 12, 64)).astype(np.float32))
    before = fused_short_attention.launches
    got = quant.vit_blocks_int8(_to(params, dev), tok.to(dev), cfg)
    torch.cuda.synchronize()
    assert fused_short_attention.launches == before + cfg.depth
    assert got.dtype == torch.float32 and torch.isfinite(got).all()
    ref = quant.vit_blocks_int8(params, tok, cfg, fused=True, gelu="gelu_poly")
    assert torch.isclose(got.cpu(), ref, rtol=0.02, atol=0.02).float().mean() > 0.99
    torch.testing.assert_close(got.cpu(), ref, rtol=0.2, atol=0.1)


@pytest.mark.parametrize("scales", ["static", "dynamic"])
def test_optin_switches_on_cuda(dev, scales, monkeypatch):
    """HYT_ATTN / HYT_INT8_MLP on the card: static scales with megakernel +
    megakernel1 run K6 and K10 once per block (no K3, K4); without scales
    pallas_fusedqkv runs K8 once and K5 four times per block (no K7)."""
    cfg = ViTConfig(img_size=(64, 48), embed_dim=64, depth=2, num_heads=4)
    params = quant.quantize_vit_params(init_vit(torch.Generator().manual_seed(0), cfg))
    x = torch.from_numpy(np.random.default_rng(0).normal(size=(3, 64, 48, 3)).astype(np.float32))
    if scales == "static":
        stats = quant.collect_vit_act_stats(params, x, cfg)
        params = quant.attach_static_act_scales(params, stats)
        monkeypatch.setenv("HYT_ATTN", "megakernel")
        monkeypatch.setenv("HYT_INT8_MLP", "megakernel1")
        want = {"K3": 0, "K4": 0, "K5": 0, "K6": 1, "K7": 0, "K8": 0, "K10": 1}
    else:
        monkeypatch.setenv("HYT_ATTN", "pallas_fusedqkv")
        want = {"K3": 0, "K4": 0, "K5": 4, "K6": 0, "K7": 0, "K8": 1, "K10": 0}
    fns = {"K3": fused_int8_attn_proj_block, "K4": fused_int8_mlp_block, "K5": fused_int8_matmul,
           "K6": fused_int8_attn_block, "K7": fused_short_attention, "K8": fused_qkv_attention,
           "K10": fused_int8_mlp_block1}
    before = {k: f.launches for k, f in fns.items()}
    got = quant.vit_forward_int8(_to(params, dev), x.to(dev), cfg)
    torch.cuda.synchronize()
    assert {k: f.launches - before[k] for k, f in fns.items()} == {
        k: n * cfg.depth for k, n in want.items()}
    monkeypatch.delenv("HYT_ATTN")
    monkeypatch.delenv("HYT_INT8_MLP", raising=False)
    ref = quant.vit_forward_int8(_to(params, dev), x.to(dev), cfg)  # the default kernels
    assert torch.isclose(got.float(), ref.float(), rtol=0.02, atol=0.02).float().mean() > 0.99
    torch.testing.assert_close(got.float(), ref.float(), rtol=0.2, atol=0.1)


def test_hamer_forward_fused_mano_on_cuda(dev):
    import dataclasses as dc

    from hamer_yolo_tpu_torch.cli.main import pipeline_config
    from hamer_yolo_tpu_torch.core.mano_assets import synthetic_mano_model
    from hamer_yolo_tpu_torch.models.hamer import hamer_forward, init_hamer
    from hamer_yolo_tpu_torch.models.mano import ManoModel

    cfg = pipeline_config(tiny=True).hamer
    params = _to(init_hamer(torch.Generator().manual_seed(0), cfg), dev)
    mano = ManoModel.from_arrays(synthetic_mano_model(0), dev)
    img = torch.from_numpy(np.random.default_rng(0).normal(size=(3, 64, 64, 3))
                           .astype(np.float32)).to(dev)
    before = mano_lbs_fused.launches
    ref = hamer_forward(params, mano, img, cfg)
    assert mano_lbs_fused.launches == before  # off by default
    got = hamer_forward(params, mano, img, dc.replace(cfg, fused_mano=True))
    torch.cuda.synchronize()
    assert mano_lbs_fused.launches == before + 1
    for k in ("pred_vertices", "pred_keypoints_3d"):
        torch.testing.assert_close(got[k], ref[k], rtol=0, atol=1e-5)


# ------------------------------------- ToMe's token counts, RootNet, serving
@pytest.mark.parametrize("N", [124, 68])
def test_int8_kernels_at_tome_token_counts(dev, N):
    """K3, K4, K5 and K7 at ToMe's token counts on ViT-H's widths: 16 crops
    of N tokens, M = 16 N rows (not multiples of 128; K7's query tiles
    partly empty), each against its plain version at its limits."""
    rng = np.random.default_rng(N)
    B, K, h = 16, 1280, 16
    tok = torch.from_numpy(rng.normal(size=(B, N, K)).astype(np.float32)).to(dev).bfloat16()
    q, s, b = _qlinear(rng, dev, K, 3 * K)
    pq, ps, pb = _qlinear(rng, dev, K, K)
    sq, sp = torch.tensor(0.03, device=dev), torch.tensor(0.012, device=dev)
    args = (q, s, b, _vec(rng, dev, K, 1.0), _vec(rng, dev, K), sq, sp, pq, ps, pb, h)
    steps = attn_proj_block.fused_int8_attn_proj_block_steps(tok, *args)
    torch.cuda.synchronize()
    attn_proj_block.check_against_plain(steps, tok, *args)
    w1, s1, b1 = _qlinear(rng, dev, K, 4 * K)
    w2, s2, b2 = _qlinear(rng, dev, 4 * K, K, scale=0.02)
    margs = (w1, s1, b1, w2, s2, b2, _vec(rng, dev, K, 1.0), _vec(rng, dev, K),
             torch.tensor(0.03, device=dev), torch.tensor(0.02, device=dev))
    got = fused_int8_mlp_block(tok, *margs, gelu="gelu_poly")
    torch.cuda.synchronize()
    check_against_plain(got, fused_int8_mlp_block_ref(tok, *margs, gelu="gelu_poly"), "K4")
    x = tok.reshape(B * N, K)
    for static in (None, sq):
        got = fused_int8_matmul(x, q, s, b, args[3], args[4], prologue="ln", static_scale=static)
        torch.cuda.synchronize()
        check_against_plain(got, fused_int8_matmul_ref(x, q, s, b, args[3], args[4],
                                                       prologue="ln", static_scale=static), "K5")
    qkv = torch.from_numpy(rng.normal(size=(B, N, 3, h, K // h)).astype(np.float32)).to(
        dev).bfloat16()
    qh, kh, vh = (qkv[:, :, i].transpose(1, 2) for i in range(3))
    for sx in (None, sp):
        got = fused_short_attention(qh, kh, vh, out_scale=sx)
        torch.cuda.synchronize()
        ref = fused_short_attention_ref(qh, kh, vh, out_scale=sx)
        if sx is None:
            check_against_twin(got, ref)
        else:
            check_against_plain(got, ref, "K7")


@pytest.mark.parametrize("scales", ["static", "dynamic"])
def test_int8_tome_vit_on_cuda_runs_the_kernels(dev, scales):
    """int8 + ToMe on the card: the kernels of the int8 path once per block
    (K3 + K4 with scales, K5 x 4 + K7 without) at the merged token counts
    192, 188, 184, no K2; without merges (r = 0) the same launches give
    vit_forward_int8's tokens bit for bit. The merged forward against the
    CPU's: the next test."""
    from hamer_yolo_tpu_torch.models.tome import vit_forward_tome

    cfg = ViTConfig(embed_dim=64, depth=3, num_heads=4)
    params = quant.quantize_vit_params(init_vit(torch.Generator().manual_seed(0), cfg))
    x = torch.from_numpy(np.random.default_rng(0).normal(size=(3, 256, 192, 3))
                         .astype(np.float32))
    if scales == "static":
        stats = quant.collect_vit_act_stats(params, x, cfg)
        params = quant.attach_static_act_scales(params, stats)
    params, x = _to(params, dev), x.to(dev)
    fns = {"K2": fused_bf16_attn_block, "K3": fused_int8_attn_proj_block,
           "K4": fused_int8_mlp_block, "K5": fused_int8_matmul, "K7": fused_short_attention}
    counts = {"K3": 1, "K4": 1} if scales == "static" else {"K5": 4, "K7": 1}
    for r in (4, 0):
        before = {k: f.launches for k, f in fns.items()}
        got = vit_forward_tome(params, x, cfg, r_per_layer=r)
        torch.cuda.synchronize()
        ran = {k: f.launches - before[k] for k, f in fns.items()}
        assert ran == {**dict.fromkeys(fns, 0), **{k: n * cfg.depth for k, n in counts.items()}}
        assert got.shape == (3, 192 - r * cfg.depth, 64) and torch.isfinite(got).all()
    assert torch.equal(got, quant.vit_forward_int8(params, x, cfg))


def _merge_fates(match, n_tokens):
    """A merge choice as (B, Na): the B token each A token merges into, -1
    where it is kept."""
    merged_a, _, tgt = match
    fates = torch.full((merged_a.shape[0], (n_tokens + 1) // 2), -1, dtype=torch.long)
    return fates.scatter_(1, merged_a.cpu(), tgt.cpu())


@pytest.mark.parametrize("scales", ["static", "dynamic"])
def test_int8_tome_vit_on_cuda_matches_cpu_on_the_same_merges(dev, scales, monkeypatch):
    """The merged int8 forward on the card (K3 + K4, or K5 + K7) against
    the kernels' plain versions on the CPU, from the card's embedded tokens,
    the card's polynomial GELU on both, and each layer's merge choice taken
    from the card's run. A merge is an argmax over similarities: where an
    int8 flip moves a token, the other device could merge it elsewhere and
    the two forwards would compute different things; the choices the CPU
    would have made are counted and printed. The JAX package's limit for
    int8 rounding flips (tests/test_int8_fused.py:330-334), as the unmerged
    ViT's card test. Printed too, unchecked: the CPU's default forwards from
    the image, with and without merges, against the card's (they part from
    it without merges as well: another patch embedding, the unfused
    composition and the exact GELU)."""
    from hamer_yolo_tpu_torch.models import tome
    from hamer_yolo_tpu_torch.models.vit import embed_tokens

    cfg = ViTConfig(embed_dim=64, depth=3, num_heads=4)
    params = quant.quantize_vit_params(init_vit(torch.Generator().manual_seed(0), cfg))
    x = torch.from_numpy(np.random.default_rng(0).normal(size=(3, 256, 192, 3))
                         .astype(np.float32))
    if scales == "static":
        stats = quant.collect_vit_act_stats(params, x, cfg)
        params = quant.attach_static_act_scales(params, stats)
    tok = embed_tokens(_to(params, dev), x.to(dev), cfg)
    match, card, differ = tome.bipartite_matching, [], []

    def record(t, r):
        card.append(match(t, r))
        return card[-1]

    def replay(t, r):
        want = card[len(differ)]
        differ.append(int((_merge_fates(match(t, r), t.shape[1])
                           != _merge_fates(want, t.shape[1])).sum()))
        return tuple(m.cpu() for m in want)

    monkeypatch.setattr(tome, "bipartite_matching", record)
    got = tome.vit_blocks_tome(_to(params, dev), tok, cfg, 4).float().cpu()
    monkeypatch.setattr(tome, "bipartite_matching", replay)
    ref = tome.vit_blocks_tome(params, tok.cpu(), cfg, 4, fused=True, gelu="gelu_poly").float()
    assert len(card) == len(differ) == cfg.depth and got.shape == ref.shape == (3, 180, 64)
    frac = torch.isclose(got, ref, rtol=0.02, atol=0.02).float().mean()
    monkeypatch.setattr(tome, "bipartite_matching", match)
    own = tome.vit_blocks_tome(params, tok.cpu(), cfg, 4, fused=True, gelu="gelu_poly").float()

    def share(a, b):
        close = torch.isclose(a.float().cpu(), b.float(), rtol=0.02, atol=0.02)
        return f"{float(close.float().mean()):.4f}"

    # unchecked: the CPU's default forwards from the image (its own patch
    # embedding, the unfused composition, the exact GELU), with and without
    # merges, against the card's
    plain = {r: tome.vit_forward_tome(params, x, cfg, r) for r in (4, 0)}
    card0 = tome.vit_forward_tome(_to(params, dev), x.to(dev), cfg, 0)
    print(f"int8-tome {scales}: {float(frac):.4f} within 0.02 on the card's merges, "
          f"{share(got, own)} on the CPU's own; A tokens the CPU would merge otherwise, by "
          f"layer: {differ}; the CPU's default forward from the image {share(got, plain[4])}, "
          f"without merges {share(card0, plain[0])}")
    assert frac > 0.99, f"{frac} within 0.02; merges the CPU would change, by layer: {differ}"
    torch.testing.assert_close(got, ref, rtol=0.2, atol=0.1)


def test_tome_merge_on_cuda_matches_cpu(dev):
    """The merge at ViT-H's shape (16 crops of 192 tokens of 1280, bf16)
    on the card: the CPU's merges and sizes, and its tokens bit for bit."""
    from hamer_yolo_tpu_torch.models.tome import bipartite_soft_matching_merge

    rng = np.random.default_rng(2)
    tok = torch.from_numpy(rng.normal(size=(16, 192, 1280)).astype(np.float32)).bfloat16()
    sizes = torch.from_numpy(rng.integers(1, 4, (16, 192)).astype(np.float32)).bfloat16()
    ref_t, ref_s = bipartite_soft_matching_merge(tok, sizes, 4)
    got_t, got_s = bipartite_soft_matching_merge(tok.to(dev), sizes.to(dev), 4)
    assert torch.equal(got_s.cpu(), ref_s) and torch.equal(got_t.cpu(), ref_t)


def test_rootnet_on_cuda_matches_cpu(dev):
    """RootNet's trunk and depth on the card: f32 at the JAX package's
    composed-oracle limit (2e-3, relative for depths of random-weight size);
    bf16 (cuDNN's sum order) as accurate as the CPU's bf16 against the f32
    trunk within a factor 2, as tests/test_torch_sar.py holds the port
    against JAX."""
    from hamer_yolo_tpu_torch.models.sar import SarConfig, estimate_root_depth, init_sar
    from hamer_yolo_tpu_torch.models.mano import ManoModel
    from hamer_yolo_tpu_torch.core.mano_assets import synthetic_mano_model

    mano = ManoModel.from_arrays(synthetic_mano_model(0))
    params = init_sar(torch.Generator().manual_seed(0), mano.v_template,
                      SarConfig(input_size=64, feature_hw=2, heatmap_size=8))
    rng = np.random.default_rng(1)
    x = torch.from_numpy(rng.normal(size=(16, 64, 64, 3)).astype(np.float32))
    k = torch.from_numpy(rng.uniform(0.5, 2.0, 16).astype(np.float32))
    out = {}
    for dt in ("float32", "bfloat16"):
        cfg = SarConfig(input_size=64, feature_hw=2, heatmap_size=8, compute_dtype=dt)
        out[dt] = (estimate_root_depth(params, x, k, cfg).double(),
                   estimate_root_depth(_to(params, dev), x.to(dev), k.to(dev), cfg)
                   .double().cpu())
    cpu32, card32 = out["float32"]
    torch.testing.assert_close(card32, cpu32, rtol=2e-3, atol=2e-3)
    cpu16, card16 = out["bfloat16"]
    assert torch.isfinite(card16).all()
    assert (card16 - cpu32).abs().max() <= 2.0 * (cpu16 - cpu32).abs().max()


def test_batched_pipeline_on_cuda(dev):
    """BatchedPipeline on the card at the --tiny config with RootNet: the
    hands and slots of the one-frame program on each frame; F2's checks."""
    from hamer_yolo_tpu_torch.cli.main import pipeline_config
    from hamer_yolo_tpu_torch.core.checkpoint import init_pipeline_params
    from hamer_yolo_tpu_torch.core.mano_assets import synthetic_mano_model
    from hamer_yolo_tpu_torch.models.mano import ManoModel
    from hamer_yolo_tpu_torch.pipeline.runner import FrameProgram
    from hamer_yolo_tpu_torch.pipeline.serving import BatchedPipeline

    cfg = pipeline_config(tiny=True)
    mano = ManoModel.from_arrays(synthetic_mano_model(0), dev)
    params = init_pipeline_params(0, mano, cfg.yolo, cfg.hamer, cfg.sar, device=dev)
    rng = np.random.default_rng(0)
    frames = [rng.integers(0, 256, (120, 160, 3), dtype=np.uint8) for _ in range(3)]
    K = np.float32([[200.0, 0, 80], [0, 200.0, 60], [0, 0, 1]])
    pipe = BatchedPipeline(params, mano, cfg, batch_size=4, device=dev)
    out = pipe.process_batch(frames, K)
    assert out["root_depth"].shape == (3, cfg.max_hands)
    program = FrameProgram(params, mano, cfg, dev)
    for i, f in enumerate(frames):
        one = program(f, K)
        assert (one["valid"] == out["valid"][i]).all()
        for k, v in one.items():
            assert np.isfinite(out[k][i]).all() if v.dtype != bool else True
    with pytest.raises(ValueError, match="5 frames for a batch of 4"):
        pipe.process_batch(frames + frames[:2], K)
    with pytest.raises(ValueError, match="outside 0..255"):
        pipe.process_batch([frames[0].astype(np.float32) - 1.0], K)


def _tiny_runtime(dev, fast_path="none", int8_yolo="off"):
    from hamer_yolo_tpu_torch.cli.main import apply_fast_path, apply_int8_yolo, pipeline_config
    from hamer_yolo_tpu_torch.core.checkpoint import init_pipeline_params
    from hamer_yolo_tpu_torch.core.mano_assets import synthetic_mano_model
    from hamer_yolo_tpu_torch.models.mano import ManoModel

    cfg = pipeline_config(tiny=True)
    mano = ManoModel.from_arrays(synthetic_mano_model(0), dev)
    params = init_pipeline_params(0, mano, cfg.yolo, cfg.hamer, cfg.sar, device=dev)
    params, cfg = apply_fast_path(params, cfg, fast_path)
    return apply_int8_yolo(params, cfg, int8_yolo), mano, cfg


def _eager(pipe, frames, K, state=None):
    """BatchedPipeline's outputs without its graphs, on the same padded batch."""
    from hamer_yolo_tpu_torch.pipeline.frame import infer_frames, infer_frames_tracked

    images, hws, Ks = pipe._pad_frames(frames, K)
    t = (lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(pipe.device))  # noqa: E731
    with torch.inference_mode():
        if state is None:
            out = infer_frames(pipe.params, pipe.mano_model, t(images).float(), t(hws), t(Ks),
                               pipe.cfg)
        else:  # the previous tick's rows, zero rows for the pad frames (as _dispatch_tracked)
            pad = {k: np.zeros((pipe.batch_size,) + state[k].shape[1:], state[k].dtype)
                   for k in ("keypoints_2d", "is_right", "valid")}
            for k, v in pad.items():
                v[:len(frames)] = state[k][:len(frames)]
            out = infer_frames_tracked(pipe.params, pipe.mano_model, t(images).float(),
                                       t(pad["keypoints_2d"]), t(pad["is_right"]),
                                       t(pad["valid"]), t(hws), t(Ks), pipe.cfg)
    return {k: v[:len(frames)].cpu().numpy() for k, v in out.items()}


def _assert_same(got, ref):
    assert set(got) == set(ref)
    for k in ref:
        np.testing.assert_array_equal(got[k], ref[k], err_msg=k)


@pytest.mark.parametrize("fast_path", ["none", "int8", "int8-yolo-all"])
def test_captured_programs_match_eager(dev, fast_path):
    """Every captured program against the same function run eagerly on the
    same inputs, bit for bit, at the --tiny config: BatchedPipeline's detect
    and tracked programs, FrameProgram and MaskedProgram; a second call of
    a bucket is a replay (no launch counted). "int8-yolo-all": the bf16 ViT
    behind the W8A8 detector (--int8-yolo all)."""
    from hamer_yolo_tpu_torch.ops.attn_block import fused_bf16_attn_block
    from hamer_yolo_tpu_torch.pipeline.frame import infer_frame, infer_frame_with_boxes
    from hamer_yolo_tpu_torch.pipeline.runner import FrameProgram, MaskedProgram, _bucket_pad
    from hamer_yolo_tpu_torch.pipeline.serving import BatchedPipeline

    params, mano, cfg = (_tiny_runtime(dev, "none", "all") if fast_path == "int8-yolo-all"
                         else _tiny_runtime(dev, fast_path))
    rng = np.random.default_rng(7)
    frames = [rng.integers(0, 256, (120, 160, 3), dtype=np.uint8) for _ in range(3)]
    K = np.float32([[200.0, 0, 80], [0, 200.0, 60], [0, 0, 1]])
    pipe = BatchedPipeline(params, mano, cfg, batch_size=4, device=dev)
    got = pipe.process_batch(frames, K)
    _assert_same(got, _eager(pipe, frames, K))
    before = (greedy_nms_keep.launches, fused_bf16_attn_block.launches, fused_int8_matmul.launches)
    _assert_same(pipe.process_batch(frames, K), got)
    assert (greedy_nms_keep.launches, fused_bf16_attn_block.launches,
            fused_int8_matmul.launches) == before
    tracked = pipe._fetch(*pipe._dispatch_tracked(
        frames, [{"kp2d": got["keypoints_2d"][i], "is_right": got["is_right"][i],
                  "valid": got["valid"][i]} for i in range(3)], K))
    _assert_same(tracked, _eager(pipe, frames, K, got))
    program = FrameProgram(params, mano, cfg, dev)
    padded, hw = _bucket_pad(frames[0])
    img = torch.from_numpy(padded).to(dev).float()
    t = (lambda a: torch.from_numpy(np.asarray(a, np.float32)).to(dev))  # noqa: E731
    with torch.inference_mode():
        ref = {k: v.cpu().numpy() for k, v in infer_frame(
            params, mano, img, t(hw), t(K), cfg).items()}
    _assert_same(program(frames[0], K), ref)
    masked = MaskedProgram(params, mano, cfg, dev)
    S = cfg.max_hands
    boxes = np.zeros((S, 4), np.float32)
    boxes[0] = [30, 20, 90, 100]
    valid = (np.arange(S) == 0).astype(np.float32)
    with torch.inference_mode():
        ref = {k: v.cpu().numpy() for k, v in infer_frame_with_boxes(
            params, mano, img, t(boxes), t(np.ones(S)), t(valid), t(hw), t(K), cfg).items()}
    _assert_same(masked(frames[0], boxes, np.ones(S, np.float32), valid, K), ref)


def test_capture_after_a_larger_batch_keeps_the_earlier_graph(dev):
    """A graph captured at batch 2, then another at batch 8 (K1's launch
    grows what it sizes by B), then the batch-2 graph replayed: still equal
    to eager, as is the batch-8 one."""
    from hamer_yolo_tpu_torch.pipeline.serving import BatchedPipeline

    params, mano, cfg = _tiny_runtime(dev)
    rng = np.random.default_rng(8)
    frames = [rng.integers(0, 256, (120, 160, 3), dtype=np.uint8) for _ in range(8)]
    K = np.float32([[200.0, 0, 80], [0, 200.0, 60], [0, 0, 1]])
    small = BatchedPipeline(params, mano, cfg, batch_size=2, device=dev)
    first = small.process_batch(frames[:2], K)
    large = BatchedPipeline(params, mano, cfg, batch_size=8, device=dev)
    _assert_same(large.process_batch(frames, K), _eager(large, frames, K))
    _assert_same(small.process_batch(frames[:2], K), first)
    _assert_same(small.process_batch(frames[2:4], K), _eager(small, frames[2:4], K))


def test_two_batches_in_flight_keep_their_outputs(dev):
    """stream's depth 2: batch B is uploaded and replayed on the same graph
    before batch A is fetched; each gets its own outputs (cloned before the
    next replay, staged in a slot of its own)."""
    from hamer_yolo_tpu_torch.pipeline.serving import BatchedPipeline

    params, mano, cfg = _tiny_runtime(dev)
    rng = np.random.default_rng(9)
    frames = [rng.integers(0, 256, (120, 160, 3), dtype=np.uint8) for _ in range(6)]
    K = np.float32([[200.0, 0, 80], [0, 200.0, 60], [0, 0, 1]])
    pipe = BatchedPipeline(params, mano, cfg, batch_size=2, device=dev)
    pipe.process_batch(frames[:2], K)  # capture
    pending = [pipe._dispatch(frames[i:i + 2], K) for i in (0, 2, 4)]
    for i, (out, n) in zip((0, 2, 4), pending):
        _assert_same(pipe._fetch(out, n), _eager(pipe, frames[i:i + 2], K))
    outs = list(pipe.stream(iter(frames), K, depth=3))
    for i, o in zip((0, 2, 4), outs):
        _assert_same(o, _eager(pipe, frames[i:i + 2], K))


# ------------------------------------------- int8 detector, ConvNeXt SAR, overlays
def test_int8_conv_routes_on_cuda_match_cpu(dev):
    """Each int8 conv route on the card (torch._int_mm with K, N and the
    rows padded) against the CPU, bit for bit: int32 sums are exact and the
    quantize and dequantize are the same elementwise ops."""
    from hamer_yolo_tpu_torch.core.quant import quantize_conv_weight

    rng = np.random.default_rng(0)
    for k, cin, cout, stride, pad, groups, static in (
            (1, 16, 24, 1, 0, 1, True), (1, 16, 24, 2, 0, 1, False), (1, 3, 5, 1, 0, 1, False),
            (3, 3, 32, 2, 1, 1, True), (3, 16, 24, 1, "SAME", 1, True),
            (3, 16, 24, 2, ((1, 2), (0, 1)), 1, True), (3, 16, 24, 1, 1, 4, True),
            (5, 16, 16, 2, 2, 16, False), (3, 16, 24, 1, 1, 1, False)):
        w = torch.from_numpy(rng.uniform(-0.3, 0.3, (cout, cin // groups, k, k)).astype(np.float32))
        x = torch.from_numpy((2 * rng.normal(size=(2, 11, 13, cin))).astype(np.float32))
        p = {"w": quantize_conv_weight(w), "b": torch.from_numpy(
            (0.1 * rng.normal(size=cout)).astype(np.float32))}
        if static:
            p["sx"] = torch.tensor(float(x.abs().max()) * 0.9 / 127)
        ref = nn.conv2d(p, x.bfloat16(), stride, pad, groups)
        got = nn.conv2d(_to(p, dev), x.bfloat16().to(dev), stride, pad, groups)
        assert torch.equal(got.cpu(), ref), (k, cin, cout, stride, pad, groups, static)


def test_int8_detector_on_cuda_matches_cpu(dev):
    """The --tiny detector quantized ("1x1" and "all") and calibrated on the
    card: the scales within 3% of the CPU's (a flipped int8 step upstream
    moves an absmax; tests/test_torch_int8_yolo.py's CALIB_REL), and the
    decoded output as accurate as the CPU's against the CPU's f32 float
    detector within a factor 2."""
    from hamer_yolo_tpu_torch.cli.main import pipeline_config
    from hamer_yolo_tpu_torch.models.yolov7.model import init_yolov7, yolov7_forward

    cfg = pipeline_config(tiny=True).yolo
    params = init_yolov7(torch.Generator().manual_seed(0), cfg)
    rng = np.random.default_rng(1)
    frames = list(rng.random((2, 64, 64, 3)).astype(np.float32))
    x = torch.from_numpy(rng.random((4, 64, 64, 3)).astype(np.float32))
    ref32 = yolov7_forward(params, x, dataclasses.replace(cfg, compute_dtype="float32"))
    for mode in ("1x1", "all"):
        q = quant.quantize_yolo_params(params, only_1x1=mode == "1x1")
        cpu = quant.calibrate_yolo_act_scales(q, frames, cfg)
        card = quant.calibrate_yolo_act_scales(_to(q, dev), frames, cfg)
        sx_cpu = torch.stack([t for t in _leaves(cpu, "sx")])
        sx_card = torch.stack([t.cpu() for t in _leaves(card, "sx")])
        torch.testing.assert_close(sx_card, sx_cpu, rtol=0.03, atol=0)
        got = yolov7_forward(_to(cpu, dev), x.to(dev), cfg).cpu()
        ref = yolov7_forward(cpu, x, cfg)
        assert torch.isfinite(got).all()
        assert (got - ref32).abs().max() <= 2.0 * (ref - ref32).abs().max(), mode


def _leaves(tree, key):
    if isinstance(tree, dict):
        for k, v in tree.items():
            if k == key:
                yield v
            else:
                yield from _leaves(v, key)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _leaves(v, key)


def test_convnext_sar_on_cuda_matches_cpu(dev):
    """SAR with ConvNeXt-base at 64 (gamma redrawn to O(1)) and the full mesh
    on the card: f32 uvd at the SAR limit (atol 1e-2, rtol 1e-3), root depth
    and xyz at 2e-3; bf16 within a factor 2 of the CPU's bf16 against f32."""
    from hamer_yolo_tpu_torch.core.mano_assets import synthetic_mano_model
    from hamer_yolo_tpu_torch.models.mano import ManoModel
    from hamer_yolo_tpu_torch.models.sar import SarConfig, init_sar, sar_forward
    from hamer_yolo_tpu_torch.pipeline.sar_mesh import sar_full_mesh

    mano = ManoModel.from_arrays(synthetic_mano_model(0))
    gen = torch.Generator().manual_seed(0)
    params = init_sar(gen, mano.v_template, SarConfig(backbone="convnext", input_size=64,
                                                     feature_hw=2, heatmap_size=8))
    for blocks in params["backbone"]["stages"]:
        for blk in blocks:
            blk["gamma"] = torch.rand(blk["gamma"].shape, generator=gen) * 0.5 + 0.5
    rng = np.random.default_rng(2)
    x = torch.from_numpy(rng.normal(size=(4, 64, 64, 3)).astype(np.float32))
    out = {}
    for dt in ("float32", "bfloat16"):
        cfg = SarConfig(backbone="convnext", input_size=64, feature_hw=2, heatmap_size=8,
                        compute_dtype=dt)
        out[dt] = (sar_forward(params, x, cfg).double(),
                   sar_forward(_to(params, dev), x.to(dev), cfg).double().cpu())
    torch.testing.assert_close(out["float32"][1], out["float32"][0], rtol=1e-3, atol=1e-2)
    cpu16, card16 = out["bfloat16"]
    assert (card16 - out["float32"][0]).abs().max() <= 2.0 * (cpu16 - out["float32"][0]).abs().max()
    cfg = SarConfig(backbone="convnext", input_size=64, feature_hw=2, heatmap_size=8,
                    compute_dtype="float32")
    img = torch.from_numpy(rng.uniform(0, 255, (90, 120, 3)).astype(np.float32))
    boxes = torch.tensor([[10, 20, 60, 70], [50, 5, 110, 80], [0, 0, 30, 30], [40, 40, 100, 88.]])
    hw, flip = torch.tensor([90.0, 120.0]), torch.tensor([0.0, 1.0, 0.0, 1.0])
    K = torch.tensor([[300.0, 0, 60], [0, 310.0, 45], [0, 0, 1]])
    depth = torch.from_numpy(rng.uniform(0.3, 1.5, (90, 120)).astype(np.float32))
    for dimg in (None, depth):
        extra = () if dimg is None else (dimg,)
        ref = sar_full_mesh(params, img, boxes, hw, K, cfg, flip, *extra)
        got = sar_full_mesh(_to(params, dev), img.to(dev), boxes.to(dev), hw.to(dev), K.to(dev),
                            cfg, flip.to(dev), *(t.to(dev) for t in extra))
        for k in ref:
            tol = dict(rtol=1e-3, atol=1e-2) if "uvd" in k else dict(rtol=0, atol=2e-3)
            torch.testing.assert_close(got[k].cpu(), ref[k], **tol, msg=k)


def test_rasterize_on_cuda_matches_cpu(dev):
    """The lit rasterizer on the card: the same face a supersample (alpha
    equal), colours to f64 rounding, the uint8 overlay equal."""
    from hamer_yolo_tpu_torch.core.mano_assets import synthetic_mano_model
    from hamer_yolo_tpu_torch.models.mano import ManoModel
    from hamer_yolo_tpu_torch.pipeline.reconstruct import reconstruct_hand_mesh
    from hamer_yolo_tpu_torch.utils.render import lit_mesh_overlay, rasterize_mesh

    mano = ManoModel.from_arrays(synthetic_mano_model(0))
    rng = np.random.default_rng(3)
    hand = {"theta": (0.3 * rng.normal(size=48)).astype(np.float32),
            "betas": (0.5 * rng.normal(size=10)).astype(np.float32), "is_right": 1.0,
            "cam_t": np.array([0.02, 0.0, 0.6], np.float32)}
    m = reconstruct_hand_mesh(mano, hand)
    K = np.array([[600.0, 0, 160], [0, 600.0, 120], [0, 0, 1]], np.float32)
    img = rng.integers(0, 255, (240, 320, 3)).astype(np.uint8)
    rgb, alpha = rasterize_mesh(m["vertices"], m["faces"], K, (240, 320))
    rgb_d, alpha_d = rasterize_mesh(m["vertices"], m["faces"], K, (240, 320), device=dev)
    assert (alpha > 0).sum() > 1000 and torch.equal(alpha_d.cpu(), alpha)
    torch.testing.assert_close(rgb_d.cpu(), rgb, rtol=0, atol=1e-12)
    np.testing.assert_array_equal(lit_mesh_overlay(img, m["vertices"], m["faces"], K, device=dev),
                                  lit_mesh_overlay(img, m["vertices"], m["faces"], K))


# On the card (PyTorch 2.11) a profiler session followed by enough other
# work in the same process leaves the next sessions recording no device
# activity at all (back to back they both record); this test's sessions came
# after test_k9_matches_plain's. So it profiles K1 in a process of its own.
_K1_PROFILE = """
import sys
import numpy as np
import torch
from hamer_yolo_tpu_torch.ops.nms import greedy_nms_keep, greedy_nms_keep_mask

dev = torch.device("cuda")
rng = np.random.default_rng(3)
boxes = np.zeros((4, 512, 4), np.float32)  # _boxes(rng, 4, 512)
boxes[..., :2] = rng.uniform(0, 600, (4, 512, 2))
boxes[..., 2:] = boxes[..., :2] + rng.uniform(10, 120, (4, 512, 2))
boxes = torch.from_numpy(boxes).to(dev)
active = torch.from_numpy(rng.uniform(0, 1, (4, 512)) > 0.2).to(dev)
fn, act = ((greedy_nms_keep, active.float()) if sys.argv[1] == "f32" else
           (greedy_nms_keep_mask, active))
fn(boxes, act, 0.45)
torch.cuda.synchronize()
for _ in range(3):  # now and then the profiler records no device activity at all
    before = greedy_nms_keep.launches
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        fn(boxes, act, 0.45)
        torch.cuda.synchronize()
    kernels = [e.name for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    assert greedy_nms_keep.launches == before + 1
    if kernels:
        break
assert len(kernels) == 1 and "nms_keep_kernel" in kernels[0], kernels
"""


@pytest.mark.parametrize("entry", ["f32", "bool"])
def test_nms_kernel_is_one_launch(dev, entry):
    """K1 (both entries) is one device kernel a call, by name in a profile
    (in a process of its own, see above), and one count of its counter."""
    import os
    import subprocess
    import sys

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, PYTHONPATH=repo + os.pathsep + os.environ.get("PYTHONPATH", ""))
    res = subprocess.run([sys.executable, "-c", _K1_PROFILE, entry], cwd=repo, env=env,
                         capture_output=True, text=True, timeout=600)
    assert res.returncode == 0, res.stdout[-2000:] + res.stderr[-3000:]


# ---------------------------------------------------------------------------
# Training (training/): one f32 step on the card against the CPU from the same
# weights and batch (TF32 off), the cases and limits chip_smoke shares
# (tests/test_torch_train_pairs.py)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("model,batch,img_size", TRAIN_CASES,
                         ids=[f"{m}_b{b}" for m, b, _ in TRAIN_CASES])
def test_train_step_on_card_matches_cpu(dev, model, batch, img_size):
    """HaMeR at full width with 2 blocks, YOLOv7 at 64 px, KPFusion at
    --tiny: the loss's gradients and one train step, with no kernel
    launched, on the card against the CPU at test_torch_train_pairs' limits."""
    counters = (fused_bf16_attn_block, greedy_nms_keep, fused_short_attention, mano_lbs_fused)
    before = [f.launches for f in counters]
    card_against_cpu(model, dev, batch, img_size)
    assert [f.launches for f in counters] == before


def test_adamw_on_card_matches_cpu(dev):
    """training/optim.AdamW (optax's form, foreach ops) over 20 steps of
    seeded gradients at HaMeR's lr 1e-5 and wd 1e-4, on leaves of several
    shapes: the card's parameters and moments bit-equal to the CPU's."""
    from hamer_yolo_tpu_torch.training.optim import AdamW

    rng = np.random.default_rng(10)
    shapes = [(1280, 3840), (3840,), (7, 3, 3), (1,)]
    start = [rng.standard_normal(s).astype(np.float32) for s in shapes]
    grads = [[(1e-3 * rng.standard_normal(s)).astype(np.float32) for s in shapes]
             for _ in range(20)]
    out = {}
    for d in (dev, torch.device("cpu")):
        ps = [torch.tensor(a, device=d, requires_grad=True) for a in start]
        opt = AdamW(ps, lr=1e-5, weight_decay=1e-4)
        for gs in grads:
            for p, g in zip(ps, gs):
                p.grad = torch.tensor(g, device=d)
            opt.step()
        out[d.type] = [t.detach().cpu() for p in ps
                       for t in (p, opt.state[p]["exp_avg"], opt.state[p]["exp_avg_sq"])]
    assert all(torch.equal(a, b) for a, b in zip(out["cuda"], out["cpu"]))


def test_hamer_train_step_never_launches_k2(dev):
    """A HaMeR config left to pick the ViT's kernel by device (fused_attn
    None: K2 on the card) trains on the plain attention: train_config turns
    it off; the same forward under no_grad launches K2."""
    from hamer_yolo_tpu_torch.cli.main import load_mano
    from hamer_yolo_tpu_torch.models.hamer import hamer_forward
    from hamer_yolo_tpu_torch.tools.train_hamer import tiny_config
    from hamer_yolo_tpu_torch.training import train_hamer as TH

    cfg = dataclasses.replace(tiny_config(), vit=dataclasses.replace(
        tiny_config().vit, compute_dtype="bfloat16", fused_attn=None))
    state = TH.init_train_state(torch.Generator(dev).manual_seed(0), cfg)
    batch = TH.synthetic_batch(torch.Generator(dev).manual_seed(1), 2, cfg)
    mano = load_mano(None, dev)
    before = fused_bf16_attn_block.launches
    metrics = TH.train_step(state, batch, mano, cfg)
    torch.cuda.synchronize()
    assert fused_bf16_attn_block.launches == before
    assert all(np.isfinite(float(v)) for v in metrics.values())
    with torch.no_grad():
        hamer_forward(state.params, mano, batch["img"], cfg)
    assert fused_bf16_attn_block.launches == before + cfg.vit.depth


def test_kernels_refuse_inputs_that_require_grad(dev):
    """F22 on the card: K2, K7 and K1 raise under grad mode on an input that
    requires grad, naming the kernel; under no_grad they launch."""
    g = torch.Generator(dev).manual_seed(8)
    tok = torch.randn(2, 192, 1280, generator=g, device=dev, dtype=torch.bfloat16)
    k2_args = (0.02 * torch.randn(1280, 3840, generator=g, device=dev),
               torch.zeros(3840, device=dev), torch.ones(1280, device=dev),
               torch.zeros(1280, device=dev), 16)
    q = torch.randn(2, 16, 192, 80, generator=g, device=dev, dtype=torch.bfloat16)
    boxes = torch.from_numpy(_boxes(np.random.default_rng(9), 2, 64)).to(dev)
    calls = {"fused_bf16_attn_block": (lambda x: fused_bf16_attn_block(x, *k2_args), tok),
             "fused_short_attention": (lambda x: fused_short_attention(x, q, q), q),
             "greedy_nms_keep": (lambda x: greedy_nms_keep(x, torch.ones(2, 64, device=dev),
                                                           0.5), boxes)}
    for name, (call, x) in calls.items():
        with pytest.raises(ValueError, match=name):
            call(x.clone().requires_grad_(True))
        with torch.no_grad():
            out = call(x.clone().requires_grad_(True))
        assert torch.isfinite(out.float()).all()


def tie_rows(seed, rows, n, zeros=(0.0,)):
    """(rows, n) f32 of few distinct values, about a third of them from
    ``zeros``: ties everywhere."""
    rng = np.random.default_rng(seed)
    vals = np.float32(list(zeros) + [0.25, 0.5, 1.0, 3.0])
    p = [0.3 / len(zeros)] * len(zeros) + [0.2, 0.2, 0.2, 0.1]
    return rng.choice(vals, size=(rows, n), p=p).astype(np.float32)


@pytest.mark.parametrize("n,k", [(7, 7), (64, 16), (1024, 40), (4096, 40)])
def test_smallest_k_on_card_matches_cpu(dev, n, k):
    """ops/pointnet.smallest_k's stable sort on the card gives the CPU's
    indices and values on rows of ties and of -0 beside +0."""
    for d in (tie_rows(5, 64, n), tie_rows(6, 64, n, zeros=(0.0, -0.0))):
        vals, idx = smallest_k(torch.from_numpy(d), k)
        got_vals, got_idx = smallest_k(torch.from_numpy(d).to(dev), k)
        assert torch.equal(got_idx.cpu(), idx)
        assert torch.equal(got_vals.cpu(), vals)
        assert torch.equal(torch.signbit(got_vals.cpu()), torch.signbit(vals))


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_operators_equal_the_wrappers_on_card(dev, dtype):
    """K1 and K2 through the dispatcher's operators (ops/torch_ops.py, the
    route of an exported program) equal the ctypes wrappers bit for bit."""
    from hamer_yolo_tpu_torch.ops import torch_ops

    rng = np.random.default_rng(11)
    boxes = torch.from_numpy(_boxes(rng, 4, 512)).to(dev)
    active = torch.from_numpy(rng.uniform(size=(4, 512)) > 0.3).to(dev)
    assert torch.equal(torch_ops.greedy_nms_keep_mask(boxes, active, 0.35),
                       greedy_nms_keep_mask(boxes, active, 0.35))
    tok = torch.from_numpy(rng.normal(size=(4, 192, 256)).astype(np.float32)).to(dev, dtype)
    w, b = (torch.from_numpy(rng.normal(size=s).astype(np.float32) * 0.05).to(dev)
            for s in ((256, 768), (768,)))
    g, bb = torch.ones(256, device=dev), torch.zeros(256, device=dev)
    with torch.no_grad():
        for bias in (b, None):
            assert torch.equal(torch_ops.fused_bf16_attn_block(tok, w, bias, g, bb, 4),
                               fused_bf16_attn_block(tok, w, bias, g, bb, 4))
