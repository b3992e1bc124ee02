"""ViT-H backbone for HaMeR (port of hamer_yolo_tpu/models/vit.py).

Patch-embed conv k16 s16 pad 2 (-> 16 x 12 = 192 tokens), learned
position embedding whose cls slot is added to every token, 32 pre-LN
blocks of 16-head attention and a 4x GELU MLP, final LayerNorm. Output
(B, 192, 1280) tokens.

On CUDA each block's LN + QKV GEMM + attention runs in kernel K2
(ops/attn_block.fused_bf16_attn_block) whatever the compute dtype, the
counterpart of the JAX package's accelerator default; the proj linear and
the MLP stay plain matmuls and GELU, as JAX leaves them outside any
kernel. On the CPU the plain nn.mha_self_attention path runs, as in JAX.
``ViTConfig.fused_attn`` overrides the choice; where it is None, JAX's
``HYT_ATTN_BF16`` switch (read at each call) does: "megakernel" takes K2 on
any device, any other value takes the plain layers. ``attn_impl``, as in
JAX, replaces the plain attention and turns K2 off: the frame program hands
one in where HYT_ATTN names another form (pipeline/frame._select_attn_impl).

Training's stochastic depth (the reference's drop_path_rate 0.55, ramped
linearly over the blocks) runs where ``vit_forward`` gets a generator: each
block's attention and MLP residuals are kept per sample with probability
1 - rate and scaled by 1 / (1 - rate). The ViT then takes the plain layers,
never K2, as JAX leaves its kernel when it gets an rng.
"""
from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Callable, List, Optional

import torch

from hamer_yolo_tpu_torch.core import nn
from hamer_yolo_tpu_torch.ops.attn_block import fused_bf16_attn_block


@dataclass(frozen=True)
class ViTConfig:
    img_size: tuple = (256, 192)  # (H, W) after the center crop
    patch_size: int = 16
    patch_padding: int = 2
    embed_dim: int = 1280
    depth: int = 32
    num_heads: int = 16
    mlp_ratio: float = 4.0
    qkv_bias: bool = True
    compute_dtype: str = "bfloat16"
    # The blocks' kernels (K2 on the bf16 path; K3, K4, K5, K7 on the int8
    # path, core/quant.vit_forward_int8): None picks them where the tokens
    # are on a CUDA device (JAX's switches HYT_ATTN_BF16 and HYT_INT8_FUSED
    # consulted first); True / False force them on / off on any device.
    fused_attn: Optional[bool] = None
    # train-time stochastic depth, on only where vit_forward gets a generator
    drop_path_rate: float = 0.55

    @property
    def grid_hw(self) -> tuple:
        h = (self.img_size[0] + 2 * self.patch_padding - self.patch_size) // self.patch_size + 1
        w = (self.img_size[1] + 2 * self.patch_padding - self.patch_size) // self.patch_size + 1
        return h, w

    @property
    def num_tokens(self) -> int:
        h, w = self.grid_hw
        return h * w


def init_vit(gen: torch.Generator, cfg: ViTConfig = ViTConfig()) -> nn.Params:
    d, dev = cfg.embed_dim, gen.device
    blocks = [{
        "norm1": nn.layer_norm_init(d, dev),
        "attn": nn.mha_qkv_init(gen, d, cfg.num_heads, qkv_bias=cfg.qkv_bias),
        "norm2": nn.layer_norm_init(d, dev),
        "mlp": nn.mlp_init(gen, d, int(d * cfg.mlp_ratio)),
    } for _ in range(cfg.depth)]
    return {
        "patch_embed": nn.conv_init(gen, cfg.patch_size, 3, d, bias=True),
        "pos_embed": nn.trunc_normal((1, cfg.num_tokens + 1, d), gen),
        "blocks": blocks,
        "last_norm": nn.layer_norm_init(d, dev),
    }


def embed_tokens(params: nn.Params, x: torch.Tensor, cfg: ViTConfig = ViTConfig()
                 ) -> torch.Tensor:
    """x (B, H, W, 3) normalised crop -> the tokens entering block 0."""
    B = x.shape[0]
    x = x.to(getattr(torch, cfg.compute_dtype))
    tok = nn.conv2d(params["patch_embed"], x, stride=cfg.patch_size,
                    padding=cfg.patch_padding).reshape(B, -1, cfg.embed_dim)
    pos = params["pos_embed"].to(tok.dtype)
    return tok + pos[:, 1:] + pos[:, :1]


def drop_path_rates(cfg: ViTConfig, depth: int) -> List[float]:
    """Each block's drop rate: drop_path_rate i / (depth - 1)."""
    return [cfg.drop_path_rate * i / max(depth - 1, 1) for i in range(depth)]


def keep_masks(gen: torch.Generator, batch: int, cfg: ViTConfig, depth: int
               ) -> List[torch.Tensor]:
    """2 depth per-sample keep masks (B, 1, 1) bool on ``gen``'s device, a
    block's attention then its MLP, each True with probability 1 - rate."""
    return [torch.rand((batch, 1, 1), generator=gen, device=gen.device) < 1.0 - rate
            for rate in drop_path_rates(cfg, depth) for _ in range(2)]


def bf16_kernel_default(tok: torch.Tensor, cfg: ViTConfig) -> bool:
    """Whether the bf16 blocks take K2: ``cfg.fused_attn`` where it is set,
    else HYT_ATTN_BF16 ("megakernel" on, any other value off), else where the
    tokens are on CUDA (JAX: on a TPU)."""
    if cfg.fused_attn is not None:
        return cfg.fused_attn
    env = os.environ.get("HYT_ATTN_BF16")
    return env == "megakernel" if env is not None else tok.is_cuda


def vit_forward(params: nn.Params, x: torch.Tensor, cfg: ViTConfig = ViTConfig(),
                generator: Optional[torch.Generator] = None,
                attn_impl: Optional[Callable] = None) -> torch.Tensor:
    """x (B, H, W, 3) normalised crop -> (B, N_tokens, embed_dim).
    ``generator`` turns on stochastic depth (``keep_masks`` drawn from it).
    ``attn_impl(attn_params, tokens, num_heads)`` replaces
    nn.mha_self_attention and keeps K2 off, as JAX's does."""
    tok = embed_tokens(params, x, cfg)
    depth = len(params["blocks"])
    masks = None
    if generator is not None and cfg.drop_path_rate > 0.0:
        masks = keep_masks(generator, x.shape[0], cfg, depth)
    rates = drop_path_rates(cfg, depth)

    def drop_path(residual, j):
        if masks is None:
            return residual
        keep = 1.0 - rates[j // 2]
        return residual * masks[j].to(residual.dtype) / keep

    fused = generator is None and attn_impl is None and bf16_kernel_default(tok, cfg)
    attention = attn_impl or nn.mha_self_attention
    for i, blk in enumerate(params["blocks"]):
        if fused:
            pre = fused_bf16_attn_block(tok, blk["attn"]["qkv"]["w"], blk["attn"]["qkv"].get("b"),
                                        blk["norm1"]["scale"], blk["norm1"]["bias"], cfg.num_heads)
            a = nn.linear(blk["attn"]["proj"], pre)
        else:
            a = attention(blk["attn"], nn.layer_norm(blk["norm1"], tok), cfg.num_heads)
        tok = tok + drop_path(a, 2 * i)
        tok = tok + drop_path(nn.mlp_gelu(blk["mlp"], nn.layer_norm(blk["norm2"], tok)), 2 * i + 1)
    return nn.layer_norm(params["last_norm"], tok)
