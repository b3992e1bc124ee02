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
``ViTConfig.fused_attn`` overrides the choice (JAX: ``HYT_ATTN_BF16``).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

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
    # are on a CUDA device; True / False force them on / off on any device.
    fused_attn: Optional[bool] = None

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


def vit_forward(params: nn.Params, x: torch.Tensor, cfg: ViTConfig = ViTConfig()
                ) -> torch.Tensor:
    """x (B, H, W, 3) normalised crop -> (B, N_tokens, embed_dim)."""
    tok = embed_tokens(params, x, cfg)
    fused = tok.is_cuda if cfg.fused_attn is None else cfg.fused_attn
    for blk in params["blocks"]:
        if fused:
            pre = fused_bf16_attn_block(tok, blk["attn"]["qkv"]["w"], blk["attn"]["qkv"].get("b"),
                                        blk["norm1"]["scale"], blk["norm1"]["bias"], cfg.num_heads)
            a = nn.linear(blk["attn"]["proj"], pre)
        else:
            a = nn.mha_self_attention(blk["attn"], nn.layer_norm(blk["norm1"], tok), cfg.num_heads)
        tok = tok + a
        tok = tok + nn.mlp_gelu(blk["mlp"], nn.layer_norm(blk["norm2"], tok))
    return nn.layer_norm(params["last_norm"], tok)
