"""DETR-style cross-modal decoders (port of
hamer_yolo_tpu/models/kpfusion_rgbd/transfusion.py).

``TransformerDecoderLayer`` in its cross_only configuration: post-LN
cross-attention (torch MultiheadAttention: one fused in_proj whose columns
are q, k, v) with learned or sinusoidal positional embeddings added to the
queries and keys, then a ReLU FFN; LN eps 1e-5. Three decoder variants:

- ``detr``:    query pos learned per joint; key pos the DETR sine embedding
               of the image grid; keys the flattened image features.
- ``updated``: query and key pos learned per joint; keys per-joint features
               (what Block_KPFusion runs).
- ``spatial``: queries the image grid with sine pos; keys per-joint
               features with learned pos.

Every layer of the reference's decoders reads the ORIGINAL query and only
the last layer's output is kept, so ``decoder_forward`` runs the last layer
alone: the same result without the work whose output is dropped.
"""
from __future__ import annotations

import math
from typing import Any, Dict, Optional

import numpy as np
import torch

from hamer_yolo_tpu_torch.core import nn

Params = Dict[str, Any]


def detr_sine_position_embedding(H: int, W: int, embedding_dim: int = 64,
                                 temperature: float = 10000.0,
                                 normalize: bool = True) -> np.ndarray:
    """(H*W, 2*embedding_dim) sine embedding, static given the grid."""
    scale = 2 * math.pi
    y = np.cumsum(np.ones((H, W), np.float32), axis=0)
    x = np.cumsum(np.ones((H, W), np.float32), axis=1)
    if normalize:
        y = y / (y[-1:, :] + 1e-6) * scale
        x = x / (x[:, -1:] + 1e-6) * scale
    dim_t = np.arange(embedding_dim, dtype=np.float32)
    dim_t = temperature ** (2 * np.floor(dim_t / 2) / embedding_dim)
    px = x[:, :, None] / dim_t
    py = y[:, :, None] / dim_t
    px = np.stack([np.sin(px[:, :, 0::2]), np.cos(px[:, :, 1::2])], axis=3).reshape(H, W, -1)
    py = np.stack([np.sin(py[:, :, 0::2]), np.cos(py[:, :, 1::2])], axis=3).reshape(H, W, -1)
    return np.concatenate([py, px], axis=2).reshape(H * W, 2 * embedding_dim)


def _mha(p: Params, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
         heads: int) -> torch.Tensor:
    """torch nn.MultiheadAttention on (B, L, C): the fused in_proj's q, k and
    v columns, the queries scaled by head_dim^-0.5 before the product."""
    B, Lq, C = q.shape
    hd = C // heads
    w, b = p["in_proj_w"], p["in_proj_b"]

    def proj(t, i):
        y = t @ w[:, i * C:(i + 1) * C] + b[i * C:(i + 1) * C]
        return y.reshape(B, -1, heads, hd).permute(0, 2, 1, 3)

    qh, kh, vh = proj(q, 0), proj(k, 1), proj(v, 2)
    attn = nn.softmax((qh / math.sqrt(hd)) @ kh.transpose(-1, -2), dim=-1)
    out = (attn @ vh).permute(0, 2, 1, 3).reshape(B, Lq, C)
    return nn.linear(p["out_proj"], out)


def decoder_layer_init(gen: torch.Generator, dim: int, ffn: int, joint_num: int,
                       self_pos: bool, cross_pos: bool) -> Params:
    dev = gen.device
    p: Params = {
        "attn": {"in_proj_w": nn.kaiming_uniform((dim, 3 * dim), dim, gen),
                 "in_proj_b": torch.zeros(3 * dim, device=dev),
                 "out_proj": nn.linear_init(gen, dim, dim)},
        "linear1": nn.linear_init(gen, dim, ffn),
        "linear2": nn.linear_init(gen, ffn, dim),
        "norm2": nn.layer_norm_init(dim, dev),
        "norm3": nn.layer_norm_init(dim, dev),
    }
    if self_pos:
        p["self_posembed"] = 0.02 * torch.randn((joint_num, dim), generator=gen, device=dev)
    if cross_pos:
        p["cross_posembed"] = 0.02 * torch.randn((joint_num, dim), generator=gen, device=dev)
    return p


def decoder_layer(p: Params, query: torch.Tensor, key: torch.Tensor,
                  query_pos: Optional[torch.Tensor], key_pos: Optional[torch.Tensor],
                  heads: int) -> torch.Tensor:
    """cross_only TransformerDecoderLayer: query (B, Pq, C), key (B, Pk, C);
    the learned embeddings of ``p`` where it has them, else ``query_pos`` /
    ``key_pos`` (Pq or Pk, C)."""
    qp = p.get("self_posembed", query_pos)
    kp = p.get("cross_posembed", key_pos)
    q_in = query if qp is None else query + qp[None]
    k_in = key if kp is None else key + kp[None]
    x = nn.layer_norm(p["norm2"], query + _mha(p["attn"], q_in, k_in, k_in, heads), eps=1e-5)
    ff = nn.linear(p["linear2"], torch.relu(nn.linear(p["linear1"], x)))
    return nn.layer_norm(p["norm3"], x + ff, eps=1e-5)


def decoder_init(gen: torch.Generator, variant: str, joint_num: int = 21, dim: int = 128,
                 ffn: int = 128, layers: int = 4) -> Params:
    """variant: 'detr' | 'updated' | 'spatial'."""
    self_pos = variant in ("detr", "updated")
    cross_pos = variant in ("updated", "spatial")
    return {"layers": [decoder_layer_init(gen, dim, ffn, joint_num, self_pos, cross_pos)
                       for _ in range(layers)]}


def decoder_forward(p: Params, variant: str, query: torch.Tensor, key: torch.Tensor,
                    heads: int = 4, grid_hw: Optional[tuple] = None) -> torch.Tensor:
    """A decoder variant -> (B, Pq, C) (the reference's (B, C, Pq), kept
    channel-last).

    detr:    query (B, J, C) joint feats, key (B, H*W, C) image feats, the
             keys' sine pos from ``grid_hw``.
    updated: query (B, J, C), key (B, J, C).
    spatial: query (B, H*W, C) image feats with sine pos, key (B, J, C).
    """
    sine = None
    if variant in ("detr", "spatial"):
        H, W = grid_hw
        emb = detr_sine_position_embedding(H, W, query.shape[-1] // 2)
        sine = nn.constant(tuple(emb.ravel().tolist()), query.dtype,
                           query.device).reshape(emb.shape)
    qpos = sine if variant == "spatial" else None
    kpos = sine if variant == "detr" else None
    return decoder_layer(p["layers"][-1], query, key, qpos, kpos, heads)
