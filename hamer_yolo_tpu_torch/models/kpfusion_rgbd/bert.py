"""BERT-style intra-modal keypoint transformers (port of
hamer_yolo_tpu/models/kpfusion_rgbd/bert.py).

``TR_Encoder``: learned position embeddings (a separate embedding table; the
reference builds BertEmbeddings and BertPooler but never calls them) plus a
linear embedding of the image features, then post-LN BERT layers
(self-attention -> dense + LN, exact erf GELU intermediate -> dense + LN; LN
eps 1e-12, HuggingFace's default). ``KP_Interaction_TR`` adds a cls head
and a residual projection: pred = cls_head(encoder(x)) + residual(x).
KPFusion runs it twice a stage: hidden 128, 4 layers, 4 heads, intermediate
16, image features 128 (init_TR) or 131 (final_TR), output 3.
"""
from __future__ import annotations

import math
from typing import Any, Dict, Tuple

import torch

from hamer_yolo_tpu_torch.core import nn

Params = Dict[str, Any]
LN_EPS = 1e-12  # HF Bert layer_norm_eps default


def _ln(p, x):
    return nn.layer_norm(p, x, eps=LN_EPS)


def small_linear_init(gen: torch.Generator, i: int, o: int) -> Params:
    """A linear at N(0, 0.001), zero bias (KPFusion._init_weights)."""
    return {"w": 0.001 * torch.randn((i, o), generator=gen, device=gen.device),
            "b": torch.zeros(o, device=gen.device)}


def bert_layer_init(gen: torch.Generator, hidden: int, heads: int, intermediate: int) -> Params:
    dev = gen.device
    return {
        "q": nn.linear_init(gen, hidden, hidden),
        "k": nn.linear_init(gen, hidden, hidden),
        "v": nn.linear_init(gen, hidden, hidden),
        "attn_out": nn.linear_init(gen, hidden, hidden),
        "attn_ln": nn.layer_norm_init(hidden, dev),
        "inter": nn.linear_init(gen, hidden, intermediate),
        "out": nn.linear_init(gen, intermediate, hidden),
        "out_ln": nn.layer_norm_init(hidden, dev),
    }


def bert_layer(p: Params, x: torch.Tensor, heads: int) -> torch.Tensor:
    B, N, C = x.shape
    hd = C // heads

    def split(t):
        return t.reshape(B, N, heads, hd).permute(0, 2, 1, 3)

    q, k, v = (split(nn.linear(p[n], x)) for n in ("q", "k", "v"))
    attn = nn.softmax(q @ k.transpose(-1, -2) / math.sqrt(hd), dim=-1)
    ctx = (attn @ v).permute(0, 2, 1, 3).reshape(B, N, C)
    x = _ln(p["attn_ln"], x + nn.linear(p["attn_out"], ctx))
    h = nn.gelu(nn.linear(p["inter"], x))
    return _ln(p["out_ln"], x + nn.linear(p["out"], h))


def tr_encoder_init(gen: torch.Generator, img_dim: int, hidden: int = 128, heads: int = 4,
                    layers: int = 4, intermediate: int = 16, max_positions: int = 512) -> Params:
    return {
        "pos_embed": 0.02 * torch.randn((max_positions, hidden), generator=gen,
                                        device=gen.device),
        "img_embed": nn.linear_init(gen, img_dim, hidden),
        "layers": [bert_layer_init(gen, hidden, heads, intermediate) for _ in range(layers)],
    }


def tr_encoder(p: Params, img_feats: torch.Tensor, heads: int = 4) -> torch.Tensor:
    """img_feats (B, N, img_dim) -> (B, N, hidden) (TR_Encoder.forward)."""
    N = img_feats.shape[1]
    x = p["pos_embed"][None, :N] + nn.linear(p["img_embed"], img_feats)
    for lp in p["layers"]:
        x = bert_layer(lp, x, heads)
    return x


def kp_interaction_init(gen: torch.Generator, img_dim: int, out_dim: int = 3,
                        hidden: int = 128, heads: int = 4, layers: int = 4,
                        intermediate: int = 16) -> Params:
    return {
        "bert": tr_encoder_init(gen, img_dim, hidden, heads, layers, intermediate),
        "cls_head": small_linear_init(gen, hidden, out_dim),
        "residual": small_linear_init(gen, img_dim, out_dim),
    }


def kp_interaction(p: Params, img_feats: torch.Tensor,
                   heads: int = 4) -> Tuple[torch.Tensor, torch.Tensor]:
    """(sequence_output (B, N, hidden), pred_score (B, N, out_dim)),
    KP_Interaction_TR.forward."""
    seq = tr_encoder(p["bert"], img_feats, heads)
    return seq, nn.linear(p["cls_head"], seq) + nn.linear(p["residual"], img_feats)
