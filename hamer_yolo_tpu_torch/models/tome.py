"""ToMe token merging for the ViT backbone (port of
hamer_yolo_tpu/models/tome.py): a static merge count r per layer, so every
layer's shapes are fixed; bipartite soft matching on cosine similarity (even
tokens, set A, propose their best match among the odd tokens, set B; the r
most similar edges merge, size-weighted, into the B token); sizes tracked
so repeated merges keep the mass. No proportional attention, as in JAX.

JAX expresses the merge as one-hot matmuls for the TPU's matrix unit; here
it is gathers and a scatter-add into an f32 buffer rounded once to the
tokens' dtype, the same size-weighted sums as JAX's one-hot product (which
sums in f32 and rounds once).
"""
from __future__ import annotations

from typing import Callable, Optional, Tuple

import torch

from hamer_yolo_tpu_torch.core import nn


def _norm(x: torch.Tensor) -> torch.Tensor:
    """jnp.linalg.norm over the last axis: the squares' sum in f32, rounded
    to x's dtype, then the square root in x's dtype."""
    return torch.sqrt(torch.sum((x * x).float(), dim=-1, keepdim=True).to(x.dtype))


def _rows(t: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """t (B, N, D) rows at idx (B, R) -> (B, R, D)."""
    return t.gather(1, idx[..., None].expand(-1, -1, t.shape[-1]))


def bipartite_matching(tokens: torch.Tensor, r: int
                       ) -> Optional[Tuple[torch.Tensor, torch.Tensor, torch.Tensor]]:
    """The merge choice of bipartite_soft_matching_merge for tokens (B, N, D):
    (merged_a (B, r), kept_a (B, Na - r), tgt (B, r)), the A indices that
    merge, the A indices kept (ascending) and the B index each merged A
    token goes into; None when nothing merges."""
    Na = (tokens.shape[1] + 1) // 2
    r = min(r, Na - 1)  # keep at least one A token
    if r <= 0:
        return None
    a, b = tokens[:, ::2], tokens[:, 1::2]
    eps = nn.weak_scalar(1e-6, tokens.dtype)
    an = a / torch.clamp(_norm(a), min=eps)
    bn = b / torch.clamp(_norm(b), min=eps)
    # f32 sums of the bf16 products, rounded once, as XLA's dot computes it
    scores = torch.einsum("bad,bcd->bac", an.float(), bn.float()).to(tokens.dtype)
    node_max = torch.amax(scores, dim=-1)   # (B, Na)
    node_idx = torch.argmax(scores, dim=-1)  # first maximum, as jnp.argmax
    # lax.top_k's order: by value, ties by index (a stable sort)
    order = torch.sort(node_max, dim=-1, descending=True, stable=True).indices
    merged_a = order[:, :r]
    return merged_a, torch.sort(order[:, r:], dim=-1).values, node_idx.gather(1, merged_a)


def bipartite_soft_matching_merge(tokens: torch.Tensor, sizes: torch.Tensor, r: int
                                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Merge r tokens: tokens (B, N, D), sizes (B, N) -> (B, N - r, D), (B, N - r).

    Output layout: [the B tokens, merged into or not..., the kept A tokens in
    their original order], with A the even input positions and B the odd ones.
    """
    match = bipartite_matching(tokens, r)
    if match is None:
        return tokens, sizes
    merged_a, kept_a, tgt = match
    B, _, D = tokens.shape
    a, b = tokens[:, ::2], tokens[:, 1::2]
    sa, sb = sizes[:, ::2], sizes[:, 1::2]
    merged_feat = _rows(a * sa[..., None], merged_a)
    merged_size = sa.gather(1, merged_a)
    add_feat = torch.zeros(b.shape, dtype=torch.float32, device=tokens.device).scatter_add_(
        1, tgt[..., None].expand(-1, -1, D), merged_feat.float()).to(tokens.dtype)
    add_size = torch.zeros(sb.shape, dtype=torch.float32, device=tokens.device).scatter_add_(
        1, tgt, merged_size.float()).to(sizes.dtype)
    new_sb = sb + add_size
    new_b = (b * sb[..., None] + add_feat) / new_sb[..., None]
    out_tokens = torch.cat([new_b, _rows(a, kept_a)], dim=1)
    out_sizes = torch.cat([new_sb, sa.gather(1, kept_a)], dim=1)
    return out_tokens, out_sizes


def vit_forward_tome(params: nn.Params, x: torch.Tensor, cfg, r_per_layer: int = 4,
                     fused: Optional[bool] = None,
                     attn_impl: Optional[Callable] = None) -> torch.Tensor:
    """models/vit.vit_forward with r_per_layer tokens merged after each
    block's attention: (B, H, W, 3) -> (B, N - depth * r, D).

    Over quantize_vit_params output the blocks run the int8 ops: with
    ``fused`` (None: core/quant.default_fused, HYT_INT8_FUSED read there) JAX's
    accelerator dispatch of
    core/quant.int8_block_attn_residual and int8_block_mlp_residual (K3 + K4
    with both static scales, else K5 + K7 + K5 and K5 twice) at the merged
    token counts, with the GELU quant.vit_forward_int8 takes on the tokens'
    device; else the unfused composition (quant.int8_mha_self_attention,
    int8_mlp_gelu).

    Over bf16 / f32 params the attention is ``attn_impl`` or else the plain
    nn.mha_self_attention on every device, never K2, as in JAX (its frame
    program hands the ToMe path the attention HYT_ATTN names off its
    accelerator, none on it: pipeline/frame._select_attn_impl). Over int8
    params ``attn_impl`` is ignored, as JAX's quantized dispatch ignores it.
    """
    from hamer_yolo_tpu_torch.models.vit import embed_tokens

    return vit_blocks_tome(params, embed_tokens(params, x, cfg), cfg, r_per_layer, fused,
                           attn_impl=attn_impl)


def vit_blocks_tome(params: nn.Params, tok: torch.Tensor, cfg, r_per_layer: int = 4,
                    fused: Optional[bool] = None, gelu: Optional[str] = None,
                    attn_impl: Optional[Callable] = None) -> torch.Tensor:
    """The blocks, merges and last LayerNorm of vit_forward_tome, from the
    embedded tokens (B, N, D); ``gelu`` as in quant.vit_blocks_int8."""
    from hamer_yolo_tpu_torch.core import quant

    quantized = "wq" in params["blocks"][0]["attn"]["qkv"]
    if quantized:
        if fused is None:
            fused = quant.default_fused(tok, cfg)
        attn, mlp = quant.int8_mha_self_attention, quant.int8_mlp_gelu
        gelu = gelu or quant.gelu_prologue(tok.device)
    else:
        fused = False
        attn, mlp = attn_impl or nn.mha_self_attention, nn.mlp_gelu
    sizes = torch.ones(tok.shape[:2], dtype=tok.dtype, device=tok.device)
    for blk in params["blocks"]:
        if fused:
            tok = quant.int8_block_attn_residual(blk, tok, cfg.num_heads)
            tok, sizes = bipartite_soft_matching_merge(tok, sizes, r_per_layer)
            tok = quant.int8_block_mlp_residual(blk, tok, gelu)
        else:
            tok = tok + attn(blk["attn"], nn.layer_norm(blk["norm1"], tok), cfg.num_heads)
            tok, sizes = bipartite_soft_matching_merge(tok, sizes, r_per_layer)
            tok = tok + mlp(blk["mlp"], nn.layer_norm(blk["norm2"], tok))
    return nn.layer_norm(params["last_norm"], tok)
