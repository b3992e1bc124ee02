"""MANO transformer-decoder regression head (port of
hamer_yolo_tpu/models/mano_head.py): one zero query token, pre-LN
[self-attn -> cross-attn over the ViT tokens -> MLP] layers, IEF readouts
of 6d pose, betas and weak-perspective camera from the mean parameters."""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Tuple

import torch

from hamer_yolo_tpu_torch.core import nn
from hamer_yolo_tpu_torch.geometry.rotations import rot6d_to_rotmat


@dataclass(frozen=True)
class ManoHeadConfig:
    dim: int = 1024
    context_dim: int = 1280
    depth: int = 6
    heads: int = 8
    dim_head: int = 64
    mlp_dim: int = 1024
    token_dim: int = 1
    num_joints: int = 16
    ief_iters: int = 1

    @property
    def npose(self) -> int:
        return 6 * self.num_joints


def init_mano_head(gen: torch.Generator, cfg: ManoHeadConfig = ManoHeadConfig()) -> nn.Params:
    dev = gen.device
    layers = [{
        "sa_norm": nn.layer_norm_init(cfg.dim, dev),
        "sa": nn.mha_qkv_init(gen, cfg.dim, cfg.heads, cfg.dim_head, qkv_bias=False),
        "ca_norm": nn.layer_norm_init(cfg.dim, dev),
        "ca": nn.cross_attention_init(gen, cfg.dim, cfg.context_dim, cfg.heads, cfg.dim_head),
        "ff_norm": nn.layer_norm_init(cfg.dim, dev),
        "ff": nn.mlp_init(gen, cfg.dim, cfg.mlp_dim),
    } for _ in range(cfg.depth)]
    identity_6d = torch.tensor([1.0, 0, 0, 0, 1, 0], device=dev).repeat(cfg.num_joints)
    return {
        "token_embed": nn.linear_init(gen, cfg.token_dim, cfg.dim),
        "pos_embed": nn.trunc_normal((1, 1, cfg.dim), gen, std=1.0),
        "layers": layers,
        "decpose": nn.linear_init(gen, cfg.dim, cfg.npose),
        "decshape": nn.linear_init(gen, cfg.dim, 10),
        "deccam": nn.linear_init(gen, cfg.dim, 3),
        "init_hand_pose": identity_6d[None],
        "init_betas": torch.zeros((1, 10), device=dev),
        "init_cam": torch.tensor([[0.9, 0.0, 0.0]], device=dev),
    }


def mano_head_forward(params: nn.Params, context: torch.Tensor,
                      cfg: ManoHeadConfig = ManoHeadConfig()
                      ) -> Tuple[Dict[str, torch.Tensor], torch.Tensor]:
    """context (B, N, context_dim) -> ({global_orient (B, 1, 3, 3),
    hand_pose (B, 15, 3, 3), betas (B, 10)}, pred_cam (B, 3))."""
    B, dt = context.shape[0], context.dtype
    pred_pose = params["init_hand_pose"].to(dt).expand(B, cfg.npose)
    pred_betas = params["init_betas"].to(dt).expand(B, 10)
    pred_cam = params["init_cam"].to(dt).expand(B, 3)
    for _ in range(cfg.ief_iters):
        token = torch.zeros((B, 1, cfg.token_dim), dtype=dt, device=context.device)
        x = nn.linear(params["token_embed"], token)
        x = x + params["pos_embed"].to(x.dtype)
        for layer in params["layers"]:
            x = x + nn.mha_self_attention(layer["sa"], nn.layer_norm(layer["sa_norm"], x), cfg.heads)
            x = x + nn.cross_attention(layer["ca"], nn.layer_norm(layer["ca_norm"], x), context,
                                       cfg.heads)
            x = x + nn.mlp_gelu(layer["ff"], nn.layer_norm(layer["ff_norm"], x))
        tok = x[:, 0]
        pred_pose = nn.linear(params["decpose"], tok) + pred_pose
        pred_betas = nn.linear(params["decshape"], tok) + pred_betas
        pred_cam = nn.linear(params["deccam"], tok) + pred_cam
    # Gram-Schmidt in f32 (precision-sensitive).
    rotmats = rot6d_to_rotmat(pred_pose.float().reshape(B, cfg.num_joints, 6))
    pred_mano = {"global_orient": rotmats[:, :1], "hand_pose": rotmats[:, 1:],
                 "betas": pred_betas.float()}
    return pred_mano, pred_cam.float()
