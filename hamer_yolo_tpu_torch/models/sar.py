"""SAR mesh model and the RootNet absolute-depth head (port of
hamer_yolo_tpu/models/sar.py).

- SAIGB: a 1x1 conv groups the backbone map into num_fms per-vertex feature
  maps (LeakyReLU 0.1), and the MANO template's xyz is appended per vertex.
  The conv's channel c is (vertex v, map f) with c = v * num_fms + f, the
  grouping of the reference's view(-1, V, FMs * fsize).
- GBBMR: two graph-conv stacks (L = D^-1 A with a learned A) regress
  per-vertex xy heatmaps and z maps; a linear lift over the vertex axis
  gives the joints' maps; soft-argmax decodes uv (normalised to [-1, 1]) and
  z = sum(heatmap * z map). Output (B, 799, 3) uvd: 778 vertices, 21 joints.
- RootNet: global average pool of the backbone map -> 1x1 conv -> gamma;
  absolute depth = gamma * k_value (geometry/camera.calculate_k_value).
- The backbone: ResNet-34 (512 channels) or, with ``backbone="convnext"``,
  ConvNeXt-base (1024 channels, models/convnext.py), the reference's two
  RootNets.

The main path runs only the backbone and ``rootnet_depth``;
pipeline/sar_mesh.sar_full_mesh runs the head too.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple

import torch

from hamer_yolo_tpu_torch.core import nn
from hamer_yolo_tpu_torch.models.convnext import convnext_forward, init_convnext
from hamer_yolo_tpu_torch.models.resnet import init_resnet34, resnet34_forward


@dataclass(frozen=True)
class SarConfig:
    backbone: str = "resnet34"  # or "convnext" (base)
    input_size: int = 256
    num_verts: int = 778
    num_joints: int = 21
    num_fms: int = 8
    heatmap_size: int = 32
    feature_hw: int = 8  # 256 / 32
    cam_para: Tuple[float, float, float, float] = (906.96, 906.79, 960.0, 540.0)
    bbox_real: Tuple[float, float] = (0.3, 0.3)
    compute_dtype: str = "bfloat16"

    @property
    def num_total(self) -> int:
        return self.num_verts + self.num_joints

    @property
    def feature_size(self) -> int:
        return self.feature_hw * self.feature_hw

    @property
    def backbone_channels(self) -> int:
        return 512 if self.backbone == "resnet34" else 1024

    @property
    def graph_in_dim(self) -> int:
        return self.num_fms * self.feature_size + 3


def graph_conv_init(gen: torch.Generator, num_nodes: int, in_dim: int, out_dim: int
                    ) -> nn.Params:
    return {"fc": nn.linear_init(gen, in_dim, out_dim),
            "adj": torch.eye(num_nodes, device=gen.device)}


def graph_conv(p: nn.Params, x: torch.Tensor) -> torch.Tensor:
    """x (B, N, F); L = D^-1 A with the learned A, in x's dtype."""
    A = p["adj"].to(x.dtype)
    D = torch.sum(A, dim=1, keepdim=True) + nn.weak_scalar(1e-5, x.dtype)
    return nn.linear(p["fc"], torch.einsum("nm,bmf->bnf", A / D, x))


def soft_heatmap_init(kp_num: int, device) -> nn.Params:
    # the grouped 1x1 conv is a scalar weight per keypoint, no bias
    return {"beta": torch.ones(kp_num, device=device)}


def soft_heatmap(p: nn.Params, hm: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """hm (B, K, S, S) -> (uv (B, K, 2) in pixels, score map (B, K, S, S))."""
    B, K, S, _ = hm.shape
    scaled = hm * p["beta"].to(hm.dtype)[None, :, None, None]
    score = nn.softmax(scaled.reshape(B, K, S * S), dim=-1).reshape(B, K, S, S)
    wx = torch.arange(S, dtype=hm.dtype, device=hm.device)
    sx = torch.sum(score, dim=2) @ wx  # column marginal . x
    sy = torch.sum(score, dim=3) @ wx
    return torch.stack([sx, sy], dim=-1), score


def init_sar_head(gen: torch.Generator, template: torch.Tensor, cfg: SarConfig = SarConfig()
                  ) -> nn.Params:
    hs2 = cfg.heatmap_size ** 2
    V = cfg.num_verts
    return {
        "saigb": {"group": nn.conv_init(gen, 1, cfg.backbone_channels, cfg.num_fms * V,
                                        bias=True),
                  "template": template.to(gen.device, torch.float32)},  # (778, 3)
        "reg_xy1": graph_conv_init(gen, V, cfg.graph_in_dim, hs2),
        "reg_xy2": graph_conv_init(gen, V, hs2, hs2),
        "reg_z1": graph_conv_init(gen, V, cfg.graph_in_dim, hs2),
        "reg_z2": graph_conv_init(gen, V, hs2, hs2),
        "mesh2pose_hm": nn.linear_init(gen, V, cfg.num_joints),
        "mesh2pose_dm": nn.linear_init(gen, V, cfg.num_joints),
        "soft_heatmap": soft_heatmap_init(cfg.num_total, gen.device),
    }


def _leaky_relu(x: torch.Tensor) -> torch.Tensor:
    return torch.nn.functional.leaky_relu(x, nn.weak_scalar(0.1, x.dtype))


def _mesh2pose(p: nn.Params, hm: torch.Tensor) -> torch.Tensor:
    """(B, V, h, w) maps -> (B, J, h, w) by the f32 weights over the vertex
    axis: JAX's einsum promotes the bf16 maps to f32 there."""
    return torch.einsum("bvhw,vj->bjhw", hm.float(), p["w"].float()) + \
        p["b"].float()[None, :, None, None]


def sar_head_forward(p: nn.Params, feats: torch.Tensor, cfg: SarConfig = SarConfig()
                     ) -> torch.Tensor:
    """feats (B, fh, fw, C) backbone map -> (B, 799, 3) uvd f32: uv in [-1, 1]
    (over heatmap_size / 2), z unnormalised."""
    B, S, V = feats.shape[0], cfg.heatmap_size, cfg.num_verts
    g = _leaky_relu(nn.conv2d(p["saigb"]["group"], feats, 1, 0))
    # channel c = v * num_fms + f: (B, fh, fw, V, FMs) -> (B, V, FMs * fh * fw)
    g = g.reshape(B, cfg.feature_hw, cfg.feature_hw, V, cfg.num_fms)
    g = g.permute(0, 3, 4, 1, 2).reshape(B, V, -1)
    template = p["saigb"]["template"].to(g.dtype).expand(B, V, 3)
    init_graph = torch.cat([g, template], dim=-1)  # (B, V, in_dim)

    hm_xy = graph_conv(p["reg_xy2"], _leaky_relu(graph_conv(p["reg_xy1"], init_graph)))
    hm_z = graph_conv(p["reg_z2"], _leaky_relu(graph_conv(p["reg_z1"], init_graph)))
    hm_xy = hm_xy.reshape(B, V, S, S)
    hm_z = hm_z.reshape(B, V, S, S)
    hm_all = torch.cat([hm_xy.float(), _mesh2pose(p["mesh2pose_hm"], hm_xy)], dim=1)
    zm_all = torch.cat([hm_z.float(), _mesh2pose(p["mesh2pose_dm"], hm_z)], dim=1)
    uv, latent = soft_heatmap(p["soft_heatmap"], hm_all)
    z = torch.sum((latent * zm_all).reshape(B, cfg.num_total, -1), dim=-1, keepdim=True)
    uv = uv / (S // 2) - 1.0
    return torch.cat([uv, z], dim=-1).float()


def init_sar(gen: torch.Generator, template: torch.Tensor, cfg: SarConfig = SarConfig()
             ) -> nn.Params:
    """Random-init SAR: backbone (ResNet-34 or ConvNeXt-base, as
    ``cfg.backbone`` says), head and RootNet's depth layer, drawn from ``gen``
    in that order on its device."""
    backbone = init_resnet34(gen) if cfg.backbone == "resnet34" else init_convnext(gen, "base")
    return {"backbone": backbone,
            "head": init_sar_head(gen, template, cfg),
            "rootnet": {"depth_layer": nn.conv_init(gen, 1, cfg.backbone_channels, 1,
                                                    bias=True)}}


def sar_backbone_forward(params: nn.Params, x: torch.Tensor, cfg: SarConfig = SarConfig()
                         ) -> torch.Tensor:
    """(B, H, W, 3) normalised patch -> (B, H/32, W/32, C) in the compute dtype."""
    x = x.to(getattr(torch, cfg.compute_dtype))
    if cfg.backbone == "resnet34":
        return resnet34_forward(params["backbone"], x)
    return convnext_forward(params["backbone"], x)


def sar_forward(params: nn.Params, x: torch.Tensor, cfg: SarConfig = SarConfig()
                ) -> torch.Tensor:
    """Full SAR: (B, 256, 256, 3) normalised patch -> (B, 799, 3) uvd."""
    return sar_head_forward(params["head"], sar_backbone_forward(params, x, cfg), cfg)


def rootnet_depth(params: nn.Params, feats: torch.Tensor, k_value: torch.Tensor
                  ) -> torch.Tensor:
    """ResRootNet's forward_coord: f32 global average pool -> 1x1 conv ->
    gamma; depth = gamma * k. feats (B, h, w, C), k_value (B,) -> (B,)."""
    pooled = nn.avg_pool_global(feats.float())[:, None, None, :]
    gamma = nn.conv2d(params["rootnet"]["depth_layer"], pooled, 1, 0)[:, 0, 0, 0]
    return gamma * k_value


def estimate_root_depth(params: nn.Params, patch: torch.Tensor, k_value: torch.Tensor,
                        cfg: SarConfig = SarConfig()) -> torch.Tensor:
    """The reference's estimate_root_depth_custom: backbone features only ->
    RootNet depth (B,)."""
    return rootnet_depth(params, sar_backbone_forward(params, patch, cfg), k_value)
