"""PointNet++, DGCNN and pointMLP on parameter trees (port of
hamer_yolo_tpu/models/pointnet2.py), over ops/pointnet.py.

- The building blocks: set abstraction (single and multi-scale grouping),
  the group-all level, feature propagation (three-nn inverse-distance
  upsampling, with sqrt'd or squared distances), edge convolution.
- Nets with their own inits: the SSG classifier and segmenter, pointMLP's
  classifier, DGCNN's classifier, the part segmenter, KPFusion's MSG
  point-stream net (``pointnet2_msg_sem_forward``).
- The zoo's forwards (``ref_*``): the exact architectures of KeypointFusion's
  vendored pointNet zoo, each from the tree its converter in core/convert.py
  makes from the reference's state dict (eval BN folded into the linears):
  ``ref_cls_ssg_forward``, ``ref_sem_seg_forward``,
  ``ref_dgcnn_semseg_forward``, ``ref_part_seg_forward``,
  ``ref_msg_large_forward``, ``ref_pointnet_cls_forward``,
  ``ref_dgcnn_partseg_forward``, ``ref_pointmlp_forward`` and
  ``ref_pointmlp_refine_forward``.

Points are (B, N, 3), features (B, N, C), point-last; a linear is core/nn's
(in, out). Every index set is device-independent (ops/pointnet.py):
furthest points, ball queries and nearest neighbours over squared
distances summed as fma chains (``sqsum3``), ties to the lower index. The
zoo's DGCNN kNN keeps the reference's matmul form, -|x_i|^2 + 2 x_i.x_j -
|x_j|^2, with the product and the squared norms summed in float64 and each
rounded to float32 once, so that no device's reduction order decides a
neighbour.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F

from hamer_yolo_tpu_torch.core import nn
from hamer_yolo_tpu_torch.ops import pointnet as pn

Params = Dict[str, Any]


def _mlp_stack_init(gen: torch.Generator, dims: List[int]) -> Params:
    return {"layers": [nn.linear_init(gen, dims[i], dims[i + 1]) for i in range(len(dims) - 1)]}


def _mlp_stack(p: Params, x: torch.Tensor) -> torch.Tensor:
    for layer in p["layers"]:
        x = torch.relu(nn.linear(layer, x))
    return x


@dataclass(frozen=True)
class SAConfig:
    npoint: int
    radius: float
    nsample: int
    mlp: Tuple[int, ...]


def sa_init(gen: torch.Generator, in_dim: int, cfg: SAConfig) -> Params:
    return _mlp_stack_init(gen, [in_dim + 3] + list(cfg.mlp))


def set_abstraction(p: Params, xyz: torch.Tensor, feats: torch.Tensor,
                    cfg: SAConfig) -> Tuple[torch.Tensor, torch.Tensor]:
    """(B, N, 3), (B, N, C) -> (B, npoint, 3), (B, npoint, mlp[-1])."""
    new_xyz = pn.gather_points(xyz, pn.furthest_point_sampling(xyz, cfg.npoint))
    grouped = pn.query_and_group(xyz, new_xyz, feats, cfg.radius, cfg.nsample)
    return new_xyz, torch.amax(_mlp_stack(p, grouped), dim=2)


def global_sa(p: Params, xyz: torch.Tensor, feats: torch.Tensor) -> torch.Tensor:
    """Group-all SA: (B, N, 3 + C) -> (B, mlp[-1])."""
    return torch.amax(_mlp_stack(p, torch.cat([xyz, feats], dim=-1)), dim=1)


def fp_init(gen: torch.Generator, in_dim: int, mlp: Tuple[int, ...]) -> Params:
    return _mlp_stack_init(gen, [in_dim] + list(mlp))


def feature_propagation(p: Params, xyz_dense: torch.Tensor, xyz_sparse: torch.Tensor,
                        feats_dense: Optional[torch.Tensor], feats_sparse: torch.Tensor,
                        sq_weights: bool = False) -> torch.Tensor:
    """Sparse features upsampled onto the dense points, [dense, upsampled]
    through the MLP. ``sq_weights``: inverse squared-distance weights (the
    reference's pure-torch utils), else inverse distances (its CUDA
    modules)."""
    d, idx = (pn.three_nn_sq if sq_weights else pn.three_nn)(xyz_dense, xyz_sparse)
    interp = pn.three_interpolate(feats_sparse, idx, pn.interpolation_weights(d))
    if feats_dense is not None:
        interp = torch.cat([feats_dense, interp], dim=-1)
    return _mlp_stack(p, interp)


CLS_SA1 = SAConfig(npoint=512, radius=0.2, nsample=32, mlp=(64, 64, 128))
CLS_SA2 = SAConfig(npoint=128, radius=0.4, nsample=64, mlp=(128, 128, 256))


def init_pointnet2_cls(gen: torch.Generator, num_classes: int = 40, in_dim: int = 3,
                       sa1: SAConfig = CLS_SA1, sa2: SAConfig = CLS_SA2) -> Params:
    return {
        "sa1": sa_init(gen, in_dim, sa1),
        "sa2": sa_init(gen, sa1.mlp[-1], sa2),
        "sa3": _mlp_stack_init(gen, [sa2.mlp[-1] + 3, 256, 512, 1024]),
        "fc1": nn.linear_init(gen, 1024, 256),
        "fc2": nn.linear_init(gen, 256, num_classes),
        "_cfgs": None,
    }


def pointnet2_cls_forward(p: Params, xyz: torch.Tensor, sa1: SAConfig = CLS_SA1,
                          sa2: SAConfig = CLS_SA2) -> torch.Tensor:
    """(B, N, 3) -> (B, num_classes) logits."""
    x1, f1 = set_abstraction(p["sa1"], xyz, xyz, sa1)
    x2, f2 = set_abstraction(p["sa2"], x1, f1, sa2)
    g = global_sa(p["sa3"], x2, f2)
    return nn.linear(p["fc2"], torch.relu(nn.linear(p["fc1"], g)))


# --- pointMLP's classifier -----------------------------------------------------

def geometric_affine_init(dim: int, device=None) -> Params:
    return {"alpha": torch.ones(dim, device=device), "beta": torch.zeros(dim, device=device)}


def geometric_affine(p: Params, grouped: torch.Tensor) -> torch.Tensor:
    """Groups centred on their anchor, scaled by the (population) std over all
    of them, then the learned affine. grouped: (B, S, K, C)."""
    centered = grouped - grouped[:, :, :1, :]
    std = torch.std(centered, dim=(1, 2, 3), keepdim=True, correction=0) + 1e-5
    return p["alpha"] * (centered / std) + p["beta"]


def _res_block_init(gen: torch.Generator, dim: int) -> Params:
    return {"fc1": nn.linear_init(gen, dim, dim), "fc2": nn.linear_init(gen, dim, dim)}


def _res_block(p: Params, x: torch.Tensor) -> torch.Tensor:
    h = torch.relu(nn.linear(p["fc1"], x))
    return torch.relu(x + nn.linear(p["fc2"], h))


def init_pointmlp_cls(gen: torch.Generator, num_classes: int = 40,
                      dims: Tuple[int, ...] = (64, 128), npoints: Tuple[int, ...] = (256, 64),
                      nsample: int = 16) -> Params:
    stages = []
    c_in = 3
    for d in dims:
        stages.append({"embed": nn.linear_init(gen, c_in + 3, d),
                       "affine": geometric_affine_init(c_in + 3, gen.device),
                       "pre": _res_block_init(gen, d), "pos": _res_block_init(gen, d)})
        c_in = d
    return {"stages": stages, "fc1": nn.linear_init(gen, dims[-1], 128),
            "fc2": nn.linear_init(gen, 128, num_classes)}


def pointmlp_cls_forward(p: Params, xyz: torch.Tensor, npoints: Tuple[int, ...] = (256, 64),
                         nsample: int = 16, radius: float = 0.5) -> torch.Tensor:
    """(B, N, 3) -> (B, num_classes): furthest-point downsampling, grouped
    residual MLPs with the geometric affine."""
    feats = pts = xyz
    for stage, npoint in zip(p["stages"], npoints):
        new_pts = pn.gather_points(pts, pn.furthest_point_sampling(pts, npoint))
        grouped = geometric_affine(stage["affine"],
                                   pn.query_and_group(pts, new_pts, feats, radius, nsample))
        h = _res_block(stage["pre"], torch.relu(nn.linear(stage["embed"], grouped)))
        feats = _res_block(stage["pos"], torch.amax(h, dim=2))
        pts = new_pts
    pooled = torch.amax(feats, dim=1)
    return nn.linear(p["fc2"], torch.relu(nn.linear(p["fc1"], pooled)))


# --- DGCNN ----------------------------------------------------------------------

def knn_indices(xyz: torch.Tensor, k: int) -> torch.Tensor:
    """(B, N, d) -> (B, N, k) nearest-neighbour indices, self included."""
    return pn.smallest_k(pn.pairwise_sqdist(xyz, xyz), k)[1]


def edge_conv(p: Params, feats: torch.Tensor, k: int,
              graph_xyz: Optional[torch.Tensor] = None) -> torch.Tensor:
    """MLP([x_i, x_j - x_i]) max-pooled over the kNN of ``graph_xyz``
    (default: the features themselves). feats: (B, N, C)."""
    idx = knn_indices(graph_xyz if graph_xyz is not None else feats, k)
    neighbors = pn.group_points(feats, idx)
    center = feats[:, :, None, :]
    edge = torch.cat([center.expand_as(neighbors), neighbors - center], dim=-1)
    return torch.amax(_mlp_stack(p, edge), dim=2)


def init_dgcnn_cls(gen: torch.Generator, num_classes: int = 40, k: int = 20,
                   dims: Tuple[int, ...] = (64, 64, 128, 256)) -> Params:
    layers, c_in = [], 3
    for d in dims:
        layers.append(_mlp_stack_init(gen, [2 * c_in, d]))
        c_in = d
    return {"edges": layers, "agg": _mlp_stack_init(gen, [sum(dims), 512]),
            "fc1": nn.linear_init(gen, 1024, 256), "fc2": nn.linear_init(gen, 256, num_classes),
            "k": None}


def dgcnn_cls_forward(p: Params, xyz: torch.Tensor, k: int = 20) -> torch.Tensor:
    """(B, N, 3) -> (B, num_classes) logits over dynamic feature graphs."""
    feats, skips = xyz, []
    for i, layer in enumerate(p["edges"]):
        feats = edge_conv(layer, feats, k, graph_xyz=xyz if i == 0 else None)
        skips.append(feats)
    agg = _mlp_stack(p["agg"], torch.cat(skips, dim=-1))
    pooled = torch.cat([torch.amax(agg, dim=1), torch.mean(agg, dim=1)], dim=-1)
    return nn.linear(p["fc2"], torch.relu(nn.linear(p["fc1"], pooled)))


def init_pointnet2_seg(gen: torch.Generator, num_classes: int, in_dim: int = 3,
                       sa1: SAConfig = CLS_SA1, sa2: SAConfig = CLS_SA2) -> Params:
    return {
        "sa1": sa_init(gen, in_dim, sa1),
        "sa2": sa_init(gen, sa1.mlp[-1], sa2),
        "fp2": fp_init(gen, sa1.mlp[-1] + sa2.mlp[-1], (256, 128)),
        "fp1": fp_init(gen, in_dim + 128, (128, 128)),
        "head": nn.linear_init(gen, 128, num_classes),
    }


def pointnet2_seg_forward(p: Params, xyz: torch.Tensor, sa1: SAConfig = CLS_SA1,
                          sa2: SAConfig = CLS_SA2) -> torch.Tensor:
    """(B, N, 3) -> (B, N, num_classes) per-point logits."""
    x1, f1 = set_abstraction(p["sa1"], xyz, xyz, sa1)
    x2, f2 = set_abstraction(p["sa2"], x1, f1, sa2)
    u1 = feature_propagation(p["fp2"], x1, x2, f1, f2)
    return nn.linear(p["head"], feature_propagation(p["fp1"], xyz, x1, xyz, u1))


# --- multi-scale grouping, part and semantic segmentation ------------------------

@dataclass(frozen=True)
class MSGConfig:
    """One multi-scale SA level: shared furthest-point centroids, a ball
    query, MLP and max-pool a scale, the scales concatenated."""
    npoint: int
    radii: Tuple[float, ...]
    nsamples: Tuple[int, ...]
    mlps: Tuple[Tuple[int, ...], ...]

    @property
    def out_dim(self) -> int:
        return sum(m[-1] for m in self.mlps)


def sa_msg_init(gen: torch.Generator, in_dim: int, cfg: MSGConfig) -> Params:
    return {"scales": [_mlp_stack_init(gen, [in_dim + 3] + list(mlp)) for mlp in cfg.mlps]}


def set_abstraction_msg(p: Params, xyz: torch.Tensor, feats: torch.Tensor,
                        cfg: MSGConfig) -> Tuple[torch.Tensor, torch.Tensor]:
    """(B, N, 3), (B, N, C) -> (B, npoint, 3), (B, npoint, out_dim); each
    scale groups [rel xyz, feats] (the CUDA modules' order)."""
    new_xyz = pn.gather_points(xyz, pn.furthest_point_sampling(xyz, cfg.npoint))
    outs = [torch.amax(_mlp_stack(sp, pn.query_and_group(xyz, new_xyz, feats, r, ns)), dim=2)
            for sp, r, ns in zip(p["scales"], cfg.radii, cfg.nsamples)]
    return new_xyz, torch.cat(outs, dim=-1)


def global_feature_propagation(p: Params, feats_dense: torch.Tensor,
                               global_feat: torch.Tensor) -> torch.Tensor:
    """FP from a group-all level: the one global vector on every dense point."""
    tiled = global_feat[:, None, :].expand(feats_dense.shape[0], feats_dense.shape[1], -1)
    return _mlp_stack(p, torch.cat([feats_dense, tiled], dim=-1))


PART_SA1 = SAConfig(npoint=512, radius=0.2, nsample=32, mlp=(64, 64, 128))
PART_SA2 = SAConfig(npoint=128, radius=0.4, nsample=64, mlp=(128, 128, 256))


def init_pointnet2_part_seg(gen: torch.Generator, num_classes: int, in_dim: int = 3,
                            sa1: SAConfig = PART_SA1, sa2: SAConfig = PART_SA2) -> Params:
    """sa1 -> sa2 -> group-all sa3 -> fp3 -> fp2 -> fp1 -> per-point head;
    ``in_dim`` counts the per-point features beyond xyz."""
    return {
        "sa1": sa_init(gen, 3 + in_dim, sa1),
        "sa2": sa_init(gen, sa1.mlp[-1], sa2),
        "sa3": _mlp_stack_init(gen, [sa2.mlp[-1] + 3, 256, 512, 1024]),
        "fp3": fp_init(gen, sa2.mlp[-1] + 1024, (256, 256)),
        "fp2": fp_init(gen, sa1.mlp[-1] + 256, (256, 128)),
        "fp1": fp_init(gen, 3 + 3 + in_dim + 128, (128, 128, 128)),
        "fc": nn.linear_init(gen, 128, 128),
        "head": nn.linear_init(gen, 128, num_classes),
    }


def pointnet2_part_seg_forward(p: Params, xyz: torch.Tensor,
                               feats: Optional[torch.Tensor] = None,
                               sa1: SAConfig = PART_SA1, sa2: SAConfig = PART_SA2
                               ) -> torch.Tensor:
    """(B, N, 3) [+ (B, N, in_dim) feats] -> (B, N, num_classes)."""
    f0 = xyz if feats is None else torch.cat([xyz, feats], dim=-1)
    x1, f1 = set_abstraction(p["sa1"], xyz, f0, sa1)
    x2, f2 = set_abstraction(p["sa2"], x1, f1, sa2)
    u2 = global_feature_propagation(p["fp3"], f2, global_sa(p["sa3"], x2, f2))
    u1 = feature_propagation(p["fp2"], x1, x2, f1, u2)
    u0 = feature_propagation(p["fp1"], xyz, x1, torch.cat([xyz, f0], dim=-1), u1)
    return nn.linear(p["head"], torch.relu(nn.linear(p["fc"], u0)))


# KPFusion's point-stream MSG net: 4 MSG SA levels, 4 FP levels, fc, the
# per-point heads (default [21 x 3 offsets, 21 closeness, 21 weights]).
MSG_SEM_LEVELS = (
    MSGConfig(1024, (0.05, 0.1), (16, 32), ((16, 16, 32), (32, 32, 64))),
    MSGConfig(256, (0.1, 0.2), (16, 32), ((64, 64, 128), (64, 96, 128))),
    MSGConfig(64, (0.2, 0.4), (16, 32), ((128, 196, 256), (128, 196, 256))),
    MSGConfig(16, (0.4, 0.8), (16, 32), ((256, 256, 512), (256, 384, 512))),
)


def init_pointnet2_msg_sem(gen: torch.Generator, in_dim: int = 0,
                           head_dims: Tuple[int, ...] = (63, 21, 21),
                           levels: Tuple[MSGConfig, ...] = MSG_SEM_LEVELS) -> Params:
    n = len(levels)
    sas, dims = [], [in_dim]
    for lv in levels:
        sas.append(sa_msg_init(gen, dims[-1], lv))
        dims.append(lv.out_dim)
    fp_mlps = [(256, 128, 128), (256, 256), (512, 512), (512, 512)]
    fps = []
    for i in range(n):  # fp[i] upsamples level i + 1 onto level i
        c_up = fp_mlps[i + 1][-1] if i + 1 < n else dims[n]
        fps.append(fp_init(gen, dims[i] + c_up, fp_mlps[i]))
    return {"sa": sas, "fp": fps, "fc": _mlp_stack_init(gen, [fp_mlps[0][-1], 128]),
            "heads": [nn.linear_init(gen, 128, d) for d in head_dims]}


def pointnet2_msg_sem_forward(p: Params, xyz: torch.Tensor,
                              feats: Optional[torch.Tensor] = None,
                              levels: Tuple[MSGConfig, ...] = MSG_SEM_LEVELS
                              ) -> List[torch.Tensor]:
    """(B, N, 3) [+ feats (B, N, in_dim)] -> [the per-point heads' outputs]."""
    n = len(levels)
    xs = [xyz]
    fs = [feats if feats is not None else xyz.new_zeros(xyz.shape[:2] + (0,))]
    for i, lv in enumerate(levels):
        x, f = set_abstraction_msg(p["sa"][i], xs[-1], fs[-1], lv)
        xs.append(x)
        fs.append(f)
    up = fs[n]
    for i in range(n - 1, -1, -1):
        up = feature_propagation(p["fp"][i], xs[i], xs[i + 1], fs[i], up)
    h = _mlp_stack(p["fc"], up)
    return [nn.linear(head, h) for head in p["heads"]]


# --- the zoo's forwards -------------------------------------------------------------
# The vendored zoo's exact architectures from the BN-folded trees of
# core/convert.convert_pointnet2_* / convert_dgcnn_* / convert_pointmlp.

# PointNet2ClassificationSSG: SA(512, r 0.2, 64) -> SA(128, r 0.4, 64) ->
# group-all -> fc 1024 -> 512 -> 256 -> 40; the cloud (B, N, 6) is xyz + 3
# features.
CLS_SSG_REF_CFGS = (SAConfig(512, 0.2, 64, ()), SAConfig(128, 0.4, 64, ()))


def ref_cls_ssg_forward(p: Params, pc: torch.Tensor) -> torch.Tensor:
    """(B, N, 6) -> (B, 40) logits."""
    x, f = pc[..., :3], pc[..., 3:]
    for sp, cfg in zip(p["sa"][:-1], CLS_SSG_REF_CFGS):
        x, f = set_abstraction(sp, x, f, cfg)
    h = torch.relu(nn.linear(p["fc"][0], global_sa(p["sa"][-1], x, f)))
    h = torch.relu(nn.linear(p["fc"][1], h))
    return nn.linear(p["fc"][2], h)


# PointNet2SemSegSSG: 4 SA + 4 FP + a conv1d head; the cloud (B, N, 9) is
# xyz + 6 features.
SEM_SSG_REF_CFGS = (SAConfig(1024, 0.1, 32, ()), SAConfig(256, 0.2, 32, ()),
                    SAConfig(64, 0.4, 32, ()), SAConfig(16, 0.8, 32, ()))


def ref_sem_seg_forward(p: Params, pc: torch.Tensor) -> torch.Tensor:
    """(B, N, 9) -> (B, N, 13) per-point logits."""
    xs, fs = [pc[..., :3]], [pc[..., 3:]]
    for sp, cfg in zip(p["sa"], SEM_SSG_REF_CFGS):
        x, f = set_abstraction(sp, xs[-1], fs[-1], cfg)
        xs.append(x)
        fs.append(f)
    for i in range(len(p["sa"]) - 1, -1, -1):
        fs[i] = feature_propagation(p["fp"][i], xs[i], xs[i + 1], fs[i], fs[i + 1])
    return nn.linear(p["head"][1], torch.relu(nn.linear(p["head"][0], fs[0])))


def _leaky_mlp_stack(p: Params, x: torch.Tensor) -> torch.Tensor:
    for layer in p["layers"]:
        x = F.leaky_relu(nn.linear(layer, x), 0.2)
    return x


def _knn_ref(x: torch.Tensor, k: int) -> torch.Tensor:
    """DGCNN's knn in its matmul form, -|x_i|^2 + 2 x_i.x_j - |x_j|^2, its k
    largest (ties to the lower index); the product and the norms in float64,
    each rounded to float32 once. x: (B, N, C)."""
    xd = x.double()
    inner = -2.0 * (xd @ xd.transpose(1, 2)).float()
    xx = (xd * xd).sum(-1, keepdim=True).float()
    neg_d = -xx - inner - xx.transpose(1, 2)
    return pn.smallest_k(-neg_d, k)[1]


def _graph_feature_ref(feats: torch.Tensor, graph_src: torch.Tensor, k: int,
                       idx: Optional[torch.Tensor] = None) -> torch.Tensor:
    """get_graph_feature: [x_j - x_i, x_i] over the kNN of ``graph_src``."""
    if idx is None:
        idx = _knn_ref(graph_src, k)
    nbr = pn.group_points(feats, idx)
    ctr = feats[:, :, None, :]
    return torch.cat([nbr - ctr, ctr.expand_as(nbr)], dim=-1)


def _dgcnn_trunk(p: Params, x: torch.Tensor, k: int, stage1: Tuple[torch.Tensor, ...]):
    """The three edge-conv stages and the global embedding broadcast:
    (x1, x2, x3, the embedding's max over N on every point)."""
    h = _leaky_mlp_stack(p["conv12"], _graph_feature_ref(x, *stage1))
    x1 = torch.amax(h, dim=2)
    x2 = torch.amax(_leaky_mlp_stack(p["conv34"], _graph_feature_ref(x1, x1, k)), dim=2)
    x3 = torch.amax(_leaky_mlp_stack(p["conv5"], _graph_feature_ref(x2, x2, k)), dim=2)
    emb = _leaky_mlp_stack(p["conv6"], torch.cat([x1, x2, x3], dim=-1))
    g = torch.amax(emb, dim=1, keepdim=True).expand(-1, emb.shape[1], -1)
    return torch.cat([g, x1, x2, x3], dim=-1)


def ref_dgcnn_semseg_forward(p: Params, pc: torch.Tensor, k: int = 40,
                             stage1_idx: Optional[torch.Tensor] = None) -> torch.Tensor:
    """DGCNN_semseg: cloud (B, N, C) -> the per-point heads concatenated,
    (B, N, 5 J). The first graph is built on channels 6: (dim9), later ones
    on the running features; leaky ReLU 0.2, conv9 and the finals affine.
    A cloud of 6 channels or fewer leaves channels 6: empty, every distance
    0, and the first graph the lowest indices; ``stage1_idx`` pins that
    graph to a caller's choice."""
    h = _dgcnn_trunk(p, pc, k, (pc[..., 6:], k, stage1_idx))
    h = _leaky_mlp_stack(p["conv8"], _leaky_mlp_stack(p["conv7"], h))
    pf = nn.linear(p["conv9"], h)
    return torch.cat([nn.linear(head, pf) for head in p["finals"]], dim=-1)


# The part segmenter and PointNet2_MSG_large follow the reference's second,
# pure-torch utils: squared-distance FP weights, the skip first in FP, MSG
# grouping with the features before the relative xyz.

def joint2pcloffset_ref(joint: torch.Tensor, pcl: torch.Tensor,
                        kernel_size: float) -> torch.Tensor:
    """(B, J, 3) joints, (B, N, 3) points -> (B, N, 4 J): the unit offsets
    to each joint within ``kernel_size`` (else 0), then the closenesses."""
    B, J, _ = joint.shape
    N = pcl.shape[1]
    offset = joint[:, :, None, :] - pcl[:, None, :, :]
    dis = torch.sqrt(torch.sum(offset * offset, dim=-1))
    on = (offset / dis[..., None]).permute(0, 1, 3, 2).reshape(B, J * 3, N)
    closeness = (kernel_size - dis) / kernel_size
    mask = (closeness >= 0).to(pcl.dtype)
    closeness = closeness * mask
    mask3 = mask[:, :, None, :].expand(B, J, 3, N).reshape(B, J * 3, N)
    return torch.cat([on * mask3, closeness], dim=1).permute(0, 2, 1)


PART_REF_SA1 = SAConfig(512, 0.2, 32, ())
PART_REF_SA2 = SAConfig(128, 0.4, 64, ())


def ref_part_seg_forward(p: Params, xyz: torch.Tensor, joint: torch.Tensor,
                         kernel_size: float = 0.8) -> torch.Tensor:
    """PointNet2 part segmentation: (B, N, 3) points + (B, J, 3) joints ->
    (B, N, num_classes)."""
    l0 = torch.cat([xyz, joint2pcloffset_ref(joint, xyz, kernel_size)], dim=-1)
    x1, f1 = set_abstraction(p["sa1"], xyz, l0, PART_REF_SA1)
    x2, f2 = set_abstraction(p["sa2"], x1, f1, PART_REF_SA2)
    u2 = global_feature_propagation(p["fp3"], f2, global_sa(p["sa3"], x2, f2))
    u1 = feature_propagation(p["fp2"], x1, x2, f1, u2, sq_weights=True)
    u0 = feature_propagation(p["fp1"], xyz, x1, torch.cat([xyz, l0], dim=-1), u1,
                             sq_weights=True)
    return nn.linear(p["head"], torch.relu(nn.linear(p["fc"], u0)))


MSG_LARGE_LEVELS = (
    MSGConfig(512, (0.05, 0.1), (16, 32), ((16, 16, 32), (32, 32, 64))),
    MSGConfig(256, (0.1, 0.2), (16, 32), ((64, 64, 128), (64, 96, 128))),
    MSGConfig(64, (0.2, 0.4), (16, 32), ((128, 196, 256), (128, 196, 256))),
    MSGConfig(16, (0.4, 0.8), (16, 32), ((256, 256, 512), (256, 384, 512))),
)


def _set_abstraction_msg_ref(p: Params, xyz: torch.Tensor, feats: torch.Tensor,
                             cfg: MSGConfig) -> Tuple[torch.Tensor, torch.Tensor]:
    """PointNetSetAbstractionMsg: each scale groups [feats, rel xyz]."""
    new_xyz = pn.gather_points(xyz, pn.furthest_point_sampling(xyz, cfg.npoint))
    outs = []
    for sp, radius, nsample in zip(p["scales"], cfg.radii, cfg.nsamples):
        bidx = pn.ball_query(new_xyz, xyz, radius, nsample)
        rel = pn.group_points(xyz, bidx) - new_xyz[:, :, None, :]
        grouped = torch.cat([pn.group_points(feats, bidx), rel], dim=-1)
        outs.append(torch.amax(_mlp_stack(sp, grouped), dim=2))
    return new_xyz, torch.cat(outs, dim=-1)


def ref_msg_large_forward(p: Params, xyz: torch.Tensor) -> torch.Tensor:
    """PointNet2_MSG_large: (B, N, 3) -> (B, N, 5 J), the offsets, closeness
    and weights heads concatenated."""
    xs, fs = [xyz], [xyz]
    for sp, cfg in zip(p["sa"], MSG_LARGE_LEVELS):
        x, f = _set_abstraction_msg_ref(sp, xs[-1], fs[-1], cfg)
        xs.append(x)
        fs.append(f)
    up = fs[4]
    for i in range(3, 0, -1):
        up = feature_propagation(p["fp"][i], xs[i], xs[i + 1], fs[i], up, sq_weights=True)
    up = feature_propagation(p["fp"][0], xs[0], xs[1], None, up, sq_weights=True)
    h = torch.relu(nn.linear(p["fc"], up))
    return torch.cat([nn.linear(head, h) for head in p["finals"]], dim=-1)


def ref_pointnet_cls_forward(p: Params, pc: torch.Tensor) -> torch.Tensor:
    """PointNet (DGCNN.py): five conv-BN-ReLU, the global max, the fc head;
    (B, N, 3) -> (B, 40) logits."""
    g = torch.amax(_mlp_stack(p["convs"], pc), dim=1)
    return nn.linear(p["fc2"], torch.relu(nn.linear(p["fc1"], g)))


def ref_transform_net(p: Params, x0: torch.Tensor) -> torch.Tensor:
    """Transform_Net: (B, N, k, 6) graph features -> (B, 3, 3)."""
    h = torch.amax(_leaky_mlp_stack(p["conv12"], x0), dim=2)
    g = torch.amax(_leaky_mlp_stack(p["conv3"], h), dim=1)
    g = F.leaky_relu(nn.linear(p["fc1"], g), 0.2)
    g = F.leaky_relu(nn.linear(p["fc2"], g), 0.2)
    return nn.linear(p["transform"], g).reshape(-1, 3, 3)


def ref_dgcnn_partseg_forward(p: Params, pc: torch.Tensor, k: int = 40) -> torch.Tensor:
    """DGCNN_partseg: (B, N, 3) -> (B, N, seg_num_all); the transform net's
    alignment, then the edge-conv trunk with the global embedding."""
    t = ref_transform_net(p["tnet"], _graph_feature_ref(pc, pc, k))
    x = torch.einsum("bnd,bde->bne", pc, t)
    h = _dgcnn_trunk(p, x, k, (x, k))
    for name in ("conv8", "conv9", "conv10"):
        h = _leaky_mlp_stack(p[name], h)
    return nn.linear(p["conv11"], h)


# pointMLP's joint regressor: an embedding, 4 x (the anchor-normalised kNN
# grouper, pre-extraction residual MLPs, max-pool, pos-extraction), 4 FP
# decoders, a global-max-pool context, the conv head and three finals.

def _res_block_ref(p: Params, x: torch.Tensor) -> torch.Tensor:
    """ConvBNReLURes1D (groups 1): relu(net2(relu(net1(x))) + x)."""
    h = torch.relu(nn.linear(p["net1"], x))
    return torch.relu(nn.linear(p["net2"], h) + x)


def _res_stack_ref(blocks, x: torch.Tensor) -> torch.Tensor:
    for b in blocks:
        x = _res_block_ref(b, x)
    return x


def _local_grouper_ref(p: Params, xyz: torch.Tensor, feats: torch.Tensor, groups: int,
                       k: int):
    """LocalGrouper (use_xyz, normalize "anchor"): the k nearest of each
    furthest-point anchor, centred on it, scaled by torch.std's unbiased std
    over each cloud's whole flatten, the learned affine, then the anchor's
    features beside."""
    fps_idx = pn.furthest_point_sampling(xyz, groups)
    new_xyz = pn.gather_points(xyz, fps_idx)
    new_points = pn.gather_points(feats, fps_idx)
    idx = pn.smallest_k(pn.pairwise_sqdist(new_xyz, xyz), k)[1]
    grouped = torch.cat([pn.group_points(feats, idx), pn.group_points(xyz, idx)], dim=-1)
    anchor = torch.cat([new_points, new_xyz], dim=-1)[:, :, None, :]
    centered = grouped - anchor
    flat = centered.reshape(xyz.shape[0], -1)
    var = torch.sum((flat - flat.mean(dim=1, keepdim=True)) ** 2, dim=1) / (flat.shape[1] - 1)
    std = torch.sqrt(var)[:, None, None, None]
    normed = p["alpha"] * (centered / (std + 1e-5)) + p["beta"]
    anchor_rep = new_points[:, :, None, :].expand(-1, -1, k, -1)
    return new_xyz, torch.cat([normed, anchor_rep], dim=-1)


def _fp_pointmlp_ref(p: Params, xyz_dense, xyz_sparse, skip, up) -> torch.Tensor:
    """pointMLP's feature propagation: squared-distance three-nn weights,
    [skip, upsampled], the fuse conv, the residual blocks."""
    d2, idx = pn.three_nn_sq(xyz_dense, xyz_sparse)
    interp = pn.three_interpolate(up, idx, pn.interpolation_weights(d2))
    h = torch.relu(nn.linear(p["fuse"], torch.cat([skip, interp], dim=-1)))
    return _res_stack_ref(p["extraction"], h)


POINTMLP_REDUCERS = (4, 4, 4, 4)
POINTMLP_K = (16, 16, 16, 16)


def ref_pointmlp_forward(p: Params, xyz: torch.Tensor, points: int = 1024) -> torch.Tensor:
    """PointMLP: (B, N, 3) -> (B, N, 5 J). ``points`` is the constructor's
    (the stages' group counts come from it, not from N)."""
    return _pointmlp_trunk(p, xyz, torch.relu(nn.linear(p["embedding"], xyz)), points)


def ref_pointmlp_refine_forward(p: Params, xyz: torch.Tensor, feats: torch.Tensor,
                                points: int = 1024) -> torch.Tensor:
    """PointMLP_refine: the same trunk on (B, N, embed) features given in
    place of the embedding's."""
    return _pointmlp_trunk(p, xyz, feats, points)


def _pointmlp_trunk(p: Params, xyz: torch.Tensor, x: torch.Tensor, points: int) -> torch.Tensor:
    xyz_list, x_list = [xyz], [x]
    anchor_points, cur_xyz = points, xyz
    for i, (reduce, k) in enumerate(zip(POINTMLP_REDUCERS, POINTMLP_K)):
        anchor_points //= reduce
        cur_xyz, grouped = _local_grouper_ref(p["groupers"][i], cur_xyz, x_list[-1],
                                              anchor_points, k)
        h = torch.relu(nn.linear(p["pre"][i]["transfer"], grouped))
        h = torch.amax(_res_stack_ref(p["pre"][i]["blocks"], h), dim=2)
        xyz_list.append(cur_xyz)
        x_list.append(_res_stack_ref(p["pos"][i], h))
    xyz_rev, x_rev = xyz_list[::-1], x_list[::-1]
    h = x_rev[0]
    for i, dp in enumerate(p["decode"]):
        h = _fp_pointmlp_ref(dp, xyz_rev[i + 1], xyz_rev[i], x_rev[i + 1], h)
    gmps = [torch.amax(torch.relu(nn.linear(gp, xl)), dim=1)
            for gp, xl in zip(p["gmp_map"], x_rev)]
    gctx = torch.relu(nn.linear(p["gmp_end"], torch.cat(gmps, dim=-1)))
    h = torch.cat([h, gctx[:, None, :].expand(-1, h.shape[1], -1)], dim=-1)
    pf = torch.relu(nn.linear(p["conv"], h))
    return torch.cat([nn.linear(head, pf) for head in p["finals"]], dim=-1)
