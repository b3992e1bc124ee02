"""PointNet++ point-cloud ops on tensors (port of hamer_yolo_tpu/ops/pointnet.py).

The reference implements these as native CUDA ops (pointnet2_ops _ext-src:
sampling, ball query, grouping, three_nn / three_interpolate); the JAX
package rewrote them as plain array programs, with no Pallas kernel, and
they are plain tensor ops here too:
- ``furthest_point_sampling``: the sequential max-min scan from point 0,
  one dense (B, N) distance update a step, the first index of the maximum;
- ``ball_query``: the first ``nsample`` in-radius indices in index order,
  empty slots repeating the first, all zeros where a ball is empty;
- ``gather_points`` / ``group_points``: gathers;
- ``three_nn`` / ``three_interpolate``: top-3 nearest and inverse-distance
  weighting.

Coordinates are (B, N, 3), point-last. Index outputs are int64 (torch's
gather index type); JAX's are int32 with the same values.

Every index choice is deterministic and device-independent given the same
coordinates. A squared distance is the chain of fused multiply-adds that
both the reference's CUDA kernels (nvcc contracts dx*dx + dy*dy + dz*dz) and
XLA's compiled reduction compute, fma(dz, dz, fma(dy, dy, dx * dx)), each
step rounded once to f32 (``sqsum3``: the exact product and sum in f64, then
f32; they differ from a true fma only where the f64 sum itself rounds onto
an f32 midpoint, a 2^-28 chance a step); no reduction order is left to a
device. Nearest-k is a stable sort (ties to the lower index, as
``lax.top_k`` orders them), and ``ball_query`` keys each in-radius point by
its own index, so the k smallest keys are unique.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np
import torch


def sqsum3(d: torch.Tensor) -> torch.Tensor:
    """(..., 3) f32 -> (...,) fma(d2, d2, fma(d1, d1, d0 * d0)), each step
    rounded to f32 once; (..., C) features take the same chain over their C
    components in order."""
    x = d.double()
    acc = (x[..., 0] * x[..., 0]).float()
    for i in range(1, d.shape[-1]):
        acc = (x[..., i] * x[..., i] + acc.double()).float()
    return acc


def pairwise_sqdist(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(..., N, C) x (..., M, C) -> (..., N, M) squared distances."""
    return sqsum3(a[..., :, None, :] - b[..., None, :, :])


def smallest_k(d: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """(values, indices) of the ``k`` smallest entries along the last axis,
    ascending, ties to the lower index (``lax.top_k(-d, k)``'s order), -0
    and +0 tied too where lax.top_k takes -0 first (squared distances from
    sqsum3 are never -0)."""
    vals, idx = torch.sort(d, dim=-1, stable=True)
    return vals[..., :k], idx[..., :k]


def furthest_point_sampling(xyz: torch.Tensor, npoint: int) -> torch.Tensor:
    """(B, N, 3) -> (B, npoint) indices; starts from point 0 (the CUDA
    kernel's seed)."""
    B, N, _ = xyz.shape
    min_dist = torch.full((B, N), float("inf"), dtype=xyz.dtype, device=xyz.device)
    last = torch.zeros(B, dtype=torch.long, device=xyz.device)
    out = [last]
    for _ in range(npoint - 1):
        p = torch.gather(xyz, 1, last[:, None, None].expand(B, 1, 3))  # (B, 1, 3)
        min_dist = torch.minimum(min_dist, sqsum3(xyz - p))
        last = torch.argmax(min_dist, dim=-1)  # the first index of the maximum
        out.append(last)
    return torch.stack(out, dim=1)


def ball_query(new_xyz: torch.Tensor, xyz: torch.Tensor, radius: float,
               nsample: int) -> torch.Tensor:
    """(B, S, 3) centers, (B, N, 3) points -> (B, S, nsample) indices.

    The first ``nsample`` points (in index order) with squared distance
    below radius^2 (radius^2 rounded in f32, as JAX squares its f32
    radius); the remaining slots repeat the FIRST in-radius index; a center
    with no in-radius point gets all zeros."""
    N = xyz.shape[1]
    r2 = float(np.float32(radius) * np.float32(radius))
    in_r = pairwise_sqdist(new_xyz, xyz) < r2                     # (B, S, N)
    order = torch.arange(N, device=xyz.device)
    key = torch.where(in_r, order, N)
    first_k = torch.topk(key, nsample, dim=-1, largest=False, sorted=True).values
    idx = torch.where(first_k < N, first_k, first_k[..., :1])
    return torch.where(first_k[..., :1] < N, idx, 0)


def gather_points(points: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """(B, N, C), (B, S) -> (B, S, C)."""
    C = points.shape[-1]
    return torch.gather(points, 1, idx.long()[..., None].expand(*idx.shape, C))


def group_points(points: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """(B, N, C), (B, S, K) -> (B, S, K, C)."""
    B, S, K = idx.shape
    return gather_points(points, idx.reshape(B, S * K)).reshape(B, S, K, -1)


def three_nn_sq(unknown: torch.Tensor, known: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(B, n, 3), (B, m, 3) -> (SQUARED dists (B, n, 3), idx (B, n, 3)): the
    flavour whose weights take raw d2 (the reference's pure-torch utils)."""
    d2, idx = smallest_k(pairwise_sqdist(unknown, known), 3)
    return torch.clamp(d2, min=0.0), idx


def three_nn(unknown: torch.Tensor, known: torch.Tensor
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(B, n, 3), (B, m, 3) -> (dists (B, n, 3), idx (B, n, 3))."""
    d2, idx = three_nn_sq(unknown, known)
    return torch.sqrt(d2), idx


def three_interpolate(points: torch.Tensor, idx: torch.Tensor,
                      weight: torch.Tensor) -> torch.Tensor:
    """(B, m, C) features, (B, n, 3) idx, (B, n, 3) weights -> (B, n, C)."""
    return torch.sum(group_points(points, idx) * weight[..., None], dim=2)


def interpolation_weights(dists: torch.Tensor, eps: float = 1e-8) -> torch.Tensor:
    """Inverse-distance weights (pointnet2_utils FeaturePropagation)."""
    recip = 1.0 / (dists + eps)
    return recip / torch.sum(recip, dim=-1, keepdim=True)


def query_and_group(xyz: torch.Tensor, new_xyz: torch.Tensor, features: torch.Tensor,
                    radius: float, nsample: int, use_xyz: bool = True) -> torch.Tensor:
    """QueryAndGroup: ball query + relative-xyz concat.

    xyz (B, N, 3), new_xyz (B, S, 3), features (B, N, C)
    -> (B, S, nsample, 3 + C) (or C only if not ``use_xyz``)."""
    idx = ball_query(new_xyz, xyz, radius, nsample)
    grouped_feat = group_points(features, idx)
    if not use_xyz:
        return grouped_feat
    grouped_xyz = group_points(xyz, idx) - new_xyz[:, :, None, :]
    return torch.cat([grouped_xyz, grouped_feat], dim=-1)
