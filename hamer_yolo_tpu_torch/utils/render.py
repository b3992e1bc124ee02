"""GL-free lit mesh rasterizer (port of hamer_yolo_tpu/utils/render.py) in
torch on the caller's device.

A lit, z-buffered, anti-aliased mesh over a frame, the capability of the
reference's offscreen pyrender path: smooth area-weighted vertex normals,
projection through the real intrinsics K, Blinn-Phong shading per vertex
(ambient + Lambert diffuse + specular, the reference's LIGHT_BLUE),
perspective-correct barycentric interpolation per pixel, a z-buffer, and
ss x ss supersampling with a box filter for the anti-aliased alpha.

Numbers as the JAX package's numpy computes them: the vertex stage in the
dtype numpy promotes the vertices and K to (f32 for the pipeline's
meshes), the per-pixel stage in f64, with numpy's orders of summation
(np.add.at's face order for the normals, the supersamples row by row).
JAX draws the faces one after another with a strict ``<`` depth test, so a
pixel goes to the nearest face covering it, and of faces at the same depth
to the lowest face index. Here all (face, pixel) pairs of a chunk of faces
are tested at once and each pixel takes the least (depth, face index) of
the chunk, then replaces the buffer's face only where it is strictly
nearer, which picks the same face. Shading's dot products may differ from
numpy's BLAS in the last bit of an f64.
"""
from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np
import torch

LIGHT_BLUE = (0.65, 0.74, 0.86)  # the reference's mesh colour, RGB in [0, 1]
CHUNK_PAIRS = 1 << 21  # (face, pixel) pairs tested at once


def _device(vertices, device) -> torch.device:
    if device is not None:
        return torch.device(device)
    return vertices.device if isinstance(vertices, torch.Tensor) else torch.device("cpu")


def _tensor(a, device) -> torch.Tensor:
    return torch.as_tensor(a if isinstance(a, torch.Tensor) else np.asarray(a), device=device)


def _incidence(faces: np.ndarray, num_verts: int) -> np.ndarray:
    """(V, max degree) face indices of each vertex in np.add.at's order over
    faces[:, 0], then faces[:, 1], then faces[:, 2]; -1 pads."""
    verts = faces.T.reshape(-1)
    face_ids = np.tile(np.arange(len(faces)), 3)
    order = np.argsort(verts, kind="stable")
    counts = np.bincount(verts, minlength=num_verts)
    starts = np.concatenate([[0], np.cumsum(counts)[:-1]])
    slot = np.arange(len(order)) - np.repeat(starts, counts)
    table = np.full((num_verts, max(int(counts.max(initial=0)), 1)), -1, np.int64)
    table[verts[order], slot] = face_ids[order]
    return table


def vertex_normals(vertices, faces, device=None) -> torch.Tensor:
    """Smooth per-vertex normals, area-weighted face normals summed per
    vertex: vertices (V, 3), faces (F, 3) -> (V, 3) unit normals in the
    vertices' dtype."""
    dev = _device(vertices, device)
    v = _tensor(vertices, dev)
    f_np = np.asarray(faces.cpu() if isinstance(faces, torch.Tensor) else faces, np.int64)
    f = torch.as_tensor(f_np, device=dev)
    tri = v[f]
    a, b = tri[:, 1] - tri[:, 0], tri[:, 2] - tri[:, 0]
    fn = torch.stack([a[:, 1] * b[:, 2] - a[:, 2] * b[:, 1],
                      a[:, 2] * b[:, 0] - a[:, 0] * b[:, 2],
                      a[:, 0] * b[:, 1] - a[:, 1] * b[:, 0]], dim=-1)
    table = torch.as_tensor(_incidence(f_np, v.shape[0]), device=dev)
    fn_pad = torch.cat([fn, torch.zeros_like(fn[:1])])  # row -1: zero
    vn = torch.zeros_like(v)
    for j in range(table.shape[1]):
        vn = vn + fn_pad[table[:, j]]
    sq = vn * vn
    # the root in f64, rounded once: torch's vectorised f32 sqrt on the CPU
    # is not correctly rounded
    norm = torch.sqrt((sq[:, 0] + sq[:, 1] + sq[:, 2]).double()).to(vn.dtype)[:, None]
    return vn / torch.clamp(norm, min=1e-12)


def _shade(normals: torch.Tensor, view_dir: np.ndarray, base_rgb: np.ndarray,
           light_dir: np.ndarray, ambient: float, diffuse: float, specular: float,
           shininess: float) -> torch.Tensor:
    """Blinn-Phong of (N, 3) normals -> (N, 3) RGB in [0, 1], f64."""
    l = -light_dir  # toward the light
    h = l - view_dir
    h = h / np.maximum(np.linalg.norm(h), 1e-12)
    n = normals.double()
    ndotl = torch.clamp(n @ torch.as_tensor(l, device=n.device), min=0.0)
    ndoth = torch.clamp(n @ torch.as_tensor(h, device=n.device), min=0.0)
    base = torch.as_tensor(base_rgb, device=n.device)
    col = base * (ambient + diffuse * ndotl[:, None])
    col = col + specular * (ndoth[:, None] ** shininess)
    return torch.clamp(col, 0.0, 1.0)


def rasterize_mesh(vertices, faces, K, image_hw: Tuple[int, int],
                   base_color: Sequence[float] = LIGHT_BLUE,
                   light_dir: Sequence[float] = (0.25, -0.35, 0.9), ambient: float = 0.30,
                   diffuse: float = 0.65, specular: float = 0.35, shininess: float = 24.0,
                   ss: int = 2, backface_cull: bool = True, device=None
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """A camera-space mesh (vertices (V, 3), +z forward; faces (F, 3); K (3,
    3)) rendered at ``image_hw`` on ``device`` (default: the vertices'
    device, the CPU for numpy) -> (rgb (H, W, 3) in [0, 1], alpha (H, W),
    the supersampled coverage), f64 tensors."""
    dev = _device(vertices, device)
    H, W = int(image_hw[0]), int(image_hw[1])
    Hs, Ws = H * ss, W * ss
    ld = np.asarray(light_dir, np.float64)
    ld = ld / np.linalg.norm(ld)

    v = _tensor(vertices, dev)
    Kt = _tensor(K, dev)
    dt = torch.promote_types(v.dtype, Kt.dtype)
    z = torch.clamp(v[:, 2], min=1e-9)
    u = ((v[:, 0] / z).to(dt) * Kt[0, 0].to(dt) + Kt[0, 2].to(dt)) * ss
    w = ((v[:, 1] / z).to(dt) * Kt[1, 1].to(dt) + Kt[1, 2].to(dt)) * ss
    inv_z = 1.0 / z
    vcol = _shade(vertex_normals(v, faces, dev), np.array([0.0, 0.0, 1.0]),
                  np.asarray(base_color, np.float64), ld, ambient, diffuse, specular, shininess)

    f = torch.as_tensor(np.asarray(faces.cpu() if isinstance(faces, torch.Tensor) else faces,
                                   np.int64), device=dev)
    fu, fv, fiz, fcol = u[f], w[f], inv_z[f], vcol[f]
    area = ((fu[:, 1] - fu[:, 0]) * (fv[:, 2] - fv[:, 0])
            - (fu[:, 2] - fu[:, 0]) * (fv[:, 1] - fv[:, 0]))
    keep = area < -1e-12 if backface_cull else torch.abs(area) > 1e-12
    # each kept face's pixel box, as JAX's loop bounds it
    x0 = torch.clamp(torch.floor(fu.amin(1)), min=0).long()
    x1 = torch.clamp(torch.ceil(fu.amax(1)).long() + 1, max=Ws)
    y0 = torch.clamp(torch.floor(fv.amin(1)), min=0).long()
    y1 = torch.clamp(torch.ceil(fv.amax(1)).long() + 1, max=Hs)
    keep &= (x0 < x1) & (y0 < y1)
    order = torch.nonzero(keep).flatten()
    nx, ny = (x1 - x0)[order], (y1 - y0)[order]
    pairs = (nx * ny).cpu().numpy()

    zbuf = torch.full((Hs * Ws,), float("inf"), dtype=torch.float64, device=dev)
    cbuf = torch.zeros((Hs * Ws, 3), dtype=torch.float64, device=dev)
    mask = torch.zeros(Hs * Ws, dtype=torch.bool, device=dev)
    start = 0
    while start < len(order):
        stop = start + max(int(np.searchsorted(np.cumsum(pairs[start:]), CHUNK_PAIRS,
                                               side="right")), 1)
        _draw_chunk(order[start:stop], nx[start:stop], ny[start:stop], x0, y0, fu, fv, area,
                    fiz, fcol, Ws, zbuf, cbuf, mask)
        start = stop

    # box filter in numpy's order of summation: the coverage is the alpha
    c = cbuf.reshape(H, ss, W, ss, 3)
    m = mask.reshape(H, ss, W, ss).double()
    rgb, alpha = c[:, 0, :, 0], m[:, 0, :, 0]
    for i in range(ss):
        for j in range(ss):
            if i or j:
                rgb, alpha = rgb + c[:, i, :, j], alpha + m[:, i, :, j]
    rgb, alpha = rgb / (ss * ss), alpha / (ss * ss)
    return torch.where(alpha[..., None] > 0, rgb / torch.where(alpha > 0, alpha, 1.0)[..., None],
                       rgb), alpha


def _draw_chunk(fi, nx, ny, x0, y0, fu, fv, area, fiz, fcol, Ws, zbuf, cbuf, mask) -> None:
    """Test every pixel of each face's box in ``fi`` and update the buffers."""
    dev = fi.device
    counts = nx * ny
    rep = torch.repeat_interleave(torch.arange(len(fi), device=dev), counts)
    local = torch.arange(len(rep), device=dev) - (torch.cumsum(counts, 0) - counts)[rep]
    face = fi[rep]
    pxi = x0[face] + local % nx[rep]
    pyi = y0[face] + local // nx[rep]
    px, py = pxi.double() + 0.5, pyi.double() + 0.5
    u, v = fu[face].double(), fv[face].double()
    a = area[face].double()
    w0 = ((u[:, 1] - px) * (v[:, 2] - py) - (u[:, 2] - px) * (v[:, 1] - py)) / a
    w1 = ((u[:, 2] - px) * (v[:, 0] - py) - (u[:, 0] - px) * (v[:, 2] - py)) / a
    w2 = 1.0 - w0 - w1
    inside = (w0 >= 0) & (w1 >= 0) & (w2 >= 0)
    face, w0, w1, w2 = face[inside], w0[inside], w1[inside], w2[inside]
    pix = (pyi * Ws + pxi)[inside]
    iz = fiz[face].double()
    depth = 1.0 / torch.clamp(w0 * iz[:, 0] + w1 * iz[:, 1] + w2 * iz[:, 2], min=1e-12)
    mask[pix] = True
    # the chunk's nearest face a pixel, ties to the lowest face index ...
    near = torch.full_like(zbuf, float("inf")).scatter_reduce(0, pix, depth, "amin")
    tie = depth == near[pix]
    first = torch.full(zbuf.shape, len(fu), dtype=torch.long, device=dev).scatter_reduce(
        0, pix[tie], face[tie], "amin")
    win = tie & (face == first[pix])
    # ... replaces the buffer's only where strictly nearer (earlier faces win ties)
    win[win.clone()] = depth[win] < zbuf[pix[win]]
    face, pix, depth = face[win], pix[win], depth[win]
    c = fcol[face]
    cw = ((w0[win, None] * c[:, 0]) * iz[win, 0:1] + (w1[win, None] * c[:, 1]) * iz[win, 1:2]
          + (w2[win, None] * c[:, 2]) * iz[win, 2:3]) * depth[:, None]
    zbuf[pix] = depth
    cbuf[pix] = cw


def lit_mesh_overlay(image_bgr, vertices, faces, K, base_color: Sequence[float] = LIGHT_BLUE,
                     alpha_scale: float = 1.0, device=None, **kwargs) -> np.ndarray:
    """A lit, anti-aliased render of the mesh blended onto a BGR frame,
    alpha * rgb + (1 - alpha) * image (the reference's composite), computed
    on ``device`` (see rasterize_mesh) -> (H, W, 3) uint8 numpy."""
    dev = _device(vertices, device)
    rgb, alpha = rasterize_mesh(vertices, faces, K, image_bgr.shape[:2], base_color=base_color,
                                device=dev, **kwargs)
    a = (alpha * alpha_scale)[..., None]
    out = a * (rgb.flip(-1) * 255.0) + (1.0 - a) * _tensor(image_bgr, dev).double()
    return torch.clamp(out, 0, 255).to(torch.uint8).cpu().numpy()


def render_rgba(vertices, faces, K, image_hw: Tuple[int, int], device=None,
                **kwargs) -> np.ndarray:
    """(H, W, 4) float RGBA render on a transparent background, numpy f64."""
    rgb, alpha = rasterize_mesh(vertices, faces, K, image_hw, device=device, **kwargs)
    return torch.cat([rgb, alpha[..., None]], dim=-1).cpu().numpy()
