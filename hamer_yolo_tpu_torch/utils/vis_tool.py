"""Per-dataset hand topologies and debug drawings of poses, point clouds,
meshes and heatmaps (port of hamer_yolo_tpu/utils/vis_tool.py), headless.

- The skeleton of each dataset (hands/FHAD, nyu, nyu_all, icvl, msra, itop,
  shrec/DHG, mano, smplerx) with its bone and joint colours, one table a
  dataset (``get_sketch_setting``, ``get_sketch_color``,
  ``get_joint_color``).
- 2D drawings with cv2: ``draw_point``, ``draw_pose``; ``draw_pcl``
  rasterises normalised point clouds, ``debug_pcl_pose`` writes one PNG a
  sample with the pose over it.
- matplotlib figures on the Agg canvas, returned as RGB arrays (and saved
  where asked): ``vis_3d_skeleton``, ``draw_mesh``; ``heatmap_overlay``
  blends jet-coloured joint heatmaps over a crop; ``tile_batch_images``
  tiles a batch of debug images.

Host code on numpy, cv2 and matplotlib, as in the JAX package, so a drawing
is the JAX package's pixel for pixel. cv2 and matplotlib are imported inside
the functions: the package imports where they are missing, and a drawing
there raises ImportError.
"""
from __future__ import annotations

import os
from typing import List, Optional, Sequence, Tuple

import numpy as np

Color = Tuple[int, int, int]

# BGR palette (reference vis_tool.py Color:200 / Finger_color:210).
THUMB: Color = (0, 0, 255)
INDEX: Color = (75, 255, 66)
MIDDLE: Color = (255, 0, 0)
RING: Color = (17, 240, 244)
LITTLE: Color = (255, 255, 0)
WRIST: Color = (255, 0, 255)
ROOT: Color = (255, 0, 255)
_RED, _GREEN, _BLUE = (0, 0, 255), (75, 255, 66), (255, 0, 0)
_YELLOW, _PURPLE, _CYAN, _BROWN = (204, 153, 17), (255, 255, 0), (255, 0, 255), (204, 153, 17)

_FINGERS = (THUMB, INDEX, MIDDLE, RING, LITTLE)


def _rep(colors_and_counts) -> Tuple[Color, ...]:
    out: List[Color] = []
    for c, n in colors_and_counts:
        out.extend([c] * n)
    return tuple(out)


# Per-dataset skeleton spec: (edges, edge_colors, joint_colors).
# Edge lists are the reference's get_sketch_setting tables verbatim (they
# ARE the parity target); the color sequences reproduce get_sketch_color /
# get_joint_color through the per-finger run-length form.
_SPECS = {
    # 21-joint hands topology (FHAD / *hands* datasets): wrist -> 5 MCPs,
    # then 3-bone chains per finger.
    "hands": (
        ((0, 1), (0, 2), (0, 3), (0, 4), (0, 5),
         (1, 6), (6, 7), (7, 8),
         (2, 9), (9, 10), (10, 11),
         (3, 12), (12, 13), (13, 14),
         (4, 15), (15, 16), (16, 17),
         (5, 18), (18, 19), (19, 20)),
        _FINGERS + _rep([(c, 3) for c in _FINGERS]),
        (ROOT,) + _FINGERS + _rep([(c, 3) for c in _FINGERS]),
    ),
    "nyu": (
        ((0, 1), (2, 3), (4, 5), (6, 7), (8, 9), (9, 10), (1, 13),
         (3, 13), (5, 13), (7, 13), (10, 13), (11, 13), (12, 13)),
        (LITTLE, RING, MIDDLE, INDEX, THUMB, THUMB,
         LITTLE, RING, MIDDLE, INDEX, THUMB, THUMB, WRIST, WRIST),
        _rep([(LITTLE, 2), (RING, 2), (MIDDLE, 2), (INDEX, 2), (THUMB, 3),
              (WRIST, 3)]),
    ),
    "nyu_all": (
        ((0, 1), (1, 2), (2, 3),
         (4, 5), (5, 6), (6, 7),
         (8, 9), (9, 10), (10, 11),
         (12, 13), (13, 14), (14, 15),
         (16, 17), (17, 18), (18, 19),
         (3, 20), (7, 20), (11, 20), (15, 20), (19, 20),
         (20, 21), (20, 22)),
        _rep([(LITTLE, 3), (RING, 3), (MIDDLE, 3), (INDEX, 3), (THUMB, 3)])
        + (LITTLE, RING, MIDDLE, INDEX, THUMB, THUMB, WRIST, WRIST),
        _rep([(LITTLE, 4), (RING, 4), (MIDDLE, 4), (INDEX, 4), (THUMB, 4),
              (WRIST, 3)]),
    ),
    "icvl": (
        ((0, 1), (1, 2), (2, 3), (0, 4), (4, 5), (5, 6),
         (0, 7), (7, 8), (8, 9), (0, 10), (10, 11), (11, 12),
         (0, 13), (13, 14), (14, 15)),
        _rep([(c, 3) for c in _FINGERS]),
        (ROOT,) + _rep([(c, 3) for c in _FINGERS]),
    ),
    "msra": (
        ((0, 1), (1, 2), (2, 3), (3, 4), (0, 5), (5, 6), (6, 7), (7, 8),
         (0, 9), (9, 10), (10, 11), (11, 12), (0, 13), (13, 14), (14, 15),
         (15, 16), (0, 17), (17, 18), (18, 19), (19, 20)),
        _rep([(INDEX, 4), (MIDDLE, 4), (RING, 4), (LITTLE, 4), (THUMB, 4)]),
        (WRIST,) + _rep([(INDEX, 4), (MIDDLE, 4), (RING, 4), (LITTLE, 4),
                         (THUMB, 4)]),
    ),
    "itop": (
        ((0, 1),
         (1, 2), (2, 4), (4, 6),
         (1, 3), (3, 5), (5, 7),
         (1, 8),
         (8, 9), (9, 11), (11, 13),
         (8, 10), (10, 12), (12, 14)),
        (_RED,) + _rep([(_GREEN, 3), (_BLUE, 3)]) + (_CYAN,)
        + _rep([(_YELLOW, 3), (_PURPLE, 3)]),
        (_RED, _BROWN, _GREEN, _BLUE, _GREEN, _BLUE, _GREEN, _BLUE, _CYAN,
         _YELLOW, _PURPLE, _YELLOW, _PURPLE, _YELLOW, _PURPLE),
    ),
    "shrec": (
        ((0, 1),
         (0, 2), (2, 3), (3, 4), (4, 5),
         (0, 6), (6, 7), (7, 8), (8, 9),
         (0, 10), (10, 11), (11, 12), (12, 13),
         (0, 14), (14, 15), (15, 16), (16, 17),
         (0, 18), (18, 19), (19, 20), (20, 21)),
        (ROOT,) + _rep([(c, 4) for c in _FINGERS]),
        (ROOT, ROOT) + _rep([(c, 4) for c in _FINGERS]),
    ),
    # MANO 21-joint ordering (wrist, I1-3, M1-3, L1-3, R1-3, T1-3, tips).
    "mano": (
        ((0, 13), (13, 14), (14, 15), (15, 20),
         (0, 1), (1, 2), (2, 3), (3, 16),
         (0, 4), (4, 5), (5, 6), (6, 17),
         (0, 10), (10, 11), (11, 12), (12, 19),
         (0, 7), (7, 8), (8, 9), (9, 18)),
        _rep([(c, 4) for c in _FINGERS]),
        (ROOT,) + _rep([(INDEX, 3), (MIDDLE, 3), (LITTLE, 3), (RING, 3),
                        (THUMB, 3)])
        + (INDEX, MIDDLE, LITTLE, RING, THUMB),
    ),
    "smplerx": (
        ((0, 13), (13, 14), (14, 15), (15, 20),
         (0, 1), (1, 2), (2, 3), (3, 16),
         (0, 4), (4, 5), (5, 6), (6, 17),
         (0, 10), (10, 11), (11, 12), (12, 19),
         (0, 7), (7, 8), (8, 9), (9, 18)),
        _rep([(c, 4) for c in _FINGERS]),
        _rep([(c, 4) for c in _FINGERS]),
    ),
}


def _spec_key(dataset: str) -> str:
    # Reference dispatch order (vis_tool.py:90,105,220,287): FHAD / any
    # name containing "hands" first, then exact names, then MANO default.
    if dataset == "FHAD" or "hands" in dataset:
        return "hands"
    if dataset == "shrec" or "DHG" in dataset:
        return "shrec"
    if dataset in _SPECS:
        return dataset
    return "mano"


def get_sketch_setting(dataset: str) -> Tuple[Tuple[int, int], ...]:
    return _SPECS[_spec_key(dataset)][0]


def get_sketch_color(dataset: str) -> Tuple[Color, ...]:
    return _SPECS[_spec_key(dataset)][1]


def get_joint_color(dataset: str) -> Tuple[Color, ...]:
    key = _spec_key(dataset)
    # get_joint_color has no itop-style smplerx/sketch split beyond the
    # shared table; mirror of the reference's else-branch default.
    return _SPECS[key][2]


def draw_point(dataset: str, img: np.ndarray, pose: np.ndarray) -> np.ndarray:
    """All joints as radius-3 dots in the dataset's first joint color."""
    import cv2

    color = get_joint_color(dataset)[0]
    for pt in np.asarray(pose):
        cv2.circle(img, (int(pt[0]), int(pt[1])), 3, color, -1)
    return img


def draw_pose(dataset: str, img: np.ndarray, pose: np.ndarray,
              scale: int = 1) -> np.ndarray:
    """Per-joint colored dots + per-bone colored skeleton lines.

    Pixel-parity with reference draw_pose:362 (joint loop capped at the
    palette length; edge loop stops at the first edge referencing a joint
    beyond ``pose``).
    """
    import cv2

    pose = np.asarray(pose)
    joint_colors = get_joint_color(dataset)
    for idx, pt in enumerate(pose[: len(joint_colors)]):
        cv2.circle(img, (int(pt[0]), int(pt[1])), 2 * scale,
                   joint_colors[idx], -1)
    edge_colors = get_sketch_color(dataset)
    for idx, (a, b) in enumerate(get_sketch_setting(dataset)):
        if a >= pose.shape[0] or b >= pose.shape[0]:
            break
        cv2.line(img, (int(pose[a, 0]), int(pose[a, 1])),
                 (int(pose[b, 0]), int(pose[b, 1])), edge_colors[idx],
                 1 * scale)
    return img


def draw_pcl(pcl: np.ndarray, img_size: int,
             background_value: float = 1.0) -> np.ndarray:
    """Rasterize normalized [-1,1] point clouds to (B,1,S,S) scatter images.

    Reference draw_pcl:546 semantics (floor, clamp, hit value -1) with the
    python-per-image torch loop replaced by one batched numpy scatter.
    """
    pcl = np.asarray(pcl)
    B, N = pcl.shape[0], pcl.shape[1]
    img = np.full((B, img_size, img_size), background_value, np.float32)
    ix = np.clip(np.floor((pcl[..., 0] + 1) / 2 * img_size), 0,
                 img_size - 1).astype(np.int64)
    iy = np.clip(np.floor((pcl[..., 1] + 1) / 2 * img_size), 0,
                 img_size - 1).astype(np.int64)
    bi = np.broadcast_to(np.arange(B)[:, None], (B, N))
    img[bi, iy, ix] = -1.0
    return img[:, None]


def debug_pcl_pose(pcl: np.ndarray, joint_xyz: np.ndarray, index: int,
                   dataset: str, data_dir: str, name: str,
                   img_size: int = 128) -> List[str]:
    """Point-cloud scatter + projected pose overlay, one PNG per sample.

    Reference debug_pcl_pose:559 (same filenames ``{B*index+i}-{name}.png``);
    returns the written paths instead of nothing.
    """
    import cv2

    pcl = np.asarray(pcl)
    if pcl.shape[0] == 0:
        return []
    imgs = draw_pcl(pcl, img_size)
    joint_uvd = (np.asarray(joint_xyz) + 1) / 2 * img_size
    B = imgs.shape[0]
    paths = []
    os.makedirs(data_dir, exist_ok=True)
    for i in range(B):
        gray = ((imgs[i, 0] + 1) / 2 * 255).astype(np.float32)
        im_color = cv2.cvtColor(gray, cv2.COLOR_GRAY2RGB)
        img_show = draw_pose(dataset, im_color, joint_uvd[i])
        path = os.path.join(data_dir, f"{B * index + i}-{name}.png")
        cv2.imwrite(path, img_show)
        paths.append(path)
    return paths


def _fig_to_rgb(fig) -> np.ndarray:
    fig.canvas.draw()
    buf = np.asarray(fig.canvas.buffer_rgba())
    return buf[..., :3].copy()


def vis_3d_skeleton(kpt_3d: np.ndarray, kpt_3d_vis: np.ndarray,
                    kps_lines: Sequence[Tuple[int, int]],
                    title: Optional[str] = None,
                    out: Optional[str] = None) -> np.ndarray:
    """3D skeleton plot in the reference's (x, z, -y) screen convention.

    Reference vis_3d_skeleton:717; renders on the Agg canvas and returns
    the RGB array (optionally also saved to ``out``) instead of blocking
    on plt.show()/cv2.waitKey.
    """
    import matplotlib
    matplotlib.use("Agg", force=False)
    import matplotlib.pyplot as plt

    kpt_3d = np.asarray(kpt_3d)
    kpt_3d_vis = np.asarray(kpt_3d_vis)
    if kpt_3d_vis.ndim == 1:
        kpt_3d_vis = kpt_3d_vis[:, None]

    fig = plt.figure()
    ax = fig.add_subplot(111, projection="3d")
    cmap = plt.get_cmap("rainbow")
    cols = [cmap(i)[:3] for i in np.linspace(0, 1, len(kps_lines) + 2)]
    for li, (i1, i2) in enumerate(kps_lines):
        c = cols[li]
        if kpt_3d_vis[i1, 0] > 0 and kpt_3d_vis[i2, 0] > 0:
            ax.plot(kpt_3d[[i1, i2], 0], kpt_3d[[i1, i2], 2],
                    -kpt_3d[[i1, i2], 1], c=c, linewidth=2)
        for j in (i1, i2):
            if kpt_3d_vis[j, 0] > 0:
                ax.scatter(kpt_3d[j, 0], kpt_3d[j, 2], -kpt_3d[j, 1],
                           c=[c], marker="o")
    ax.set_title(title or "3D vis")
    ax.set_xlabel("X Label")
    ax.set_ylabel("Z Label")
    ax.set_zlabel("Y Label")
    rgb = _fig_to_rgb(fig)
    if out:
        fig.savefig(out, bbox_inches="tight")
    plt.close(fig)
    return rgb


def cam_equal_aspect_3d(ax, verts: np.ndarray, flip_x: bool = False,
                        transpose: bool = True) -> None:
    """Center the 3D view on the verts' bounding cube (reference :872)."""
    verts = np.asarray(verts)
    extents = np.stack([verts.min(0), verts.max(0)], axis=1)
    sz = extents[:, 1] - extents[:, 0]
    centers = extents.mean(axis=1)
    r = max(abs(sz)) / 2
    if flip_x:
        ax.set_xlim(centers[0] + r, centers[0] - r)
    else:
        ax.set_xlim(centers[0] - r, centers[0] + r)
    ax.set_ylim(centers[1] - r, centers[1] + r)
    ax.set_zlim(centers[2] + r, centers[2] - r)
    ax.set_xlabel("X")
    ax.set_ylabel("Z" if transpose else "Y")
    ax.set_zlabel("Y" if transpose else "Z")
    ax.view_init(5, -85)


def draw_mesh(verts: np.ndarray, faces: np.ndarray, path: Optional[str] = None,
              transpose: bool = True, with_axis: bool = True) -> np.ndarray:
    """Matplotlib Poly3DCollection wireframe mesh plot.

    Covers reference draw_mesh:909 (axes, saved figure) and
    draw_mesh_without_axis:930 (``with_axis=False``: transparent faces,
    no axes, RGBA-equivalent output); returns the rendered RGB array.
    """
    import matplotlib
    matplotlib.use("Agg", force=False)
    import matplotlib.pyplot as plt
    from mpl_toolkits.mplot3d.art3d import Poly3DCollection

    verts = np.asarray(verts, np.float64)
    faces = np.asarray(faces).astype(int)
    if transpose:
        verts = verts[:, [0, 2, 1]]
    fig = plt.figure()
    ax = fig.add_subplot(111, projection="3d")
    mesh = Poly3DCollection(verts[faces], alpha=0.3)
    if with_axis:
        mesh.set_facecolor((141 / 255, 184 / 255, 226 / 255))
        mesh.set_edgecolor((50 / 255, 50 / 255, 50 / 255))
    else:
        mesh.set_facecolor((1, 1, 1, 0))
        mesh.set_edgecolor((0, 0, 0))
    ax.add_collection3d(mesh)
    cam_equal_aspect_3d(ax, verts, transpose=transpose)
    if not with_axis:
        ax.axis("off")
        fig.patch.set_alpha(0.0)
    rgb = _fig_to_rgb(fig)
    if path:
        fig.savefig(path, bbox_inches="tight", pad_inches=0)
    plt.close(fig)
    return rgb


def heatmap_overlay(img: np.ndarray, heatmap: np.ndarray, size: int,
                    normalize: bool = True) -> np.ndarray:
    """Jet-colormapped joint heatmaps blended over a grayscale crop.

    Reference debug_img_heatmap:382 / debug_2d_heatmap:408 math (per-map
    min/max normalize, ``jet(1 - h)`` color, ``img/2 + color``) with the
    per-(sample, joint) python loop replaced by one vectorized pass.

    DELIBERATE divergences from the reference: (1) the base image is
    resized to (size, size) — the reference interpolates it to the
    heatmap's own (h, w) and would broadcast-fail unless h == size; this
    is the sane fix, not the reference math. (2) colors come from
    matplotlib's jet sliced ``[..., :3]``, i.e. RGB channel order (the
    reference blends BGR via cv2); returns (B, J, size, size, 3) float
    images in that RGB-jet-over-gray convention.

    img: (B, H, W) grayscale in [-1, 1] or None-able by passing zeros;
    heatmap: (B, J, h, w).
    """
    import cv2
    import matplotlib
    matplotlib.use("Agg", force=False)
    import matplotlib.pyplot as plt

    heatmap = np.asarray(heatmap, np.float32)
    B, J, h, w = heatmap.shape
    if normalize:
        flat = heatmap.reshape(B, J, -1)
        flat = flat - flat.min(-1, keepdims=True)
        flat = flat / (flat.max(-1, keepdims=True) + 1e-8)
        heatmap = flat.reshape(B, J, h, w)
    jet = plt.get_cmap("jet")
    out = np.empty((B, J, size, size, 3), np.float32)
    img = np.asarray(img, np.float32)
    for b in range(B):
        base = cv2.resize(img[b], (size, size), interpolation=cv2.INTER_LINEAR)
        base = (base + 1) / 2 * 255
        base_rgb = cv2.cvtColor(base, cv2.COLOR_GRAY2RGB) / 2
        for j in range(J):
            hm = cv2.resize(heatmap[b, j], (size, size))
            color = 255 * jet(1 - hm)[..., :3]
            out[b, j] = base_rgb + color
    return out


def tile_batch_images(img_list: Sequence[np.ndarray], max_col: int = 7,
                      text: Optional[str] = None) -> np.ndarray:
    """Hstack/vstack a list of same-shape debug images into one canvas.

    Reference draw_muti_pic:581 per-sample grid (rows of ``max_col``).
    """
    import cv2

    if not img_list:
        raise ValueError("tile_batch_images: img_list is empty")
    rows = []
    for i in range(0, len(img_list), max_col):
        chunk = [np.asarray(im) for im in img_list[i:i + max_col]]
        while len(chunk) < min(max_col, len(img_list)) and len(img_list) > max_col:
            chunk.append(np.zeros_like(chunk[0]))
        rows.append(np.hstack(chunk))
    canvas = rows[0] if len(rows) == 1 else np.concatenate(rows, axis=0)
    if text:
        canvas = canvas.copy()
        cv2.putText(canvas, text, (15, 15), cv2.FONT_HERSHEY_COMPLEX, 0.5,
                    (100, 200, 200), 1)
    return canvas
