"""RGB-D training data on the host (port of hamer_yolo_tpu/io/rgbd_datasets.py):
KeypointFusion's samples from a directory, in numpy, for
``training/train_kpfusion_rgbd``.

- Depth decoding to float32 mm: ``nyu`` (3-channel png, B + 256 G), ``ho3d``
  ((R + 256 G) * 0.00012498664727900177 * 1000), ``u16`` (a single-channel
  16-bit png in mm), ``npy`` (a float array in mm), ``auto`` (u16 for one
  channel, nyu for three).
- The fixture layout, for each stem: ``{stem}.png`` (RGB), ``{stem}_d.png``
  or ``_d.npy`` (depth), ``{stem}.txt`` (21 x 3 camera-frame joints in mm,
  the labels) and ``{stem}_bbox.txt`` (a box in image fractions, the hand's
  center where there are no joints).
- STB's layout: ``{seq}/SK_color_{i}.png`` + ``SK_depth_{i}.png`` with
  ``labels/{seq}_SK.mat`` (handPara (3, 21, N)).
- A sample: the center (the joints' mean, or the box's depth center of
  mass), crops of depth and RGB to the metric cube, the depth normalised to
  [-1, 1], xyz and uvd labels normalised by the cube, and the crop's point
  cloud sampled to ``sample_num`` points. With an augmentation Generator,
  one of rot / com / sc / none a sample (augmentCrop), applied alike to the
  depth, the RGB and the labels.

cv2 is imported only to read a file. The nearest warps, the rotation matrix
and Rodrigues are cv2's arithmetic in numpy (io/images.py), byte-equal to the
cv2 the JAX package calls. The point sampling draws from the caller's
``np.random.RandomState`` (the JAX package draws from numpy's global one),
in the JAX package's order: a RandomState(s) gives the points that
``np.random.seed(s)`` gives JAX. The augmentation and the shuffle draw from
a ``np.random.default_rng(seed)``, as in JAX.
"""
from __future__ import annotations

import math
import os
from dataclasses import dataclass
from typing import Dict, Iterator, List, Optional, Tuple

import numpy as np

from hamer_yolo_tpu_torch.io.images import (rodrigues, rotation_matrix_2d,
                                            warp_affine_nearest, warp_perspective_nearest)
from hamer_yolo_tpu_torch.models.kpfusion_rgbd.runtime import (
    com_to_bounds, crop_depth, crop_rgb, get_center_from_bbx, get_pcl, joint_img_to_3d,
    normalize_img, sample_pcl)

DEPTH_DECODERS = ("u16", "nyu", "ho3d", "npy", "auto")
HO3D_DEPTH_SCALE = 0.00012498664727900177
AUG_MODES = ("rot", "com", "sc", "none")
AUG_PARA = (10.0, 0.2, 180.0)  # sigma_com (mm), sigma_sc, rot_range (degrees)


def _imread(path: str, flags: Optional[int] = None) -> Optional[np.ndarray]:
    import cv2

    return cv2.imread(path) if flags is None else cv2.imread(path, flags)


def read_depth(path: str, fmt: str = "auto") -> np.ndarray:
    """A depth file -> float32 mm, by the conventions above."""
    if fmt not in DEPTH_DECODERS:
        raise ValueError(f"unknown depth format {fmt!r}; one of {DEPTH_DECODERS}")
    if path.endswith(".npy") or fmt == "npy":
        return np.load(path).astype(np.float32)
    import cv2

    img = _imread(path, cv2.IMREAD_ANYDEPTH | cv2.IMREAD_ANYCOLOR)
    if img is None:
        raise IOError(f"cannot read depth image {path}")
    if fmt == "auto":
        fmt = "u16" if img.ndim == 2 else "nyu"
    if fmt == "u16":
        if img.ndim != 2:
            raise ValueError(f"{path}: u16 depth must be single-channel")
        return img.astype(np.float32)
    if img.ndim != 3:
        raise ValueError(f"{path}: {fmt} depth must be 3-channel")
    b, g, r = img[..., 0], img[..., 1], img[..., 2]
    if fmt == "nyu":
        return b.astype(np.float32) + g.astype(np.float32) * 256.0
    return (r.astype(np.float32) + g.astype(np.float32) * 256.0) * HO3D_DEPTH_SCALE * 1000.0


def calculate_com(dpt: np.ndarray, min_depth: float, max_depth: float) -> np.ndarray:
    """The depth map's center of mass (u, v, z) over [min_depth, max_depth]."""
    from scipy import ndimage

    dc = dpt.copy()
    dc[dc < min_depth] = 0
    dc[dc > max_depth] = 0
    num = np.count_nonzero(dc)
    if num == 0:
        return np.array((300.0, 300.0, 500.0), np.float64)
    cc = ndimage.center_of_mass(dc > 0)
    return np.array((cc[1], cc[0], dc.sum() / num), np.float64)


def joint_3d_to_img(xyz: np.ndarray, paras, flip: float = 1.0) -> np.ndarray:
    """Camera xyz (mm) -> (u, v, z), float32."""
    fx, fy, fu, fv = paras
    ret = np.zeros_like(xyz, np.float32)
    ret[..., 0] = xyz[..., 0] * fx / xyz[..., 2] + fu
    ret[..., 1] = flip * xyz[..., 1] * fy / xyz[..., 2] + fv
    ret[..., 2] = xyz[..., 2]
    return ret


def _transform_points_2d(pts: np.ndarray, M: np.ndarray) -> np.ndarray:
    out = pts.copy()
    hom = np.concatenate([pts[:, :2], np.ones((pts.shape[0], 1))], axis=1)
    uv = (M @ hom.T).T
    out[:, :2] = uv[:, :2] / uv[:, 2:3]
    return out


def com_to_transform(com, size, dsize, paras) -> np.ndarray:
    """The crop matrix of a center and cube, without cropping."""
    xstart, xend, ystart, yend, _, _ = com_to_bounds(com, size, paras)
    trans = np.eye(3)
    trans[0, 2] = -xstart
    trans[1, 2] = -ystart
    wb, hb = (xend - xstart), (yend - ystart)
    if wb > hb:
        scale = np.eye(3) * dsize[0] / float(wb)
        sz = (dsize[0], hb * dsize[0] / wb)
    else:
        scale = np.eye(3) * dsize[1] / float(hb)
        sz = (wb * dsize[1] / hb, dsize[1])
    scale[2, 2] = 1
    off = np.eye(3)
    off[0, 2] = int(np.floor(dsize[0] / 2.0 - sz[0] / 2.0))
    off[1, 2] = int(np.floor(dsize[1] / 2.0 - sz[1] / 2.0))
    return off @ scale @ trans


def recrop_hand(crop: np.ndarray, M: np.ndarray, Mnew_inv: np.ndarray, target_size, paras,
                background: float = 0.0, nv_val: float = 0.0, thresh_z: bool = True, com=None,
                size=(250, 250, 250)) -> np.ndarray:
    """A crop warped under a new crop matrix (nearest, constant border), its
    depth thresholded again to the new cube."""
    warped = warp_perspective_nearest(crop, M @ Mnew_inv, tuple(target_size[:2]),
                                      float(background))
    if thresh_z:
        if com is None:
            raise ValueError("recrop_hand: thresh_z needs the center")
        warped[warped < nv_val] = background
        _, _, _, _, zstart, zend = com_to_bounds(com, size, paras)
        msk1 = np.logical_and(warped < zstart, warped != 0)
        msk2 = np.logical_and(warped > zend, warped != 0)
        warped[msk1] = zstart
        warped[msk2] = 0.0
    return warped


def rotate_points_2d(pts: np.ndarray, center, angle_deg: float) -> np.ndarray:
    """(N, 3) uvd rows rotated about ``center`` in the image plane."""
    a = angle_deg * np.pi / 180.0
    out = np.asarray(pts, np.float64).copy()
    uv = out[:, :2] - np.asarray(center[:2])
    rot = np.stack([uv[:, 0] * np.cos(a) - uv[:, 1] * np.sin(a),
                    uv[:, 0] * np.sin(a) + uv[:, 1] * np.cos(a)], 1)
    out[:, :2] = rot + np.asarray(center[:2])
    return out


def move_com(dpt, cube, com, off, joints3d, M, paras, pad_value=0.0, thresh_z=True):
    """The crop about a center moved by ``off`` mm."""
    if np.allclose(off, 0.0):
        return dpt, joints3d, com, M
    com3d = joint_img_to_3d(np.asarray(com, np.float64), paras)
    new_com = joint_3d_to_img(com3d + off, paras)
    if np.allclose(com[2], 0.0) or np.allclose(new_com[2], 0.0):
        return dpt, joints3d, com, M
    Mnew = com_to_transform(new_com, cube, dpt.shape, paras)
    nv = (np.min(dpt[dpt > 0]) - 1) if thresh_z and (dpt > 0).any() else -1.0
    new_dpt = recrop_hand(dpt.astype(np.float32), Mnew, np.linalg.inv(M), dpt.shape, paras,
                          background=pad_value, nv_val=nv, thresh_z=thresh_z, com=new_com,
                          size=cube)
    new_joints3d = joints3d + com3d - joint_img_to_3d(new_com, paras)
    return new_dpt, new_joints3d, new_com, Mnew


def rotate_hand(dpt, cube, com, rot, joints3d, paras, pad_value=0.0, thresh_z=True):
    """The crop and its labels rotated by ``rot`` degrees in the image plane."""
    if np.allclose(rot, 0.0):
        return dpt, joints3d, rot
    rot = np.mod(rot, 360)
    Mr = rotation_matrix_2d((dpt.shape[1] // 2, dpt.shape[0] // 2), -rot, 1)
    new_dpt = warp_affine_nearest(dpt, Mr, (dpt.shape[1], dpt.shape[0]), pad_value)
    if thresh_z and (dpt > 0).any():
        new_dpt[new_dpt < (np.min(dpt[dpt > 0]) - 1)] = 0
    com3d = joint_img_to_3d(np.asarray(com, np.float64), paras)
    joint_2d = joint_3d_to_img(joints3d + com3d, paras)
    data_2d = rotate_points_2d(joint_2d, com[:2], rot)
    new_joints3d = joint_img_to_3d(data_2d, paras) - com3d
    return new_dpt, new_joints3d, rot


def scale_hand(dpt, cube, com, sc, joints3d, M, paras, pad_value=0.0, thresh_z=True):
    """The crop under the cube scaled by ``sc`` (the labels unchanged)."""
    if np.allclose(sc, 1.0):
        return dpt, joints3d, cube, M
    new_cube = [s * sc for s in cube]
    if np.allclose(com[2], 0.0):
        return dpt, joints3d, new_cube, M
    Mnew = com_to_transform(com, new_cube, dpt.shape, paras)
    nv = (np.min(dpt[dpt > 0]) - 1) if thresh_z and (dpt > 0).any() else -1.0
    new_dpt = recrop_hand(dpt.astype(np.float32), Mnew, np.linalg.inv(M), dpt.shape, paras,
                          background=pad_value, nv_val=nv, thresh_z=thresh_z, com=com, size=cube)
    return new_dpt, joints3d, new_cube, Mnew


def rand_augment(rng: np.random.Generator, sigma_com: float = 10.0, sigma_sc: float = 0.2,
                 rot_range: float = 180.0):
    """(mode index into AUG_MODES, center offset mm (3,), rotation degrees,
    cube scale), drawn from ``rng``."""
    mode = int(rng.integers(0, len(AUG_MODES)))
    off = rng.uniform(-1, 1, 3) * sigma_com
    rot = float(rng.uniform(-rot_range, rot_range))
    sc = abs(1.0 + float(rng.uniform(-1, 1)) * sigma_sc)
    return mode, off, rot, sc


def augment_crop(img, gt3dcrop, com, cube, M, mode, off, rot, sc, paras, rgb: bool = False):
    """One augmentation of a depth crop (z-thresholded, then normalised with
    the maximum from before it) or, with ``rgb``, of an RGB crop (neither).
    Returns (img, joints mm about the center, cube, center, M, rot)."""
    name = AUG_MODES[mode]
    thresh_z = not rgb
    premax = img.max()
    cube = list(cube)
    com = np.asarray(com, np.float64)
    if not rgb and np.max(img) == 0:
        new_img, new_joints = img, gt3dcrop
    elif name == "com":
        new_img, new_joints, com, M = move_com(img.astype(np.float32), cube, com, off, gt3dcrop,
                                               M, paras, pad_value=0, thresh_z=thresh_z)
    elif name == "rot":
        new_img, new_joints, rot = rotate_hand(img.astype(np.float32), cube, com, rot, gt3dcrop,
                                               paras, pad_value=0, thresh_z=thresh_z)
    elif name == "sc":
        new_img, new_joints, cube, M = scale_hand(img.astype(np.float32), cube, com, sc,
                                                  gt3dcrop, M, paras, pad_value=0,
                                                  thresh_z=thresh_z)
    else:
        new_img, new_joints = img, gt3dcrop
    if not rgb:
        out = new_img.astype(np.float32).copy()
        hi = com[2] + cube[2] / 2.0
        lo = com[2] - cube[2] / 2.0
        out[out == premax] = hi
        out[out == 0] = hi
        out[out >= hi] = hi
        out[out <= lo] = lo
        new_img = (out - com[2]) / (cube[2] / 2.0)
    return new_img, new_joints, np.asarray(cube), com, M, rot


@dataclass(frozen=True)
class RGBDDatasetConfig:
    img_size: int = 128
    sample_num: int = 1024
    cube: Tuple[float, float, float] = (250.0, 250.0, 250.0)  # mm
    cam_para: Tuple[float, float, float, float] = (906.96, 906.79, 956.75, 547.23)  # 1920x1080
    depth_fmt: str = "auto"
    com_lower: float = 171.0            # get_center_from_bbx's depth range, mm
    com_upper: float = 1500.0
    joint_num: int = 21


def make_rgbd_sample(rgb: np.ndarray, depth: np.ndarray, cam, cube, img_size: int,
                     sample_num: int, pcl_rng: np.random.RandomState, joint_num: int = 21,
                     joints: Optional[np.ndarray] = None, bbox=None,
                     com_bounds: Tuple[float, float] = (171.0, 1500.0),
                     aug_rng: Optional[np.random.Generator] = None,
                     aug_para: Tuple[float, float, float] = AUG_PARA) -> Dict[str, np.ndarray]:
    """A decoded frame with camera joints in mm (or a bbox) -> a sample in the
    train step's schema; ``aug_rng`` takes the training path (augment_crop).
    The point cloud is sampled from ``pcl_rng``."""
    cube = np.asarray(cube, np.float32)
    # the labels are normalised by cube[2] and projected back with cube[0], as
    # the reference does: only a cube with cube[0] == cube[2] gives them right
    if cube[0] != cube[2]:
        raise ValueError(f"make_rgbd_sample requires cube[0] == cube[2] (got {cube}): "
                         "the reference's label normalization mixes those axes")
    S = img_size
    if joints is not None:
        center_xyz = joints.mean(0)
        center_uvd = joint_3d_to_img(center_xyz, cam)
    else:
        if bbox is None:
            raise ValueError("make_rgbd_sample: no joints and no bbox")
        center_uvd = get_center_from_bbx(depth, bbox, com_bounds[1], com_bounds[0])
        center_xyz = joint_img_to_3d(center_uvd, cam)

    depth_crop, M = crop_depth(depth, center_uvd, cube, (S, S), cam)
    rgb_crop, M_rgb = crop_rgb(rgb, center_uvd, cube, (S, S), cam)

    if aug_rng is not None:
        if joints is None:
            raise ValueError("augmentation needs joints")
        mode, off, rot, sc = rand_augment(aug_rng, *aug_para)
        gt3dcrop = (joints - center_xyz).astype(np.float64)
        cube0 = cube
        img_d, cur_label, cube, com2d, M, _ = augment_crop(depth_crop, gt3dcrop, center_uvd,
                                                           cube, M, mode, off, rot, sc, cam)
        rgb_aug = augment_crop(rgb_crop, gt3dcrop, center_uvd, cube0, M_rgb, mode, off, rot, sc,
                               cam, rgb=True)[0]
        rgb_crop = rgb_aug.astype(np.float32)
        com3d = joint_img_to_3d(com2d, cam)
        xyz_gt = cur_label / (cube[2] / 2.0)
    else:
        img_d = normalize_img(depth_crop, center_xyz, cube)
        com3d = joint_img_to_3d(center_uvd, cam)
        xyz_gt = None if joints is None else (joints - center_xyz) / (cube[2] / 2.0)

    if xyz_gt is not None:
        uvd = _transform_points_2d(joint_3d_to_img(xyz_gt * (cube[0] / 2.0) + com3d, cam), M)
        uvd[:, :2] = uvd[:, :2] / (S / 2.0) - 1.0
        uvd[:, 2] = (uvd[:, 2] - com3d[2]) / (cube[0] / 2.0)
    else:
        xyz_gt = np.zeros((joint_num, 3), np.float32)
        uvd = np.zeros((joint_num, 3), np.float32)

    pcl = sample_pcl(get_pcl(img_d, com3d, cube, M, cam), sample_num, pcl_rng)
    return {
        "img_rgb": rgb_crop.transpose(2, 0, 1) / 255.0,
        "img": img_d[None].astype(np.float32),
        "pcl": pcl.astype(np.float32),
        "uvd_gt": uvd.astype(np.float32),
        "xyz_gt": xyz_gt.astype(np.float32),
        "center": com3d.astype(np.float32),
        "M": M.astype(np.float32),
        "cube": np.asarray(cube, np.float32),
        "cam_para": np.asarray(cam, np.float32),
    }


@dataclass
class RGBDSample:
    stem: str
    rgb_path: str
    depth_path: str
    joints_path: Optional[str] = None
    bbox_path: Optional[str] = None


def scan_rgbd_dir(root: str) -> List[RGBDSample]:
    """The fixture layout's samples under ``root``, recursively, sorted."""
    samples: List[RGBDSample] = []
    for dirpath, _, files in sorted(os.walk(root)):
        names = set(files)
        for f in sorted(files):
            if not f.endswith("_d.png") and not f.endswith("_d.npy"):
                continue
            stem = f[:-len("_d.png")]
            rgb = stem + ".png"
            if rgb not in names:
                continue
            jp = stem + ".txt" if stem + ".txt" in names else None
            bp = stem + "_bbox.txt" if stem + "_bbox.txt" in names else None
            samples.append(RGBDSample(
                stem=stem, rgb_path=os.path.join(dirpath, rgb),
                depth_path=os.path.join(dirpath, f),
                joints_path=os.path.join(dirpath, jp) if jp else None,
                bbox_path=os.path.join(dirpath, bp) if bp else None))
    return samples


class RGBDDiskDataset:
    """Samples of fixed shape from a fixture-layout directory.

    ``require_labels`` (training) keeps the samples with a joints file; without
    it a bbox-only sample loads with zero labels, its center the box's depth
    center of mass. ``pcl_rng`` is the point sampling's RandomState, drawn
    from sample after sample."""

    def __init__(self, root: str, cfg: RGBDDatasetConfig = RGBDDatasetConfig(),
                 require_labels: bool = True, *, pcl_rng: np.random.RandomState):
        self.cfg = cfg
        self.pcl_rng = pcl_rng
        self.samples = [s for s in scan_rgbd_dir(root)
                        if (s.joints_path is not None) or not require_labels]
        if not self.samples:
            raise FileNotFoundError(
                f"no RGB-D samples ({'labeled ' if require_labels else ''}"
                f"{{stem}}.png + {{stem}}_d.png) under {root}")

    def __len__(self) -> int:
        return len(self.samples)

    def load(self, idx: int, aug_rng: Optional[np.random.Generator] = None,
             aug_para: Tuple[float, float, float] = AUG_PARA) -> Dict[str, np.ndarray]:
        """Sample ``idx`` in the train step's schema, without the batch axis;
        ``aug_rng`` draws one augmentation (needs joints)."""
        cfg = self.cfg
        s = self.samples[idx]
        rgb = _imread(s.rgb_path)
        if rgb is None:
            raise IOError(f"cannot read {s.rgb_path}")
        depth = read_depth(s.depth_path, cfg.depth_fmt)
        joints = bbox = None
        if s.joints_path is not None:
            joints = np.loadtxt(s.joints_path, dtype=np.float32).reshape(-1, 3)[:cfg.joint_num]
        elif s.bbox_path is not None:
            v = np.loadtxt(s.bbox_path).reshape(-1)[:4]
            H, W = depth.shape
            bbox = [v[0] * W - v[2] * W / 2, v[1] * H - v[3] * H / 2, v[2] * W, v[3] * H]
        else:
            raise ValueError(f"{s.stem}: no joints and no bbox")
        return make_rgbd_sample(rgb.astype(np.float32), depth, cfg.cam_para, cfg.cube,
                                cfg.img_size, cfg.sample_num, self.pcl_rng, cfg.joint_num,
                                joints=joints, bbox=bbox,
                                com_bounds=(cfg.com_lower, cfg.com_upper), aug_rng=aug_rng,
                                aug_para=aug_para)

    def batches(self, batch_size: int, shuffle: bool = True, seed: int = 0,
                drop_last: bool = False, augment: bool = False,
                aug_para: Tuple[float, float, float] = AUG_PARA
                ) -> Iterator[Dict[str, np.ndarray]]:
        """An epoch of stacked batches; a short last batch wraps around."""
        yield from _iter_batches(self, batch_size, shuffle, seed, drop_last, augment, aug_para)


def _iter_batches(dataset, batch_size: int, shuffle: bool, seed: int, drop_last: bool,
                  augment: bool, aug_para: Tuple[float, float, float]
                  ) -> Iterator[Dict[str, np.ndarray]]:
    """An epoch over any dataset with ``samples`` and ``load``: the shuffle and
    the augmentations from ``default_rng(seed)``, the short last batch
    filled by wrapping around (or dropped)."""
    rng = np.random.default_rng(seed)
    order = np.arange(len(dataset.samples))
    if shuffle:
        rng.shuffle(order)
    aug_rng = rng if augment else None
    n = len(order)
    steps = n // batch_size if drop_last else math.ceil(n / batch_size)
    for b in range(steps):
        idx = [order[(b * batch_size + i) % n] for i in range(batch_size)]
        items = [dataset.load(i, aug_rng=aug_rng, aug_para=aug_para) for i in idx]
        yield {k: np.stack([it[k] for it in items]) for k in items[0]}


# --- STB ----------------------------------------------------------------------

STB_CAM = (607.92271, 607.88192, 314.78337, 236.42484)  # the SK camera's intrinsics
STB_SK_ROT = (0.00531, -0.01196, 0.00301)               # its extrinsics: axis-angle
STB_SK_TRANS = (-24.0381, -0.4563, -1.2326)             # and mm
STB_CUBE = (200.0, 200.0, 200.0)


def read_depth_stb(path: str) -> np.ndarray:
    """STB's depth png -> float32 mm: R + 256 G."""
    img = _imread(path)
    if img is None:
        raise IOError(f"cannot read depth image {path}")
    return img[..., 2].astype(np.float32) + img[..., 1].astype(np.float32) * 256.0


def stb_convert_kp(keypoints: np.ndarray) -> np.ndarray:
    """STB's joint order -> the wrist, then the fingers reversed."""
    return keypoints[np.array([0] + list(range(20, 0, -1)))]


def stb_xyz_to_uvd(xyz: np.ndarray, K: np.ndarray, rot_mat: np.ndarray,
                   T: np.ndarray) -> np.ndarray:
    """Projected through the SK extrinsics; the d column keeps the original z."""
    uvd = (K @ (rot_mat.T @ (xyz.T - T.reshape(3, 1)))).T
    uvd = uvd / uvd[:, 2:3]
    return np.concatenate([uvd[:, :2], xyz[:, 2:3]], axis=1)


def preprocess_stb(uvd: np.ndarray) -> np.ndarray:
    """The reorder, and the palm center replaced by the wrist
    j16 + 2 (j0 - j16)."""
    uvd = stb_convert_kp(uvd)
    wrist = uvd[16] + 2.0 * (uvd[0] - uvd[16])
    return np.concatenate([wrist[None], uvd[1:]], axis=0)


@dataclass
class STBSample:
    seq: str
    frame: int
    rgb_path: str
    depth_path: str
    joints_xyz: np.ndarray  # (21, 3), mm


def scan_stb_dir(root: str) -> List[STBSample]:
    """STB's samples under ``root``: each ``labels/{seq}_SK.mat``'s frames
    whose colour and depth pngs are there."""
    import scipy.io as sio

    samples: List[STBSample] = []
    labels_dir = os.path.join(root, "labels")
    if not os.path.isdir(labels_dir):
        return samples
    for mat in sorted(os.listdir(labels_dir)):
        if not mat.endswith("_SK.mat"):
            continue
        seq = mat[:-len("_SK.mat")]
        seq_dir = os.path.join(root, seq)
        if not os.path.isdir(seq_dir):
            continue
        hand_para = sio.loadmat(os.path.join(labels_dir, mat))["handPara"]
        for i in range(hand_para.shape[2]):
            rgb = os.path.join(seq_dir, f"SK_color_{i}.png")
            dep = os.path.join(seq_dir, f"SK_depth_{i}.png")
            if not (os.path.exists(rgb) and os.path.exists(dep)):
                continue
            samples.append(STBSample(seq=seq, frame=i, rgb_path=rgb, depth_path=dep,
                                     joints_xyz=hand_para[:, :, i].T.astype(np.float32)))
    return samples


class STBDataset:
    """STB's samples: the SK depth, the labels projected, reordered and given
    a wrist, then ``make_rgbd_sample`` with STB's 200 mm cube and SK
    intrinsics; in training a colour jitter after it. ``pcl_rng`` as in
    ``RGBDDiskDataset``."""

    def __init__(self, root: str, img_size: int = 128, sample_num: int = 1024, *,
                 pcl_rng: np.random.RandomState):
        self.img_size = img_size
        self.sample_num = sample_num
        self.pcl_rng = pcl_rng
        self.samples = scan_stb_dir(root)
        if not self.samples:
            raise FileNotFoundError(f"no STB samples under {root}")
        self._rot_mat = rodrigues(np.asarray(STB_SK_ROT, np.float64))
        self._K = np.array([[STB_CAM[0], 0, STB_CAM[2]], [0, STB_CAM[1], STB_CAM[3]],
                            [0, 0, 1]], np.float64)

    def __len__(self) -> int:
        return len(self.samples)

    def load(self, idx: int, aug_rng: Optional[np.random.Generator] = None,
             aug_para: Tuple[float, float, float] = AUG_PARA) -> Dict[str, np.ndarray]:
        s = self.samples[idx]
        rgb = _imread(s.rgb_path)
        if rgb is None:
            raise IOError(f"cannot read {s.rgb_path}")
        depth = read_depth_stb(s.depth_path)
        uvd = preprocess_stb(stb_xyz_to_uvd(s.joints_xyz.astype(np.float64), self._K,
                                            self._rot_mat, np.asarray(STB_SK_TRANS)))
        # back to xyz with fx on both axes, as the reference's uvd2xyz does
        fx, _, cx, cy = STB_CAM
        joints = joint_img_to_3d(uvd.astype(np.float32), (fx, fx, cx, cy))
        item = make_rgbd_sample(rgb.astype(np.float32), depth, STB_CAM, STB_CUBE, self.img_size,
                                self.sample_num, self.pcl_rng, joints=joints, aug_rng=aug_rng,
                                aug_para=aug_para)
        if aug_rng is not None:  # the colour jitter, per channel, after the augmentation
            c = 0.2
            scale = aug_rng.uniform(1.0 - c, 1.0 + c, 3)
            item["img_rgb"] = np.clip(item["img_rgb"] * scale[:, None, None], 0.0,
                                      1.0).astype(np.float32)
        return item

    def batches(self, batch_size: int, shuffle: bool = True, seed: int = 0,
                drop_last: bool = False, augment: bool = False,
                aug_para: Tuple[float, float, float] = AUG_PARA
                ) -> Iterator[Dict[str, np.ndarray]]:
        yield from _iter_batches(self, batch_size, shuffle, seed, drop_last, augment, aug_para)
