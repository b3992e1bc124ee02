"""Model_RGBD's evaluation path: host pre- and post-processing and the
KPFusion forward (port of hamer_yolo_tpu/models/kpfusion_rgbd/runtime.py).

1. the hand's center of mass from the depth pixels inside the bbox;
2. crops of the RGB and the depth to a metric cube around it (the depth
   z-thresholded), each resized by nearest neighbour into a centered,
   zero-padded canvas, with the composed crop matrix M;
3. the depth normalized to [-1, 1] around the center;
4. a point cloud from the crop's valid pixels through M^-1 and the pinhole,
   normalized by the cube, sampled to ``sample_num`` points;
5. the 2-stage KPFusion forward;
6. the last stage's joints mapped back: uvd in the ORIGINAL image's pixels
   (through M^-1) and metric xyz in meters, in HO3D's joint order with the
   reference's [1, -1, -1] / 1000 flip.

Steps 1-4 and 6's last part are numpy on the host (the crop sizes vary).
The nearest resize is numpy with cv2.INTER_NEAREST's index rule, so that no
cv2 is needed; the point sampling draws from the caller's
``np.random.RandomState``, which gives the draws that seeding numpy's
global RNG with the same seed gives the JAX package. Step 5 and the
normalized uvd of step 6 run as one program of fixed shapes (S = img_size,
N = sample_num): on the card a captured CUDA graph (pipeline/captured.py),
the JAX package's single jit; elsewhere eager.
"""
from __future__ import annotations

from typing import Any, Dict, Tuple

import numpy as np
import torch

from hamer_yolo_tpu_torch.models.kpfusion_rgbd import geometry as G
from hamer_yolo_tpu_torch.models.kpfusion_rgbd.model import KPFusionConfig, kpfusion_forward
from hamer_yolo_tpu_torch.pipeline.captured import CapturedProgram

MANO2HO3D = np.array([0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15,
                      20, 16, 17, 19, 18], np.int32)
CAM_PARA = (906.96, 906.79, 956.75, 547.23)  # fx, fy, u0, v0 of a 1920x1080 camera
CUBE = (250.0, 250.0, 250.0)                 # the crop cube, mm


def get_center_from_bbx(depth: np.ndarray, bbx_xywh, upper: float = 1500.0,
                        lower: float = 171.0) -> np.ndarray:
    """Center of mass (u, v, z) of the in-range depth inside the bbox."""
    centers = np.array([0.0, 0.0, 300.0])
    x_min, y_min = int(bbx_xywh[0]), int(bbx_xywh[1])
    x_max = int(bbx_xywh[0] + bbx_xywh[2])
    y_max = int(bbx_xywh[1] + bbx_xywh[3])
    img = depth[y_min:y_max, x_min:x_max]
    flag = np.logical_and(img <= upper, img >= lower)
    x = np.linspace(0, img.shape[1], img.shape[1])
    y = np.linspace(0, img.shape[0], img.shape[0])
    xv, yv = np.meshgrid(x, y)
    if flag.any():
        centers[0] = np.mean(xv[flag])
        centers[1] = np.mean(yv[flag])
        centers[2] = np.mean(img[flag])
        if centers[2] <= 0:
            centers[2] = 300.0
    centers[0] += bbx_xywh[0]
    centers[1] += bbx_xywh[1]
    return centers


def com_to_bounds(com, size, paras) -> Tuple[int, int, int, int, float, float]:
    fx, fy, _, _ = paras
    zstart = com[2] - size[2] / 2.0
    zend = com[2] + size[2] / 2.0
    xstart = int(np.floor((com[0] * com[2] / fx - size[0] / 2.0) / com[2] * fx + 0.5))
    xend = int(np.floor((com[0] * com[2] / fx + size[0] / 2.0) / com[2] * fx + 0.5))
    ystart = int(np.floor((com[1] * com[2] / fy - size[1] / 2.0) / com[2] * fy + 0.5))
    yend = int(np.floor((com[1] * com[2] / fy + size[1] / 2.0) / com[2] * fy + 0.5))
    return xstart, xend, ystart, yend, zstart, zend


def get_crop(depth: np.ndarray, xstart, xend, ystart, yend, zstart, zend,
             thresh_z: bool = True, background: float = 0.0) -> np.ndarray:
    H, W = depth.shape[:2]
    cropped = depth[max(ystart, 0):min(yend, H), max(xstart, 0):min(xend, W)].copy()
    pad = [(abs(ystart) - max(ystart, 0), abs(yend) - min(yend, H)),
           (abs(xstart) - max(xstart, 0), abs(xend) - min(xend, W))]
    cropped = np.pad(cropped, pad + [(0, 0)] * (depth.ndim - 2), mode="constant",
                     constant_values=background)
    if thresh_z:
        msk1 = np.logical_and(cropped < zstart, cropped != 0)
        msk2 = np.logical_and(cropped > zend, cropped != 0)
        cropped[msk1] = zstart
        cropped[msk2] = 0.0
    return cropped


def resize_nearest(img: np.ndarray, dsize: Tuple[int, int]) -> np.ndarray:
    """``cv2.resize(img, dsize, interpolation=cv2.INTER_NEAREST)``: dsize is
    (width, height); source index floor(i * (1 / (dst / src))) in float64,
    clamped to the last row or column."""
    def src(n_src, n_dst):
        inv = 1.0 / (n_dst / n_src)
        return np.minimum(np.floor(np.arange(n_dst) * inv).astype(np.int64), n_src - 1)

    h, w = img.shape[:2]
    return img[src(h, dsize[1])][:, src(w, dsize[0])]


def _crop_common(img: np.ndarray, com, size, dsize, paras,
                 thresh_z: bool) -> Tuple[np.ndarray, np.ndarray]:
    xstart, xend, ystart, yend, zstart, zend = com_to_bounds(com, size, paras)
    cropped = get_crop(img, xstart, xend, ystart, yend, zstart, zend, thresh_z)
    wb, hb = (xend - xstart), (yend - ystart)
    if wb > hb:
        sz = (dsize[0], int(hb * dsize[0] / wb))
    else:
        sz = (int(wb * dsize[1] / hb), dsize[1])
    trans = np.eye(3)
    trans[0, 2] = -xstart
    trans[1, 2] = -ystart
    if cropped.shape[0] > cropped.shape[1]:
        scale = np.eye(3) * sz[1] / float(cropped.shape[0])
    else:
        scale = np.eye(3) * sz[0] / float(cropped.shape[1])
    scale[2, 2] = 1
    rz = resize_nearest(cropped, sz)
    shape = dsize if img.ndim == 2 else (dsize[0], dsize[1], 3)
    ret = np.zeros(shape, np.float32)
    xs = int(np.floor(dsize[0] / 2.0 - rz.shape[1] / 2.0))
    ys = int(np.floor(dsize[1] / 2.0 - rz.shape[0] / 2.0))
    ret[ys:ys + rz.shape[0], xs:xs + rz.shape[1]] = rz
    off = np.eye(3)
    off[0, 2] = xs
    off[1, 2] = ys
    return ret, off @ scale @ trans


def crop_depth(depth, com, cube, dsize, paras):
    return _crop_common(depth, com, cube, dsize, paras, thresh_z=True)


def crop_rgb(rgb, com, cube, dsize, paras):
    return _crop_common(rgb, com, cube, dsize, paras, thresh_z=False)


def normalize_img(img: np.ndarray, com, cube) -> np.ndarray:
    premax = img.max()
    out = img.copy()
    hi = com[2] + cube[2] / 2.0
    lo = com[2] - cube[2] / 2.0
    out[out == premax] = hi
    out[out == 0] = hi
    out[out >= hi] = hi
    out[out <= lo] = lo
    return (out - com[2]) / (cube[2] / 2.0)


def joint_img_to_3d(uvd: np.ndarray, paras, flip: float = 1.0) -> np.ndarray:
    fx, fy, fu, fv = paras
    ret = np.zeros_like(uvd, np.float32)
    ret[..., 0] = (uvd[..., 0] - fu) * uvd[..., 2] / fx
    ret[..., 1] = flip * (uvd[..., 1] - fv) * uvd[..., 2] / fy
    ret[..., 2] = uvd[..., 2]
    return ret


def depth_to_pcl(dpt: np.ndarray, T: np.ndarray, paras, flip: float = 1.0) -> np.ndarray:
    """The crop's valid pixels -> metric points (processing_depth.depthToPCL)."""
    fx, fy, fu, fv = paras
    pts = np.asarray(np.where(~np.isclose(dpt, 0.0))).transpose()
    pts = np.concatenate([pts[:, [1, 0]] + 0.5, np.ones((pts.shape[0], 1), "float32")], axis=1)
    pts = (np.linalg.inv(np.asarray(T)) @ pts.T).T
    pts = (pts[:, 0:2] / pts[:, 2][:, None]).reshape((pts.shape[0], 2))
    depth = dpt[~np.isclose(dpt, 0.0)]
    row = (pts[:, 0] - fu) / fx * depth
    col = flip * (pts[:, 1] - fv) / fy * depth
    return np.column_stack((row, col, depth))


def get_pcl(imgD: np.ndarray, com3D, cube, M, paras) -> np.ndarray:
    mask = np.isclose(imgD, 1)
    dpt = imgD * cube[2] / 2.0 + com3D[2]
    dpt[mask] = 0
    pcl = depth_to_pcl(dpt, M, paras) - com3D
    return pcl / np.tile(np.asarray(cube) / 2.0, (pcl.shape[0], 1))


def sample_pcl(pcl: np.ndarray, sample_num: int, rng: np.random.RandomState) -> np.ndarray:
    """The reference's sampling (process_depth), drawn from ``rng`` in the
    reference's call sequence: ``RandomState(s)`` reproduces the point subset
    of the reference seeded with ``np.random.seed(s)``."""
    n = pcl.shape[0]
    if n == 0:
        return np.zeros((sample_num, 3), np.float32)
    pcl_index = np.arange(n)
    if n < sample_num:
        pcl_index = np.append(pcl_index.repeat(sample_num // n),
                              rng.choice(pcl_index, size=sample_num % n, replace=False))
    select = rng.choice(pcl_index, sample_num, replace=False)
    return np.clip(pcl[select], -1, 1).astype(np.float32)


class RGBDRuntime:
    """``estimate_pose_rgbd`` over parameters on ``device`` (the card unless
    the caller names another)."""

    def __init__(self, params: Any, cfg: KPFusionConfig = KPFusionConfig(), device="cuda",
                 cam_para: Tuple[float, ...] = CAM_PARA, cube: Tuple[float, ...] = CUBE):
        self.params, self.cfg, self.device = params, cfg, torch.device(device)
        self.cam_para, self.cube = tuple(cam_para), tuple(cube)
        self.program = CapturedProgram("rgbd", self.forward, self.device)

    def forward(self, img_rgb, img, pcl, center, M, cube, cam) -> Dict[str, torch.Tensor]:
        """The device program on tensors: the final joints in normalized xyz
        and in normalized crop uvd."""
        out = kpfusion_forward(self.params, img_rgb, img, pcl, center, M, cube, cam, self.cfg)
        uvd = G.xyz_nl2uvdnl(out["joints"], center, M, cube, cam, self.cfg.img_size)
        return {"joints": out["joints"], "uvd": uvd}

    def prepare(self, img_rgb: np.ndarray, img_d: np.ndarray, bbox_xywh,
                rng: np.random.RandomState) -> Dict[str, np.ndarray]:
        """Steps 1-4: the program's inputs as numpy arrays, batch 1, in
        ``forward``'s order (``inputs``), and the crops and the center."""
        S = self.cfg.img_size
        center = get_center_from_bbx(img_d, bbox_xywh)
        crop_rgb_img, _ = crop_rgb(img_rgb.astype(np.float32), center, self.cube, (S, S),
                                   self.cam_para)
        crop_rgb_img = crop_rgb_img / 255.0
        depth_crop, M = crop_depth(img_d.astype(np.float32), center, self.cube, (S, S),
                                   self.cam_para)
        imgD = normalize_img(depth_crop, center, self.cube)
        com3D = joint_img_to_3d(np.asarray(center, np.float32), self.cam_para)
        pcl = sample_pcl(get_pcl(imgD, com3D, self.cube, M, self.cam_para), self.cfg.sample_num,
                         rng)
        inputs = (crop_rgb_img.transpose(2, 0, 1)[None].astype(np.float32),
                  imgD[None, None].astype(np.float32), pcl[None], com3D[None],
                  M[None].astype(np.float32), np.asarray(self.cube, np.float32)[None],
                  np.asarray(self.cam_para, np.float32)[None])
        return {"inputs": inputs, "crop_rgb": crop_rgb_img, "crop_depth": imgD, "M": M,
                "center": center, "com3D": com3D}

    def finish(self, prep: Dict[str, Any], joints: np.ndarray,
               uvd: np.ndarray) -> Dict[str, np.ndarray]:
        """Step 6 from the program's outputs (numpy, batch 1)."""
        S = self.cfg.img_size
        cube_a = np.asarray(self.cube, np.float32)[None]
        com3D, M = prep["com3D"], prep["M"]
        # world xyz in meters, HO3D order, axis flip
        xyz_world = joints * cube_a[:, None] / 2.0 + com3D[None, None]
        xyz_world = xyz_world[:, MANO2HO3D] * np.array([1, -1, -1]) / 1000.0
        # uvd back to the original image's pixels
        uvd = uvd[0]
        uvd_px = uvd.copy()
        uvd_px[:, 0:2] = (uvd[:, 0:2] + 1) * (S / 2.0)
        uvd_px[:, 2] = uvd[:, 2] * cube_a[0, 2] / 2.0 + com3D[2]
        homo = np.concatenate([uvd_px[:, :2], np.ones((uvd_px.shape[0], 1))], axis=1)
        uv_full = (np.linalg.inv(M) @ homo.T).T
        uvd_full = np.concatenate([uv_full[:, :2] / uv_full[:, 2:], uvd_px[:, 2:]], axis=1)
        return {"joint_uvd_full": uvd_full.astype(np.float32),
                "joint_xyz_world": xyz_world[0].astype(np.float32),
                "crop_rgb": prep["crop_rgb"], "crop_depth": prep["crop_depth"], "M": M,
                "center": prep["center"]}

    def estimate_pose_rgbd(self, img_rgb: np.ndarray, img_d: np.ndarray, bbox_xywh,
                           rng: np.random.RandomState) -> Dict[str, np.ndarray]:
        """img_rgb (H, W, 3) uint8 or float, img_d (H, W) depth in mm, bbox
        [x, y, w, h], ``rng`` for the point sampling -> the joints in the
        original image's uvd and in metric xyz, with the crops, M and the
        center."""
        prep = self.prepare(img_rgb, img_d, bbox_xywh, rng)
        out = self.program(*prep["inputs"])
        return self.finish(prep, out["joints"].cpu().numpy(), out["uvd"].cpu().numpy())
