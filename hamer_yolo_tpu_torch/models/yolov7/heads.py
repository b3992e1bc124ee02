"""IBin and IKeypoint detection heads (port of
hamer_yolo_tpu/models/yolov7/heads.py: init, inference decode and
SigmoidBin's training loss).

- IBin: box w and h come from SigmoidBin classification-plus-residual bins
  in place of the (2 sigmoid)^2 anchor decode. Per anchor: [x, y,
  w bins (bin_count + 1), h bins (bin_count + 1), obj, classes]; the bins
  span [0, 4] x anchor.
- IKeypoint: the detect convs (ImplicitA/M fused at conversion) and a
  keypoint conv of 3 nkpt channels a level, concatenated along channels
  before the (na, no) reshape. Keypoint x and y decode from the raw logits,
  (v 2 - 0.5 + grid) stride; their confidences are sigmoided.

``sigmoid_bin_training_loss`` is SigmoidBin.training_loss as
ComputeLossBinOTA configures it (no regression loss): BCE of the bin
logits against the one-hot nearest bin.
"""
from __future__ import annotations

from typing import List, Sequence

import torch

from hamer_yolo_tpu_torch.core import nn

BIN_COUNT = 21
BIN_MIN, BIN_MAX = 0.0, 4.0
BIN_REG_SCALE = 2.0


def bin_no(nc: int, bin_count: int = BIN_COUNT) -> int:
    """Outputs per anchor of IBin: x, y, obj, the classes and two bin sets."""
    return nc + 3 + 2 * (bin_count + 1)


def kpt_no(nc: int, nkpt: int) -> int:
    return nc + 5 + 3 * nkpt


def sigmoid_bin_centers(bin_count: int, device, vmin: float = BIN_MIN,
                        vmax: float = BIN_MAX) -> torch.Tensor:
    """The bins' centres, f32, as JAX's numpy arithmetic gives them."""
    step = (vmax - vmin) / bin_count
    start = vmin + step / 2.0
    return nn.constant(tuple(start + step * i for i in range(bin_count)), torch.float32, device)


def sigmoid_bin_decode(y: torch.Tensor, bin_count: int = BIN_COUNT, vmin: float = BIN_MIN,
                       vmax: float = BIN_MAX, reg_scale: float = BIN_REG_SCALE) -> torch.Tensor:
    """SigmoidBin's forward on sigmoided inputs y (..., bin_count + 1) ->
    (...): the residual of channel 0 plus the centre of the argmax bin,
    clamped to [vmin, vmax]."""
    step = (vmax - vmin) / bin_count
    reg = (y[..., 0] * reg_scale - reg_scale / 2.0) * step
    idx = torch.argmax(y[..., 1:1 + bin_count], dim=-1)
    return torch.clamp(reg + sigmoid_bin_centers(bin_count, y.device, vmin, vmax)[idx],
                       vmin, vmax)


def sigmoid_bin_training_loss(pred_logits: torch.Tensor, target: torch.Tensor,
                              weight: torch.Tensor = None, bin_count: int = BIN_COUNT,
                              vmin: float = BIN_MIN, vmax: float = BIN_MAX,
                              reg_scale: float = BIN_REG_SCALE):
    """pred_logits (N, bin_count + 1) raw, target (N,) values, ``weight``
    an optional (N,) mask (the reference indexes the matched rows instead)
    -> (the mean masked BCE over the bin channels, the clamped regressed
    value (N,)). The nearest bin is the first of equal distances, as
    jnp.argmin picks; |x| has jnp.abs's gradient 1 at 0."""
    step = (vmax - vmin) / bin_count
    reg = (torch.sigmoid(pred_logits[..., 0]) * reg_scale - reg_scale / 2.0) * step
    centers = sigmoid_bin_centers(bin_count, pred_logits.device, vmin, vmax)
    idx = torch.argmin(torch.abs(target[..., None] - centers), dim=-1)
    result = reg + centers[idx]
    tgt = torch.nn.functional.one_hot(idx, bin_count).to(pred_logits.dtype)
    lg = pred_logits[..., 1:]
    bce = (torch.maximum(lg, lg.new_zeros(())) - lg * tgt
           + torch.log1p(torch.exp(-torch.where(lg >= 0, lg, -lg))))
    if weight is None:
        loss = bce.mean()
    else:
        loss = (bce * weight[..., None]).sum() / torch.clamp(weight.sum() * bin_count, min=1.0)
    return loss, torch.clamp(result, vmin, vmax)


def init_bin_head(gen: torch.Generator, in_chs: Sequence[int], na: int, nc: int,
                  bin_count: int = BIN_COUNT) -> nn.Params:
    no = bin_no(nc, bin_count)
    return {"m": [nn.conv_init(gen, 1, c, na * no, bias=True) for c in in_chs]}


def init_keypoint_head(gen: torch.Generator, in_chs: Sequence[int], na: int, nc: int,
                       nkpt: int) -> nn.Params:
    m, m_kpt = [], []
    for c in in_chs:
        m.append(nn.conv_init(gen, 1, c, na * (nc + 5), bias=True))
        m_kpt.append(nn.conv_init(gen, 1, c, na * 3 * nkpt, bias=True))
    return {"m": m, "m_kpt": m_kpt}


def _anchor_major(m: torch.Tensor, na: int, no: int) -> torch.Tensor:
    """(B, H, W, na no) -> (B, na, H, W, no), the reference's flatten order."""
    Bz, H, W, _ = m.shape
    return m.reshape(Bz, H, W, na, no).permute(0, 3, 1, 2, 4)


def _grid(H: int, W: int, device) -> torch.Tensor:
    gy, gx = torch.meshgrid(torch.arange(H, dtype=torch.float32, device=device),
                            torch.arange(W, dtype=torch.float32, device=device), indexing="ij")
    return torch.stack([gx, gy], dim=-1)


def _anchors(cfg, device) -> torch.Tensor:
    return nn.constant(cfg.anchors, torch.float32, device).reshape(cfg.nl, cfg.na, 2)


def decode_bin_detections(det_maps: Sequence[torch.Tensor], cfg,
                          bin_count: int = BIN_COUNT) -> torch.Tensor:
    """IBin's inference decode -> (B, N, nc + 5), in f32."""
    anchors = _anchors(cfg, det_maps[0].device)
    L = bin_count + 1
    obj_idx = 2 + 2 * L
    outs: List[torch.Tensor] = []
    for lvl, m in enumerate(det_maps):
        m = m.float()
        Bz, H, W, _ = m.shape
        y = torch.sigmoid(_anchor_major(m, cfg.na, bin_no(cfg.nc, bin_count)))
        xy = (y[..., 0:2] * 2.0 - 0.5 + _grid(H, W, m.device)) * cfg.strides[lvl]
        anc = anchors[lvl][None, :, None, None, :]
        pw = sigmoid_bin_decode(y[..., 2:2 + L], bin_count) * anc[..., 0]
        ph = sigmoid_bin_decode(y[..., 2 + L:obj_idx], bin_count) * anc[..., 1]
        out = torch.cat([xy, pw[..., None], ph[..., None], y[..., obj_idx:]], dim=-1)
        outs.append(out.reshape(Bz, -1, cfg.nc + 5))
    return torch.cat(outs, dim=1)


def decode_keypoint_detections(det_maps: Sequence[torch.Tensor], cfg,
                               nkpt: int = 17) -> torch.Tensor:
    """IKeypoint's inference decode -> (B, N, nc + 5 + 3 nkpt) rows [xy, wh,
    obj, classes, (kx, ky, kconf) per keypoint], in f32."""
    anchors = _anchors(cfg, det_maps[0].device)
    no_det = cfg.nc + 5
    outs: List[torch.Tensor] = []
    for lvl, m in enumerate(det_maps):
        m = m.float()
        Bz, H, W, _ = m.shape
        x = _anchor_major(m, cfg.na, kpt_no(cfg.nc, nkpt))
        stride = cfg.strides[lvl]
        grid = _grid(H, W, m.device)
        y = torch.sigmoid(x[..., :no_det])
        xy = (y[..., 0:2] * 2.0 - 0.5 + grid) * stride
        wh = (y[..., 2:4] * 2.0) ** 2 * anchors[lvl][None, :, None, None, :]
        kpt = x[..., no_det:].reshape(x.shape[:-1] + (nkpt, 3))
        kx = (kpt[..., 0] * 2.0 - 0.5 + grid[..., 0:1]) * stride
        ky = (kpt[..., 1] * 2.0 - 0.5 + grid[..., 1:2]) * stride
        kflat = torch.stack([kx, ky, torch.sigmoid(kpt[..., 2])], dim=-1)
        out = torch.cat([xy, wh, y[..., 4:], kflat.reshape(x.shape[:-1] + (3 * nkpt,))], dim=-1)
        outs.append(out.reshape(Bz, -1, kpt_no(cfg.nc, nkpt)))
    return torch.cat(outs, dim=1)
