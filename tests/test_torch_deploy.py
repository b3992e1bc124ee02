"""Deploy: the export tool's three programs traced by torch.export with K1 and
K2 as the operators hyt_port::* (ops/torch_ops.py), at the --tiny config in
bf16 with ``fused_attn=True`` so that K2's operator is traced on the CPU.

Each exported program keeps K1's operator once and K2's once a ViT block,
reads every weight in the dtype the program computes in (no cast of a buffer
in the graph), equals the port's eager function bit for bit, equals it again
after a torch.export save / load round trip, and matches the JAX function
that JAX's tools/export_executable.py wraps, on the same numpy-made weights
and inputs, at tests/test_torch_pipeline.py's bf16 limits (JAX's K2 is its
Pallas block in interpret mode, HYT_ATTN_BF16=megakernel). The operators'
CPU implementations, fakes and schema strings are held to the plain
versions and to csrc/torch_ops.cpp. No AOTInductor compile runs here: it
runs on the card (chip_smoke.py's phase "deploy")."""
import dataclasses
import re
from functools import partial

import numpy as np
import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensorMode

import jax
import jax.numpy as jnp

from hamer_yolo_tpu.models.hamer import hamer_forward as jax_hamer_forward
from hamer_yolo_tpu.models.yolov7 import yolov7_forward as jax_yolov7_forward
from hamer_yolo_tpu.ops import attention_pallas as jax_attention_pallas
from hamer_yolo_tpu.ops.nms import non_max_suppression as jax_nms
from hamer_yolo_tpu.pipeline.frame import infer_frame as jax_infer_frame
from hamer_yolo_tpu_torch.ops import torch_ops
from hamer_yolo_tpu_torch.ops.attn_block import fused_bf16_attn_block_ref
from hamer_yolo_tpu_torch.ops.nms import greedy_nms_keep_ref
from hamer_yolo_tpu_torch.tools import export_executable as ee
from test_torch_bridge import (jax_exact, mano_pair, pipeline_params, sar_pipeline_params,
                               tiny_configs, to_port)
from test_torch_pipeline import _check_frame

torch.set_num_threads(1)

HW = (120, 160)
K = np.float32([[200.0, 0, 80], [0, 200.0, 60], [0, 0, 1]])
BF16_TOL = 8e-3  # test_torch_pipeline's bf16 limit (the JAX package's own two bf16 forms)
OPS = {"K1": "hyt_port.greedy_nms_keep_mask.default",
       "K2": "hyt_port.fused_bf16_attn_block.default"}


def _configs():
    jcfg, tcfg = tiny_configs("bfloat16")
    vit = dataclasses.replace(tcfg.hamer.vit, fused_attn=True)
    return jcfg, dataclasses.replace(tcfg, hamer=dataclasses.replace(tcfg.hamer, vit=vit))


def _inputs(model, jcfg):
    rng = np.random.default_rng(5)
    if model == "frame":
        return (rng.integers(0, 255, (*HW, 3)).astype(np.float32), np.float32(HW), K)
    if model == "yolo":
        return (rng.uniform(0, 1, (1, jcfg.det_size, jcfg.det_size, 3)).astype(np.float32),)
    size = jcfg.hamer.image_size
    return (rng.normal(size=(1, size, size, 3)).astype(np.float32),)


def _jax_fn(model, jp, jm, jcfg):
    """The functions JAX's tools/export_executable.py jits, on ``jcfg``."""
    if model == "yolo":
        def fn(img):
            pred = jax_yolov7_forward(jp["yolo"], img, jcfg.yolo)
            nms = jax_nms(pred, 0.25, 0.35, classes=(0, 1, 2), agnostic=True, max_det=32)
            return nms.boxes, nms.scores, nms.classes, nms.valid
    elif model == "hamer":
        def fn(img):
            out = jax_hamer_forward(jp["hamer"], jm, img, jcfg.hamer)
            return out["pred_vertices"], out["pred_keypoints_3d"], out["pred_cam_t"]
    else:
        def fn(image, orig_hw, K):
            out = jax_infer_frame(jp, jm, image, orig_hw, K, jcfg)
            return (out["boxes"], out["scores"], out["valid"], out["theta"], out["betas"],
                    out["cam_t"], out["vertices"])
    return fn


@pytest.fixture(scope="module")
def deployed():
    """Per program: the exported program, the port's eager outputs and JAX's
    outputs on the same weights and inputs."""
    jm, tm = mano_pair()
    jcfg, tcfg = _configs()
    out = {}
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("HYT_ATTN_BF16", "megakernel")
        mp.setattr(jax_attention_pallas, "fused_bf16_attn_block",
                   partial(jax_attention_pallas.fused_bf16_attn_block, interpret=True))
        for seed, model in enumerate(ee.MODELS):
            params = (sar_pipeline_params(jcfg, seed=21) if model == "frame"
                      else pipeline_params(jcfg, seed=20 + seed))
            inputs = _inputs(model, jcfg)
            jp = jax.tree_util.tree_map(jnp.asarray, params)
            ref = [np.asarray(a) for a in jax_exact(_jax_fn(model, jp, jm, jcfg), *inputs)]
            tparams = to_port(params)
            prog = ee.program(model, tcfg, HW, "cpu")
            ep, _ = ee.export_program(prog, tparams, tm)
            targs = tuple(torch.from_numpy(np.asarray(a)) for a in inputs)
            with torch.no_grad():
                eager = prog.fn(tparams, tm, *targs)
            out[model] = {"ep": ep, "args": targs, "eager": eager, "jax": ref,
                          "names": prog.outputs, "depth": tcfg.hamer.vit.depth}
    return out


def _run(ep, args):
    with torch.no_grad():
        return ep.module()(*args)


def _same(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape
        assert torch.equal(g, w)


@pytest.mark.parametrize("model", ee.MODELS)
def test_export_keeps_the_operators(deployed, model):
    d = deployed[model]
    targets = [str(n.target) for n in d["ep"].graph.nodes if n.op == "call_function"]
    want = {"yolo": (1, 0), "hamer": (0, d["depth"]), "frame": (1, d["depth"])}[model]
    assert (targets.count(OPS["K1"]), targets.count(OPS["K2"])) == want
    # each weight a buffer in the dtype the program reads it in: no cast of a
    # buffer per call
    buffers = set(d["ep"].graph_signature.inputs_to_buffers)
    casts = [n for n in d["ep"].graph.nodes if n.op == "call_function"
             and "_to_copy" in str(n.target) and getattr(n.args[0], "name", None) in buffers]
    assert not casts, [c.args[0].name for c in casts]


@pytest.mark.parametrize("model", ee.MODELS)
def test_exported_equals_eager(deployed, model):
    d = deployed[model]
    _same(_run(d["ep"], d["args"]), d["eager"])


@pytest.mark.parametrize("model", ee.MODELS)
def test_save_load_round_trip(deployed, model, tmp_path):
    d = deployed[model]
    path = tmp_path / f"{model}.pt2"
    torch.export.save(d["ep"], path)
    _same(_run(torch.export.load(path), d["args"]), _run(d["ep"], d["args"]))


@pytest.mark.parametrize("model", ee.MODELS)
def test_exported_matches_jax(deployed, model):
    d = deployed[model]
    got = {k: v.float().numpy() if v.dtype != torch.bool else v.numpy()
           for k, v in zip(d["names"], _run(d["ep"], d["args"]))}
    ref = {k: np.asarray(v, got[k].dtype) for k, v in zip(d["names"], d["jax"])}
    if model == "hamer":
        for k in d["names"]:
            np.testing.assert_allclose(got[k], ref[k], rtol=BF16_TOL, atol=BF16_TOL, err_msg=k)
        return
    assert ref["valid"].any(), "no valid slot: the comparison would be empty"
    if model == "frame":
        _check_frame(got, ref, "bfloat16", model)
        return
    # the detector's raw boxes (letterbox pixels, not rounded as the frame's
    # are): slots matched by box at the bf16 limit (F3), classes exact
    got, ref = ({k: v[0] for k, v in t.items()} for t in (got, ref))
    assert got["valid"].sum() == ref["valid"].sum()
    for i in np.flatnonzero(ref["valid"]):
        close = np.isclose(got["boxes"], ref["boxes"][i], rtol=BF16_TOL, atol=BF16_TOL).all(-1)
        hit = np.flatnonzero(got["valid"] & close)
        assert hit.size, f"slot {i} box {ref['boxes'][i]} not found"
        assert got["classes"][hit[0]] == ref["classes"][i]
        np.testing.assert_allclose(got["scores"][hit[0]], ref["scores"][i], rtol=BF16_TOL,
                                   atol=BF16_TOL)


def test_schemas_equal_the_cpp():
    text = torch_ops.SOURCE.read_text()
    defs = re.findall(r'm\.def\(((?:\s*"[^"]*")+)\)', text)
    cpp = [re.sub(r'"\s*"', "", d.strip())[1:-1] for d in defs]
    assert cpp == list(torch_ops.SCHEMAS.values())
    impls = re.findall(r'm\.impl\("(\w+)"', text)
    assert impls == list(torch_ops.SCHEMAS)


def test_operators_on_the_cpu_equal_the_plain_versions():
    torch_ops.register()
    rng = np.random.default_rng(0)
    xy = rng.uniform(0, 100, (2, 64, 2)).astype(np.float32)
    boxes = torch.from_numpy(np.concatenate([xy, xy + rng.uniform(5, 40, (2, 64, 2))], -1)
                             .astype(np.float32))
    active = torch.from_numpy(rng.uniform(size=(2, 64)) > 0.3)
    keep = torch.ops.hyt_port.greedy_nms_keep_mask(boxes, active, 0.35)
    assert keep.dtype == torch.bool and keep.any()
    assert torch.equal(keep, greedy_nms_keep_ref(boxes, active, 0.35) > 0.5)
    for dtype in (torch.bfloat16, torch.float32):
        tok = torch.from_numpy(rng.normal(size=(2, 24, 64)).astype(np.float32)).to(dtype)
        w = torch.from_numpy(rng.normal(size=(64, 192)).astype(np.float32) * 0.1)
        b, g, bb = (torch.from_numpy(rng.normal(size=n).astype(np.float32)) for n in
                    (192, 64, 64))
        for bias in (b, None):
            got = torch.ops.hyt_port.fused_bf16_attn_block(tok, w, bias, g, bb, 4)
            assert got.dtype == dtype
            assert torch.equal(got, fused_bf16_attn_block_ref(tok, w, bias, g, bb, 4))


def test_fakes_give_shapes_and_dtypes():
    torch_ops.register()
    with FakeTensorMode():
        keep = torch.ops.hyt_port.greedy_nms_keep_mask(torch.empty(3, 512, 4),
                                                       torch.empty(3, 512, dtype=torch.bool), 0.5)
        assert keep.shape == (3, 512) and keep.dtype == torch.bool
        for dtype in (torch.bfloat16, torch.float32):
            out = torch.ops.hyt_port.fused_bf16_attn_block(
                torch.empty(16, 192, 1280, dtype=dtype), torch.empty(1280, 3840,
                                                                     dtype=torch.bfloat16),
                torch.empty(3840), torch.empty(1280), torch.empty(1280), 16)
            assert out.shape == (16, 192, 1280) and out.dtype == dtype


def test_meta_lines_are_jax_tools():
    from hamer_yolo_tpu_torch.cli.main import pipeline_config

    cfg = pipeline_config()
    got = {m: ee.meta_lines(ee.program(m, cfg, (720, 1280), "meta").inputs) for m in ee.MODELS}
    assert got == {"yolo": ["f32 1,640,640,3"], "hamer": ["f32 1,256,256,3"],
                   "frame": ["f32 720,1280,3", "f32 2", "f32 3,3"]}


def test_export_refuses_cuda_without_a_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this host has a card")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ee.export(str(tmp_path), "yolo", device="cuda")
