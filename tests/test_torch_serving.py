"""serving.BatchedPipeline: process_batch against the per-frame program and
against the JAX package's BatchedPipeline, the stream, the batched runner,
and the F2 checks (ROADMAP.md: frames past the batch and float frames
outside 0..255 raise; JAX drops the one and wraps the other modulo 256).
f32 tiny configs with SAR on numpy-made weights, on the CPU."""
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from hamer_yolo_tpu.pipeline.serving import BatchedPipeline as JaxBatchedPipeline
from hamer_yolo_tpu_torch.io.writers import load_hand_npy
from hamer_yolo_tpu_torch.pipeline.runner import (FrameProgram, process_frames,
                                                  process_frames_batched)
from hamer_yolo_tpu_torch.pipeline.serving import BatchedPipeline
from test_torch_bridge import mano_pair, sar_pipeline_params, tiny_configs, to_port

torch.set_num_threads(1)

K = np.float32([[200.0, 0, 80], [0, 200.0, 60], [0, 0, 1]])


@pytest.fixture(scope="module")
def setup():
    jcfg, tcfg = tiny_configs("float32")
    params = sar_pipeline_params(jcfg, seed=21)
    jm, tm = mano_pair()
    rng = np.random.default_rng(3)
    frames = [rng.integers(0, 256, hw + (3,), dtype=np.uint8)
              for hw in [(100, 120), (90, 130), (130, 70)]]
    return jcfg, tcfg, params, jm, tm, frames


def _same_slots(got, ref, where, atol=1e-4):
    """Every valid slot of ``ref`` in ``got`` by its box, fields within f32
    reassociation (F3: slot order may differ on near-tied scores)."""
    assert got["valid"].sum() == ref["valid"].sum(), where
    for i in np.flatnonzero(ref["valid"]):
        hit = np.flatnonzero(got["valid"] & (got["boxes"] == ref["boxes"][i]).all(-1))
        assert hit.size, f"{where}: slot {i} not found"
        for k, v in ref.items():
            np.testing.assert_allclose(np.asarray(got[k][hit[0]], np.float64),
                                       np.asarray(v[i], np.float64), rtol=1e-4, atol=atol,
                                       err_msg=f"{where}:{k}")


def test_process_batch_matches_per_frame(setup):
    """A batch of 3 in a pipeline of 4 (one pad row) gives each frame what
    the one-frame program gives it, root_depth included."""
    _, tcfg, params, _, tm, frames = setup
    tp = to_port(params)
    pipe = BatchedPipeline(tp, tm, tcfg, batch_size=4, device="cpu")
    out = pipe.process_batch(frames, K)
    assert out["vertices"].shape == (3, 2, 778, 3) and "root_depth" in out
    program = FrameProgram(tp, tm, tcfg, "cpu")
    for i, f in enumerate(frames):
        _same_slots({k: v[i] for k, v in out.items()}, program(f, K), f"frame {i}")


def test_process_batch_matches_jax_batched_pipeline(setup):
    """The port's BatchedPipeline against JAX's on the same frames, per-frame
    intrinsics (f32: JAX's jit keeps excess precision, f32 is immune); root
    depth at the composed-oracle limit 2e-3."""
    jcfg, tcfg, params, jm, tm, frames = setup
    Ks = np.stack([K, K * np.float32([[1.1], [1.1], [1]]), K])
    ref = JaxBatchedPipeline(jax.tree_util.tree_map(jnp.asarray, params), jm, jcfg,
                             batch_size=4).process_batch(frames, Ks)
    got = BatchedPipeline(to_port(params), tm, tcfg, batch_size=4,
                          device="cpu").process_batch(frames, Ks)
    assert set(got) == set(ref)
    for i in range(3):
        r = {k: np.asarray(v[i]) for k, v in ref.items()}
        depth = r.pop("root_depth")
        g = {k: v[i] for k, v in got.items()}
        _same_slots(g, r, f"frame {i}")
        _same_slots({"root_depth": g["root_depth"], **{k: g[k] for k in ("boxes", "valid")}},
                    {"root_depth": depth, **{k: r[k] for k in ("boxes", "valid")}},
                    f"frame {i} depth", atol=2e-3)


def test_frames_past_the_batch_raise(setup):
    """F2: JAX drops frames past batch_size; the port refuses them."""
    _, tcfg, params, _, tm, frames = setup
    pipe = BatchedPipeline(to_port(params), tm, tcfg, batch_size=2, device="cpu")
    with pytest.raises(ValueError, match="3 frames for a batch of 2"):
        pipe.process_batch(frames, K)
    with pytest.raises(ValueError, match="0 frames"):
        pipe.process_batch([], K)


@pytest.mark.parametrize("at", [0, 1])
@pytest.mark.parametrize("bad", [-1.0, 256.0, 300.5])
def test_float_frames_outside_0_255_raise(setup, at, bad):
    """F2: under a uint8 upload JAX wraps such values modulo 256; the port
    refuses them, wherever the frame stands in the batch."""
    _, tcfg, params, _, tm, frames = setup
    pipe = BatchedPipeline(to_port(params), tm, tcfg, batch_size=2, device="cpu")
    f = frames[0].astype(np.float32)
    f[5, 7, 1] = bad
    batch = [frames[1]]
    batch.insert(at, f)
    with pytest.raises(ValueError, match="outside 0..255"):
        pipe.process_batch(batch, K)


def test_float_frames_in_range_with_uint8_upload(setup):
    """Integral float frames in 0..255 (an f32 upload) give the outputs of
    the same frames as uint8 (a uint8 upload, cast to f32 on the device)."""
    _, tcfg, params, _, tm, frames = setup
    tp = to_port(params)
    a = BatchedPipeline(tp, tm, tcfg, batch_size=2, device="cpu").process_batch(frames[:2], K)
    b = BatchedPipeline(tp, tm, tcfg, batch_size=2, device="cpu").process_batch(
        [f.astype(np.float32) for f in frames[:2]], K)
    for k in a:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def test_stream_batches_and_stats(setup):
    """stream: batches of 2 with the last one partial, in order, the same
    outputs as process_batch; last_stats counts frames and batches."""
    _, tcfg, params, _, tm, frames = setup
    pipe = BatchedPipeline(to_port(params), tm, tcfg, batch_size=2, device="cpu")
    outs = list(pipe.stream(iter(frames), K))
    assert [o["valid"].shape[0] for o in outs] == [2, 1]
    assert (pipe.last_stats.frames, pipe.last_stats.batches) == (3, 2)
    ref = pipe.process_batch(frames[2:], K)
    for k in ref:
        np.testing.assert_array_equal(outs[1][k], ref[k], err_msg=k)


def test_batched_runner_writes_the_per_frame_files(setup, tmp_path):
    """process_frames_batched at batch 2 writes the npy files the one-frame
    runner writes; a chunk that raises is skipped whole and counted."""
    _, tcfg, params, _, tm, frames = setup
    tp = to_port(params)
    named = [(f"f{i}", f) for i, f in enumerate(frames)]
    one = process_frames(named, str(tmp_path / "one"), FrameProgram(tp, tm, tcfg, "cpu"), K,
                         progress=False)
    pipe = BatchedPipeline(tp, tm, tcfg, batch_size=2, device="cpu")
    st = process_frames_batched(named + [("none", None)], str(tmp_path / "b"), pipe, K,
                                progress=False)
    assert (st.frames, st.hands, st.skipped) == (one.frames, one.hands, 1)
    for i in range(3):
        a = load_hand_npy(str(tmp_path / "one" / f"f{i}.npy"))
        b = load_hand_npy(str(tmp_path / "b" / f"f{i}.npy"))
        for side in a:
            assert (a[side] is None) == (b[side] is None)
            if a[side] is not None:
                for k in ("betas", "theta", "cam_t"):
                    np.testing.assert_allclose(b[side][k], a[side][k], rtol=1e-4, atol=1e-4)
    assert sorted(os.listdir(tmp_path / "b" / "obj")) == sorted(os.listdir(tmp_path / "one" / "obj"))
    bad = [(f"g{i}", f) for i, f in enumerate(frames)]
    bad[1] = ("g1", frames[1].astype(np.float32) + 1000.0)  # F2: raises in its chunk
    st = process_frames_batched(bad, str(tmp_path / "c"), pipe, K, progress=False)
    assert (st.frames, st.skipped) == (1, 2)
    assert sorted(os.listdir(tmp_path / "c")) == ["g2.npy", "obj"]


def _ticks_of(pipe, frames_by_src, n_ticks):
    """stream_multi over iterator sources of the given frames, every frame
    buffered (no drops), as a list of ticks; a dry source sits a tick out
    after a 2 s wait."""
    return list(pipe.stream_multi([iter(f) for f in frames_by_src], K, max_batches=n_ticks,
                                  timeout=2.0, buffer=len(frames_by_src[0])))


@pytest.fixture(scope="module")
def multi(setup):
    """Three static sources (the setup's frames, as JAX's own cadence test
    streams static frames), the third one shorter: two ticks with all
    three, then two with the first two."""
    frames = setup[-1]
    return [[frames[0]] * 4, [frames[1]] * 4, [frames[2]] * 2]


def test_stream_multi_matches_jax(setup, multi):
    """detect_every=2 over three synthetic sources, the port against JAX's
    stream_multi: the same source_idx and detected lists per tick (keyframes
    on ticks 0 and 2, none between), and the same slots (f32 reassociation,
    root depth at 2e-3), tracked ticks included."""
    jcfg, tcfg, params, jm, tm, _ = setup
    jpipe = JaxBatchedPipeline(jax.tree_util.tree_map(jnp.asarray, params), jm, jcfg,
                               batch_size=3, bucket_hw=(130, 130), detect_every=2)
    pipe = BatchedPipeline(to_port(params), tm, tcfg, batch_size=3, bucket_hw=(130, 130),
                           detect_every=2, device="cpu")
    ref, got = _ticks_of(jpipe, multi, 4), _ticks_of(pipe, multi, 4)
    assert [t["source_idx"] for t in got] == [t["source_idx"] for t in ref] == \
        [[0, 1, 2], [0, 1, 2], [0, 1], [0, 1]]
    assert [t["detected"] for t in got] == [t["detected"] for t in ref] == \
        [[0, 1, 2], [], [0, 1], []]
    for n, (g, r) in enumerate(zip(got, ref)):
        assert set(g["outputs"]) == set(r["outputs"])
        for j in range(len(r["source_idx"])):
            rj = {k: np.asarray(v[j]) for k, v in r["outputs"].items()}
            gj = {k: v[j] for k, v in g["outputs"].items()}
            depth = rj.pop("root_depth")
            _same_slots(gj, rj, f"tick {n} source {j}")
            _same_slots({"root_depth": gj["root_depth"], "boxes": gj["boxes"],
                         "valid": gj["valid"]},
                        {"root_depth": depth, "boxes": rj["boxes"], "valid": rj["valid"]},
                        f"tick {n} source {j} depth", atol=2e-3)
    assert (pipe.last_stats.frames, pipe.last_stats.batches) == (10, 4)


def test_stream_multi_keyframes_equal_process_batch(setup, multi):
    """A keyframe tick is the detect program on the tick's frames, bit for
    bit; a tracked tick carries the keyframe's validity; detect_every=1
    detects on every tick and has no "detected" entry."""
    _, tcfg, params, _, tm, _ = setup
    pipe = BatchedPipeline(to_port(params), tm, tcfg, batch_size=3, bucket_hw=(130, 130),
                           detect_every=2, device="cpu")
    ticks = _ticks_of(pipe, multi, 3)
    ref = pipe.process_batch([f[2] for f in multi[:2]], K)
    for k, v in ticks[2]["outputs"].items():
        np.testing.assert_array_equal(v, ref[k], err_msg=k)
    np.testing.assert_array_equal(ticks[1]["outputs"]["valid"], ticks[0]["outputs"]["valid"])
    every = BatchedPipeline(to_port(params), tm, tcfg, batch_size=3, bucket_hw=(130, 130),
                            device="cpu")
    plain = _ticks_of(every, multi, 2)
    assert all("detected" not in t for t in plain)
    for k, v in plain[0]["outputs"].items():
        np.testing.assert_array_equal(v, ticks[0]["outputs"][k], err_msg=k)


def test_bucket_and_upload_dtype_pinned(setup):
    """bucket_hw pads every batch to one shape (a frame that does not fit
    raises); upload_dtype="uint8" uploads integral float frames as uint8,
    with the outputs of the same frames given as uint8."""
    _, tcfg, params, _, tm, frames = setup
    tp = to_port(params)
    pinned = BatchedPipeline(tp, tm, tcfg, batch_size=3, bucket_hw=(160, 160),
                             upload_dtype="uint8", device="cpu")
    images, hws, _ = pinned._pad_frames([f.astype(np.float32) for f in frames], K)
    assert images.shape == (3, 160, 160, 3) and images.dtype == np.uint8
    np.testing.assert_array_equal(hws, [f.shape[:2] for f in frames])
    a = pinned.process_batch([f.astype(np.float32) for f in frames], K)
    b = pinned.process_batch(frames, K)
    for k in a:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    with pytest.raises(ValueError, match="does not fit the bucket"):
        BatchedPipeline(tp, tm, tcfg, batch_size=3, bucket_hw=(96, 96),
                        device="cpu").process_batch(frames, K)


@pytest.mark.parametrize("depth", [1, 3])
def test_stream_depth_keeps_order(setup, depth):
    """stream with ``depth`` batches in flight yields the batches in order,
    each equal to process_batch of its frames."""
    _, tcfg, params, _, tm, frames = setup
    pipe = BatchedPipeline(to_port(params), tm, tcfg, batch_size=1, device="cpu")
    outs = list(pipe.stream(iter(frames), K, depth=depth))
    assert len(outs) == 3
    for f, o in zip(frames, outs):
        ref = pipe.process_batch([f], K)
        for k in ref:
            np.testing.assert_array_equal(o[k], ref[k], err_msg=k)


def _video(path, frames):
    import cv2

    h, w = frames[0].shape[:2]
    out = cv2.VideoWriter(str(path), cv2.VideoWriter_fourcc(*"MJPG"), 10, (w, h))
    for f in frames:
        out.write(f)
    out.release()


def test_cli_serve(tmp_path, capsys):
    """``serve`` over an image dir in batches of 2 and ``serve --multi
    --detect-every 2`` over two video files, through cli.main on the CPU:
    JAX's output lines."""
    import cv2

    from hamer_yolo_tpu_torch.cli.main import main

    rng = np.random.default_rng(2)
    (tmp_path / "in").mkdir()
    for i in range(3):
        cv2.imwrite(str(tmp_path / "in" / f"f{i}.png"),
                    rng.integers(0, 256, (120, 160, 3), dtype=np.uint8))
    common = ["--tiny", "--device", "cpu", "--max-hands", "2"]
    assert main(["serve", "--input", str(tmp_path / "in"), "--batch", "2", *common]) == 0
    lines = capsys.readouterr().out.strip().splitlines()
    assert [ln.split(",")[0] for ln in lines[:2]] == ["batch: 2 frames", "batch: 1 frames"]
    assert lines[-1].startswith("3 frames in ") and lines[-1].endswith(" fps")
    for j in range(2):
        _video(tmp_path / f"s{j}.avi",
               [rng.integers(0, 256, (120, 160, 3), dtype=np.uint8) for _ in range(3)])
    srcs = f"{tmp_path / 's0.avi'},{tmp_path / 's1.avi'}"
    assert main(["serve", "--multi", "--input", srcs, "--detect-every", "2", "--max-frames", "3",
                 *common]) == 0
    lines = capsys.readouterr().out.strip().splitlines()
    assert [ln.split(" (detected")[1] for ln in lines[:3]] == [": [0, 1])", ": [])", ": [0, 1])"]
    assert all(ln.startswith("tick: sources [0, 1], ") for ln in lines[:3])
    assert lines[-1].startswith("6 frames in ")


def _cam_t_limit(pred_cam, cam_t):
    """ROADMAP F14: the f32 limit of a slot's cam_t, propagated from that of
    its pred_cam (s, px, py) through the lift. cam_t's z is 2 f / (s b) and
    its x, y are p + 2 (box centre - principal point) / (s b), b the box
    size, so an error d in s moves them by about |cam_t - (px, py, 0)| d / s:
    the limit scales with 1 / (s b) through cam_t itself."""
    s = abs(float(pred_cam[0]))
    lever = np.abs(np.asarray(cam_t, np.float64) - [pred_cam[1], pred_cam[2], 0.0]).max()
    return 1e-4 * (1.0 + lever / s)


def _kp2d_limit(kp2d, cam_t, cam_limit):
    """The limit of the full-image keypoints that project kp3d + cam_t:
    x = f (X + tx) / (Z + tz) + c moves by about (f + |x - c|) / tz per unit
    of cam_t (|X|, |Z| << tz at these crops), on top of _same_slots' 1e-4."""
    lever = K[0, 0] + np.abs(np.asarray(kp2d, np.float64) - K[:2, 2]).max()
    return 1e-4 + lever / abs(float(cam_t[2])) * cam_limit


@pytest.mark.parametrize("frame_seed", [0, 1, 2, 3, 4])
def test_process_batch_matches_jax_on_any_frames(setup, frame_seed):
    """F14: the port's BatchedPipeline against JAX's on random 96 x 128 frames
    of any seed: every field at _same_slots' limits but cam_t, which is held
    to _cam_t_limit of the slot's own pred_cam and cam_t (JAX's), and the
    keypoints projected with it, held to _kp2d_limit."""
    jcfg, tcfg, params, jm, tm, _ = setup
    rng = np.random.default_rng(100 + frame_seed)
    frames = [rng.integers(0, 256, (96, 128, 3), dtype=np.uint8) for _ in range(4)]
    ref = JaxBatchedPipeline(jax.tree_util.tree_map(jnp.asarray, params), jm, jcfg,
                             batch_size=4).process_batch(frames, K)
    got = BatchedPipeline(to_port(params), tm, tcfg, batch_size=4,
                          device="cpu").process_batch(frames, K)
    n = 0
    for b in range(4):
        r = {k: np.asarray(v[b]) for k, v in ref.items()}
        g = {k: v[b] for k, v in got.items()}
        r_cam, r_kp2d, depth = r.pop("cam_t"), r.pop("keypoints_2d"), r.pop("root_depth")
        _same_slots({k: g[k] for k in r}, r, f"seed {frame_seed} frame {b}")
        _same_slots({"root_depth": g["root_depth"], "boxes": g["boxes"], "valid": g["valid"]},
                    {"root_depth": depth, "boxes": r["boxes"], "valid": r["valid"]},
                    f"seed {frame_seed} frame {b} depth", atol=2e-3)
        for i in np.flatnonzero(r["valid"]):
            j = np.flatnonzero(g["valid"] & (g["boxes"] == r["boxes"][i]).all(-1))[0]
            lim = _cam_t_limit(r["pred_cam"][i], r_cam[i])
            np.testing.assert_allclose(g["cam_t"][j], r_cam[i], rtol=1e-4, atol=lim,
                                       err_msg=f"seed {frame_seed} frame {b} slot {i} cam_t")
            np.testing.assert_allclose(g["keypoints_2d"][j], r_kp2d[i], rtol=1e-4,
                                       atol=_kp2d_limit(r_kp2d[i], r_cam[i], lim),
                                       err_msg=f"seed {frame_seed} frame {b} slot {i} kp2d")
            n += 1
    assert n, "no valid slot: the comparison would be empty"
