"""io/video.py in the port: iter_media against the JAX package's on the same
temp dirs (images, a video file, a glob, max_frames), MultiStreamReader on
synthetic streams (order per source, one frame per source a tick, dry
sources end the batches, threads stopped by close), StreamReader on a video
file. On the CPU; every wait has a limit."""
import time

import numpy as np
import pytest

from hamer_yolo_tpu.io.video import iter_media as jax_iter_media
from hamer_yolo_tpu_torch.io.video import MultiStreamReader, StreamReader, iter_media


@pytest.fixture(scope="module")
def media(tmp_path_factory):
    import cv2

    root = tmp_path_factory.mktemp("media")
    rng = np.random.default_rng(0)
    for i in range(3):
        cv2.imwrite(str(root / f"img{i}.png"), rng.integers(0, 256, (40, 56, 3), dtype=np.uint8))
    (root / "notes.txt").write_text("not an image")
    (root / "broken.jpg").write_bytes(b"not a jpeg")
    video = cv2.VideoWriter(str(root / "vid.avi"), cv2.VideoWriter_fourcc(*"MJPG"), 10, (56, 40))
    for i in range(4):
        video.write(np.full((40, 56, 3), 40 * i, np.uint8))
    video.release()
    return root


@pytest.mark.parametrize("which,max_frames", [("dir", None), ("dir", 2), ("dir", 5),
                                              ("video", None), ("glob", None), ("image", 1)])
def test_iter_media_matches_jax(media, which, max_frames):
    source = {"dir": str(media), "video": str(media / "vid.avi"),
              "glob": str(media / "img*.png"), "image": str(media / "img1.png")}[which]
    got = list(iter_media(source, max_frames))
    ref = list(jax_iter_media(source, max_frames))
    assert len(got) == len(ref) > 0
    for g, r in zip(got, ref):
        np.testing.assert_array_equal(g, r)
    if which == "dir" and max_frames is None:
        assert len(got) == 3 + 4  # the broken jpg and the txt are skipped


def _synthetic_stream(source_id: int, n_frames: int, hz: float = 30.0, hw=(48, 64)):
    """Frames stamped with (source_id, frame_idx) in the top-left pixels."""
    for f in range(n_frames):
        img = np.zeros(hw + (3,), np.uint8)
        img[0, 0, 0] = source_id
        img[0, 1, 0] = f
        yield img
        time.sleep(1.0 / hz)


def test_four_streams_in_order():
    """Four 30 fps streams: every tick has one frame of each source, each
    source's frames in order, none dropped (the buffer holds them all)."""
    n = 8
    reader = MultiStreamReader([_synthetic_stream(s, n) for s in range(4)], buffer=16)
    try:
        batches = list(reader.batches(max_batches=n, timeout=5.0))
    finally:
        reader.close()
    assert len(batches) == n
    last = [-1] * 4
    for batch in batches:
        assert len(batch) == 4
        for s, frame in enumerate(batch):
            assert int(frame[0, 0, 0]) == s
            assert int(frame[0, 1, 0]) == last[s] + 1
            last[s] += 1
    assert last == [n - 1] * 4


def test_dry_sources_end_the_batches_and_close_stops_threads():
    """A short source sits ticks out (None) while a longer one goes on;
    when both are dry the batches end; close() stops every thread, also one
    whose generator would run on."""
    def endless():
        while True:
            yield np.zeros((8, 8, 3), np.uint8)
            time.sleep(0.01)

    reader = MultiStreamReader([_synthetic_stream(0, 1, hz=100.0),
                                _synthetic_stream(1, 3, hz=100.0)], buffer=8)
    try:
        batches = list(reader.batches(timeout=1.0))
    finally:
        reader.close()
    assert [b[1] is not None for b in batches] == [True] * 3
    assert [b[0] is not None for b in batches] == [True, False, False]
    live = MultiStreamReader([endless()], buffer=2)
    assert next(live.batches(timeout=5.0))[0].shape == (8, 8, 3)
    live.close()
    assert not any(t.is_alive() for t in live._threads)


def test_buffer_keeps_the_newest_frames():
    """A full ring drops its oldest frame (a live source is read at the
    consumer's rate)."""
    reader = MultiStreamReader([_synthetic_stream(0, 6, hz=1000.0)], buffer=2)
    try:
        deadline = time.time() + 5.0
        while len(reader._buffers[0]) < 2 or reader._threads[0].is_alive():
            assert time.time() < deadline
            time.sleep(0.01)
        got = [int(reader.read_batch(timeout=1.0)[0][0, 1, 0]) for _ in range(2)]
        assert got == [4, 5]
        assert reader.read_batch(timeout=0.1) == [None]
    finally:
        reader.close()


def test_stream_reader_on_a_video_file(media):
    """StreamReader hands out the latest frame and None once the capture
    has nothing new within the timeout; close() stops its thread."""
    reader = StreamReader(str(media / "vid.avi"))
    try:
        first = reader.read(timeout=5.0)
        assert first is not None and first.shape == (40, 56, 3)
        deadline = time.time() + 10.0
        while reader.read(timeout=0.2) is not None:
            assert time.time() < deadline
    finally:
        reader.close()
    assert not reader._thread.is_alive()
    with pytest.raises(RuntimeError, match="cannot open stream"):
        StreamReader(str(media / "missing.avi"))
