"""The port's HTTP front end (pipeline/http_server.py) on the CPU: the
micro-batcher's batching, ``_hands_json`` against the JAX package's on the
same outputs, the endpoints of a running server (400 on a bad payload), F13's
intrinsics of a mixed-size batch against JAX's, and ``serve-http`` through
cli.main. Every wait has a limit; servers shut down in ``finally``."""
import json
import threading
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

from hamer_yolo_tpu.pipeline.http_server import MicroBatcher as JaxMicroBatcher
from hamer_yolo_tpu.pipeline.http_server import _hands_json as jax_hands_json
from hamer_yolo_tpu_torch.pipeline import http_server
from hamer_yolo_tpu_torch.pipeline.http_server import (MicroBatcher, _default_K, _hands_json,
                                                      make_http_server)
from hamer_yolo_tpu_torch.pipeline.serving import BatchedPipeline
from test_torch_bridge import mano_pair, pipeline_params, tiny_configs, to_port

torch.set_num_threads(1)
WAIT_S = 120.0  # any single request or join


def _png(img):
    import cv2

    ok, buf = cv2.imencode(".png", img)
    assert ok
    return buf.tobytes()


def _post(url, body, timeout=WAIT_S):
    req = urllib.request.Request(url, data=body, method="POST")
    with urllib.request.urlopen(req, timeout=timeout) as r:
        return r.status, json.loads(r.read())


def _get(url):
    with urllib.request.urlopen(url, timeout=WAIT_S) as r:
        return json.loads(r.read())


@pytest.fixture(scope="module")
def pipe():
    jcfg, tcfg = tiny_configs("float32")
    _, tm = mano_pair()
    return BatchedPipeline(to_port(pipeline_params(jcfg, seed=4, with_sar=True)), tm, tcfg,
                           batch_size=4, device="cpu")


@pytest.fixture(scope="module")
def server(pipe):
    srv = make_http_server(pipe, "127.0.0.1", 0, max_wait_ms=1000.0)
    t = threading.Thread(target=srv.serve_forever, daemon=True)
    t.start()
    try:
        yield srv, f"http://127.0.0.1:{srv.server_address[1]}"
    finally:
        srv.shutdown()
        srv.server_close()
        srv.batcher.close()
        t.join(timeout=WAIT_S)
    assert not t.is_alive() and not srv.batcher._thread.is_alive()


def test_healthz_and_stats(server):
    srv, url = server
    h = _get(url + "/healthz")
    assert h == {"ok": True, "device": "cpu", "device_name": "cpu"}
    s = _get(url + "/stats")
    assert set(s) == {"frames", "batches", "uptime_s", "fps", "batch_size"}
    assert s["batch_size"] == 4
    with pytest.raises(urllib.error.HTTPError) as e:
        _get(url + "/nothing")
    assert e.value.code == 404


def test_concurrent_clients_are_batched(server):
    """Six concurrent POSTs at batch 4 with a 1 s window: valid hands JSON
    for each (with vertices where asked), in two batches."""
    srv, url = server
    rng = np.random.default_rng(0)
    body = _png(rng.integers(0, 256, (96, 128, 3), dtype=np.uint8))
    before = _get(url + "/stats")
    results, errors = [None] * 6, []

    def post(i):
        try:
            results[i] = _post(url + ("/infer?vertices=1" if i == 0 else "/infer"), body)[1]
        except Exception as e:  # reported below
            errors.append(e)

    threads = [threading.Thread(target=post, args=(i,)) for i in range(6)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=WAIT_S)
    assert not errors and not any(t.is_alive() for t in threads)
    for i, res in enumerate(results):
        assert res["height"] == 96 and res["width"] == 128
        assert res["hands"], "the tiny random detector finds hands in every frame"
        for hand in res["hands"]:
            assert hand["side"] in ("left", "right")
            assert len(hand["box"]) == 4 and len(hand["betas"]) == 10
            assert len(hand["theta"]) == 48 and len(hand["cam_t"]) == 3
            assert isinstance(hand["root_depth"], float)
            assert ("vertices" in hand) == (i == 0)
        # the same frame in every request: the same hands, up to the f32 ulps
        # by which a row's place in the batch can move the CPU's sums
        assert [h["side"] for h in res["hands"]] == [h["side"] for h in results[1]["hands"]]
        for h, h1 in zip(res["hands"], results[1]["hands"]):
            for k in ("box", "score", "betas", "theta", "cam_t", "root_depth"):
                np.testing.assert_allclose(h[k], h1[k], rtol=1e-5, atol=1e-5, err_msg=k)
    after = _get(url + "/stats")
    assert after["frames"] - before["frames"] == 6
    assert after["batches"] - before["batches"] == 2


def test_bad_payload_is_400(server):
    _, url = server
    with pytest.raises(urllib.error.HTTPError) as e:
        _post(url + "/infer", b"not-an-image")
    assert e.value.code == 400


@pytest.mark.parametrize("with_depth", [True, False])
@pytest.mark.parametrize("vertices", [True, False])
def test_hands_json_matches_jax(pipe, with_depth, vertices):
    """The same JSON as JAX's _hands_json on one frame's outputs: the same
    key sets, types and values."""
    rng = np.random.default_rng(1)
    out = pipe.process_batch([rng.integers(0, 256, (96, 128, 3), dtype=np.uint8)],
                             _default_K((96, 128)))
    frame = {k: v[0] for k, v in out.items() if with_depth or k != "root_depth"}
    frame["valid"] = frame["valid"].copy()
    frame["valid"][0] = False  # a masked slot is left out
    got, ref = _hands_json(frame, vertices), jax_hands_json(frame, vertices)
    assert got == ref
    assert json.loads(json.dumps(got)) == got
    assert [set(h) for h in got] == [set(h) for h in ref]


class _Recorder:
    """A stand-in pipeline that records the intrinsics of each batch."""
    batch_size = 4
    device = torch.device("cpu")

    def __init__(self):
        self.batches = []

    def process_batch(self, frames, K):
        self.batches.append(([f.shape[:2] for f in frames], np.asarray(K)))
        return {"valid": np.zeros((len(frames), 1), bool)}


def _batch_K(batcher_cls, sizes):
    """(frame sizes in batch order, intrinsics) that a batcher hands the
    pipeline for one batch of frames of ``sizes``, submitted together."""
    rec = _Recorder()
    batcher = batcher_cls(rec, max_wait_ms=1000.0)
    try:
        threads = [threading.Thread(target=batcher.submit, args=(np.zeros(hw + (3,), np.uint8),))
                   for hw in sizes]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=WAIT_S)
        assert not any(t.is_alive() for t in threads)
    finally:
        batcher.close()
    assert len(rec.batches) == 1
    return rec.batches[0]


def test_f13_mixed_size_batch_intrinsics():
    """F13: in a mixed-size micro-batch JAX gives every frame the default
    intrinsics of the first frame's size; the port gives each frame those of
    its own size. A same-size batch gets the same intrinsics from both."""
    sizes = [(96, 128), (96, 128), (60, 200), (300, 80)]
    ref_sizes, ref = _batch_K(JaxMicroBatcher, sizes)
    got_sizes, got = _batch_K(MicroBatcher, sizes)
    assert sorted(ref_sizes) == sorted(got_sizes) == sorted(sizes)
    np.testing.assert_array_equal(ref, _default_K(ref_sizes[0]))
    assert got.shape == (4, 3, 3)
    for k, hw in zip(got, got_sizes):
        np.testing.assert_array_equal(k, _default_K(hw))
    same = [(96, 128)] * 3
    np.testing.assert_array_equal(_batch_K(MicroBatcher, same)[1],
                                  np.broadcast_to(_batch_K(JaxMicroBatcher, same)[1], (3, 3, 3)))


def test_cli_serve_http(monkeypatch):
    """``serve-http --tiny --device cpu --port 0`` through cli.main in a
    thread: one POST answered, then shut down."""
    from hamer_yolo_tpu_torch.cli.main import main

    made = []
    build = http_server.make_http_server
    monkeypatch.setattr(http_server, "make_http_server",
                        lambda *a, **kw: made.append(build(*a, **kw)) or made[-1])
    rcs = []
    t = threading.Thread(target=lambda: rcs.append(main(
        ["serve-http", "--tiny", "--device", "cpu", "--port", "0", "--batch", "2",
         "--max-wait-ms", "5"])), daemon=True)
    t.start()
    try:
        for _ in range(int(WAIT_S * 10)):
            if made or not t.is_alive():
                break
            t.join(timeout=0.1)
        assert made, "the server was not built"
        url = f"http://127.0.0.1:{made[0].server_address[1]}"
        rng = np.random.default_rng(3)
        status, res = _post(url + "/infer",
                            _png(rng.integers(0, 256, (120, 160, 3), dtype=np.uint8)))
        assert status == 200 and (res["height"], res["width"]) == (120, 160)
        assert _get(url + "/stats")["batch_size"] == 2
    finally:
        if made:
            made[0].shutdown()
        t.join(timeout=WAIT_S)
    assert not t.is_alive() and rcs == [0]
