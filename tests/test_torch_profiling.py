"""utils/profiling (StageTimer, benchmark, compiled_flops) and utils/downloads
of the port against the JAX package's: compiled_flops against XLA's cost
analysis (JAX's compiled_flops) on a matmul, a padded convolution and a
tiny ViT forward; the downloads cases of tests/test_downloads.py run on the
port's module, with urlopen monkeypatched: nothing is fetched."""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import test_downloads as jax_downloads
from hamer_yolo_tpu.utils.profiling import compiled_flops as jax_compiled_flops
from hamer_yolo_tpu_torch.core import nn
from hamer_yolo_tpu_torch.utils import downloads
from hamer_yolo_tpu_torch.utils.profiling import StageTimer, benchmark, compiled_flops
from test_downloads import _isolate_caches  # noqa: F401  (the JAX cases' autouse fixture)
from test_torch_bridge import numpy_params, to_port

torch.set_num_threads(1)

# A whole forward: XLA also counts elementwise flops (the port counts the
# products only) and fuses ops (the port counts every op's operands and
# results). Measured on the tiny f32 ViT below: 0.88x the flops, 1.77x the
# bytes; the limits leave room for the libraries' versions.
FORWARD_FLOPS_RATIO = (0.8, 1.0)
FORWARD_BYTES_RATIO = (1.0, 2.5)


def _rng(seed, *shape):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


def test_compiled_flops_matmul_matches_xla():
    """f32 (64 x 128) @ (128 x 32): 524,288 flops, 57,344 bytes (operands + result)."""
    a, b = _rng(0, 64, 128), _rng(1, 128, 32)
    ref = jax_compiled_flops(lambda x, y: x @ y, jnp.asarray(a), jnp.asarray(b))
    got = compiled_flops(lambda x, y: x @ y, torch.from_numpy(a), torch.from_numpy(b))
    assert got == ref == {"flops": 524288.0, "bytes_accessed": 57344.0}


@pytest.mark.parametrize("padding", [1, "SAME"])
def test_compiled_flops_padded_conv_matches_xla(padding):
    """3 x 3 SAME conv (2, 16, 16, 8) -> 4: XLA counts the taps inside the
    image only (270,848 flops, not FlopCounterMode's 294,912) and folds the
    pad (25,728 bytes); the port's int padding and its "SAME" (a zero pad
    before the conv) both count so."""
    from hamer_yolo_tpu.core import nn as jnn

    x, w = _rng(2, 2, 16, 16, 8), _rng(3, 3, 3, 8, 4)
    ref = jax_compiled_flops(lambda xx, ww: jnn.conv2d({"w": ww}, xx, padding="SAME"),
                             jnp.asarray(x), jnp.asarray(w))
    tw = torch.from_numpy(w.transpose(3, 2, 0, 1).copy())
    got = compiled_flops(lambda xx, ww: nn.conv2d({"w": ww}, xx, padding=padding),
                         torch.from_numpy(x), tw)
    assert got == ref == {"flops": 270848.0, "bytes_accessed": 25728.0}


def test_compiled_flops_whole_forward_within_the_stated_gap():
    from hamer_yolo_tpu.models.vit import ViTConfig as JV
    from hamer_yolo_tpu.models.vit import init_vit, vit_forward as jvit
    from hamer_yolo_tpu_torch.models.vit import ViTConfig as TV
    from hamer_yolo_tpu_torch.models.vit import vit_forward

    shape = dict(img_size=(64, 48), embed_dim=64, depth=2, num_heads=4, compute_dtype="float32")
    jc, tc = JV(**shape), TV(**shape, fused_attn=False)
    p = numpy_params(lambda k: init_vit(k, jc), 0)
    x = _rng(4, 2, 64, 48, 3)
    ref = jax_compiled_flops(lambda pp, xx: jvit(pp, xx, jc),
                             jax.tree_util.tree_map(jnp.asarray, p), jnp.asarray(x))
    tp = to_port(p)
    got = compiled_flops(lambda xx: vit_forward(tp, xx, tc), torch.from_numpy(x))
    flops, nbytes = got["flops"] / ref["flops"], got["bytes_accessed"] / ref["bytes_accessed"]
    assert FORWARD_FLOPS_RATIO[0] <= flops <= FORWARD_FLOPS_RATIO[1], (got, ref)
    assert FORWARD_BYTES_RATIO[0] <= nbytes <= FORWARD_BYTES_RATIO[1], (got, ref)


def test_stage_timer_and_benchmark():
    """JAX's report layout and the benchmark's keys; on the CPU nothing is
    synchronized (the CUDA devices of the outputs are waited for)."""
    timer = StageTimer()
    x = torch.ones(64, 64)
    for name in ("a", "b"):
        timer.start(name)
        y = x @ x
        assert timer.stop(y) >= 0.0
    lines = timer.report().splitlines()
    assert [ln.split()[0] for ln in lines] == ["a", "b", "total"]
    assert lines[0].endswith("%") and "ms" in lines[-1]
    calls = []
    res = benchmark(lambda v: calls.append(1) or {"y": v @ v}, x, iters=4, warmup=2)
    assert len(calls) == 6 and set(res) == {"p50_ms", "p90_ms", "mean_ms"}
    assert 0.0 <= res["p50_ms"] <= res["p90_ms"]


@pytest.fixture(autouse=True)
def _port_module(monkeypatch):
    """The JAX downloads cases below run on the port's module."""
    monkeypatch.setattr(jax_downloads, "dl", downloads)


class TestFindWeights(jax_downloads.TestFindWeights):
    """tests/test_downloads.py's resolver cases on the port."""


class TestAttemptDownload(jax_downloads.TestAttemptDownload):
    """tests/test_downloads.py's fetch cases on the port (urlopen faked)."""


def test_downloads_tables_match_jax():
    from hamer_yolo_tpu.utils import downloads as jdl

    assert downloads.KNOWN_ASSETS == jdl.KNOWN_ASSETS
    assert downloads.PIPELINE_WEIGHTS == jdl.PIPELINE_WEIGHTS
