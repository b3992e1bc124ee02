"""The once-per-weight casts of the port (core/nn.cast_weight, K2's
ops/attn_block.bf16_weight) on CPU tensors: one copy per weight and dtype,
a new copy after an in-place change, the count of casts, the copy freed with
its weight, and nn.linear's values unchanged by the cache."""
import gc

import numpy as np
import pytest
import torch

from hamer_yolo_tpu_torch.core import nn
from hamer_yolo_tpu_torch.ops import attn_block


def _w(seed, shape=(48, 96)):
    return torch.from_numpy(np.random.default_rng(seed).normal(size=shape).astype(np.float32))


def test_one_copy_per_weight_and_dtype():
    w = _w(0)
    before = nn.cast_weight.casts
    first = nn.cast_weight(w, torch.bfloat16)
    assert first.dtype == torch.bfloat16 and torch.equal(first, w.to(torch.bfloat16))
    assert nn.cast_weight(w, torch.bfloat16) is first
    assert nn.cast_weight.casts == before + 1
    half = nn.cast_weight(w, torch.float16)  # another dtype: its own copy
    assert half.dtype == torch.float16 and nn.cast_weight.casts == before + 2
    assert nn.cast_weight(w, torch.float32) is w  # no cast to the weight's own dtype
    assert nn.cast_weight.casts == before + 2


def test_new_copy_after_an_in_place_change():
    w = _w(1)
    first = nn.cast_weight(w, torch.bfloat16)
    before = nn.cast_weight.casts
    w.mul_(2.0)
    again = nn.cast_weight(w, torch.bfloat16)
    assert again is not first and nn.cast_weight.casts == before + 1
    assert torch.equal(again, w.to(torch.bfloat16))
    assert nn.cast_weight(w, torch.bfloat16) is again


def test_copy_freed_with_its_weight():
    w = _w(2)
    nn.cast_weight(w, torch.bfloat16)
    key = (id(w), torch.bfloat16)
    assert key in nn._DERIVED
    del w
    gc.collect()
    assert key not in nn._DERIVED


def test_tracked_weight_is_cast_per_call():
    """A weight whose cast autograd would track gets a fresh cast each call,
    so a backward pass never reaches a stale graph."""
    w = _w(3).requires_grad_()
    before = nn.cast_weight.casts
    a, b = nn.cast_weight(w, torch.bfloat16), nn.cast_weight(w, torch.bfloat16)
    assert a is not b and a.requires_grad and nn.cast_weight.casts == before
    with torch.no_grad():
        assert nn.cast_weight(w, torch.bfloat16) is nn.cast_weight(w, torch.bfloat16)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_linear_casts_once_and_keeps_its_values(dtype):
    p = {"w": _w(4), "b": _w(5, (96,))}
    x = _w(6, (5, 48)).to(dtype)
    want = x @ p["w"].to(dtype) + p["b"].to(dtype)
    before = nn.cast_weight.casts
    for _ in range(3):
        assert torch.equal(nn.linear(p, x), want)
    assert nn.cast_weight.casts == before + (2 if dtype != torch.float32 else 0)


def test_k2_weight_shares_the_cast():
    """K2's bf16 weight is nn.cast_weight's copy, made once (no TMA map for a
    CPU weight)."""
    w = _w(7)
    before = nn.cast_weight.casts
    w16 = attn_block.bf16_weight(w)
    assert w16 is attn_block.bf16_weight(w) and w16 is nn.cast_weight(w, torch.bfloat16)
    assert attn_block._bf16_weight(w)[1] is None
    assert nn.cast_weight.casts == before + 1
    assert w16.is_contiguous() and w16.data_ptr() % 16 == 0
