"""The bounded graph cache of pipeline/captured.py (ROADMAP F15) on the CPU:
the LRU bookkeeping that CapturedProgram keeps its graphs in, its eviction
order and bound, and the program's bound. The graphs themselves exist only on
the card (chip_smoke.py's phase "graph cache")."""
import numpy as np
import torch

from hamer_yolo_tpu_torch.pipeline import captured
from hamer_yolo_tpu_torch.pipeline.captured import MAX_GRAPHS, CapturedProgram, LruCache
from hamer_yolo_tpu_torch.pipeline.runner import DEFAULT_BUCKETS


def _cache(capacity):
    made, released = [], []

    def make(key):
        made.append(key)
        return f"value {key}"

    cache = LruCache(capacity, lambda k, v: released.append((k, v)))
    return cache, made, released, lambda key: cache.get(key, lambda: make(key))


def test_evicts_the_least_recently_used():
    cache, made, released, get = _cache(3)
    for k in "abc":
        assert get(k) == (f"value {k}", True)
    assert get("a") == ("value a", False)        # a is now the most recent
    assert cache.keys() == ["b", "c", "a"]
    get("d")                                      # evicts b, the least recent
    assert released == [("b", "value b")] and cache.keys() == ["c", "a", "d"]
    get("b")                                      # b made again, c goes
    assert released[-1] == ("c", "value c") and made == list("abcdb")
    assert len(cache) == 3 and cache.keys() == ["a", "d", "b"]


def test_never_holds_more_than_capacity():
    cache, made, released, get = _cache(MAX_GRAPHS)
    keys = [(h, w) for h in range(4) for w in range(5)]
    for i, k in enumerate(keys + keys[:3]):
        get(k)
        assert len(cache) == min(i + 1, MAX_GRAPHS)
    assert len(made) - len(released) == MAX_GRAPHS
    assert [k for k, _ in released] == (keys + keys[:3])[:len(released)]


def test_the_default_buckets_fit():
    """MAX_GRAPHS keeps the five default buckets of one batch and upload
    dtype at once, with room for three more keys."""
    assert MAX_GRAPHS >= len(DEFAULT_BUCKETS) + 3


def test_cpu_program_runs_eagerly_and_keeps_no_graph(monkeypatch):
    """On the CPU there is nothing to cache: the function runs on every call."""
    calls = []
    prog = CapturedProgram("test", lambda a: calls.append(a.shape) or {"y": a * 2}, "cpu")
    for n in range(MAX_GRAPHS + 2):
        out = prog(np.ones((n + 1, 2), np.float32))
        assert torch.equal(out["y"], torch.full((n + 1, 2), 2.0))
    assert len(calls) == MAX_GRAPHS + 2 and len(prog._graphs) == 0
    assert prog.pool_bytes == {} and captured.SLOTS == 2
