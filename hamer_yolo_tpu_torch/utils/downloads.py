"""Checkpoint resolution / download helpers, host side, the fetch gated off
(port of hamer_yolo_tpu/utils/downloads.py; it imports no JAX, and the port
keeps its own copy).

Parity target: reference yolo/yolov7/utils/google_utils.py
(attempt_download:19 — resolve a weights path, fetch the known release
asset if missing, delete partial downloads) and the aws/resume.py
"find the checkpoint" posture.

Redesigned for this environment: network egress is not assumed, so the
resolver is cache-first (explicit path → search-dir cache → $HYT_WEIGHTS
→ optional URL fetch only when ``allow_download=True``), every fetch is
atomic (tempfile + rename, partials never land at the target path), and
integrity is a real sha256 check instead of a >1 MB size heuristic.
The cache directory is the JAX package's (~/.cache/hamer_yolo_tpu), so the
two packages find the same files.
"""
from __future__ import annotations

import hashlib
import os
import shutil
import tempfile
from typing import Dict, Iterable, Optional

# The reference's known release assets (google_utils.py:33) plus this
# pipeline's own checkpoints (config/yolo_config.py:5, hamer_config.py:6,
# sar_config_stage_1.py:22).
KNOWN_ASSETS: Dict[str, str] = {
    name: f"https://github.com/WongKinYiu/yolov7/releases/download/v0.1/{name}"
    for name in ("yolov7.pt", "yolov7-tiny.pt", "yolov7x.pt", "yolov7-d6.pt",
                 "yolov7-e6.pt", "yolov7-e6e.pt", "yolov7-w6.pt")
}
PIPELINE_WEIGHTS = ("yolov7_best.pt", "hamer.ckpt", "SAR-resnet34-Root.pth",
                    "MANO_RIGHT.pkl", "mano_mean_params.npz")


def sha256(path: str, chunk: int = 1 << 20) -> str:
    h = hashlib.sha256()
    with open(path, "rb") as f:
        while True:
            b = f.read(chunk)
            if not b:
                break
            h.update(b)
    return h.hexdigest()


def _search_dirs(extra: Iterable[str] = ()) -> list:
    dirs = list(extra)
    env = os.environ.get("HYT_WEIGHTS")
    if env:
        dirs.extend(env.split(os.pathsep))
    dirs.append(os.path.join(os.path.expanduser("~"), ".cache",
                             "hamer_yolo_tpu"))
    return [d for d in dirs if d]


def find_weights(name_or_path: str, search: Iterable[str] = ()) -> Optional[str]:
    """Resolve a checkpoint: explicit path, then cache/search dirs.

    Returns the first existing path or None (never raises — callers fall
    back to the seeded weights).
    """
    if os.path.isfile(name_or_path):
        return name_or_path
    base = os.path.basename(name_or_path)
    for d in _search_dirs(search):
        cand = os.path.join(d, base)
        if os.path.isfile(cand):
            return cand
    return None


def attempt_download(name_or_path: str,
                     url: Optional[str] = None,
                     sha256_hex: Optional[str] = None,
                     search: Iterable[str] = (),
                     allow_download: bool = False,
                     dest_dir: Optional[str] = None) -> Optional[str]:
    """Reference attempt_download semantics, cache-first and egress-gated.

    1. Resolve locally (``find_weights``). 2. If missing and the name is a
    known asset (or ``url`` given) and ``allow_download`` (or
    $HYT_ALLOW_DOWNLOAD=1): fetch atomically, verify ``sha256_hex`` if
    provided, and place it in ``dest_dir`` (default: the user cache dir).
    Partial/invalid downloads never survive at the destination.
    """
    corrupt_cached = None  # resolver-owned bad copy; removed only AFTER
    #                        a verified replacement lands
    found = find_weights(name_or_path, search)
    if found is not None:
        if sha256_hex and sha256(found) != sha256_hex.lower():
            # Reference attempt_download deletes a bad file and re-fetches
            # (google_utils.py: os.remove on failed check). Mirror that —
            # a corrupted cache entry must not permanently block
            # resolution — but ONLY for files this resolver itself
            # manages: the user cache dir and an explicit ``dest_dir``
            # (its own download destinations). User-owned locations
            # ($HYT_WEIGHTS, caller search dirs, explicit paths) raise
            # instead of being deleted.
            owned = [os.path.join(os.path.expanduser("~"), ".cache",
                                  "hamer_yolo_tpu")]
            if dest_dir:
                owned.append(dest_dir)
            refetchable = (
                (url or KNOWN_ASSETS.get(os.path.basename(name_or_path)))
                is not None
                and (allow_download
                     or os.environ.get("HYT_ALLOW_DOWNLOAD") == "1"))
            if refetchable and os.path.dirname(os.path.abspath(found)) in (
                    os.path.abspath(d) for d in owned):
                # Re-fetch below; the corrupt cached copy survives UNTIL
                # the verified replacement lands (a failed download must
                # not destroy the only copy) — the atomic os.replace
                # overwrites it in place, or a stale different-path copy
                # is unlinked after success.
                corrupt_cached = os.path.abspath(found)
                found = None
            else:
                raise ValueError(f"checksum mismatch for {found}")
        if found is not None:
            return found

    base = os.path.basename(name_or_path)
    url = url or KNOWN_ASSETS.get(base)
    gated = allow_download or os.environ.get("HYT_ALLOW_DOWNLOAD") == "1"
    if url is None or not gated:
        return None

    dest_dir = dest_dir or _search_dirs()[-1]
    os.makedirs(dest_dir, exist_ok=True)
    target = os.path.join(dest_dir, base)
    import urllib.request

    fd, tmp = tempfile.mkstemp(dir=dest_dir, suffix=".part")
    os.close(fd)
    try:
        with urllib.request.urlopen(url, timeout=60) as r, \
                open(tmp, "wb") as f:
            shutil.copyfileobj(r, f)
        if sha256_hex and sha256(tmp) != sha256_hex.lower():
            raise ValueError(f"checksum mismatch downloading {url}")
        os.replace(tmp, target)  # atomic: no partials at target
        if corrupt_cached and corrupt_cached != os.path.abspath(target) \
                and os.path.exists(corrupt_cached):
            os.unlink(corrupt_cached)  # replacement verified: drop stale copy
        return target
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
