"""The benchmark's cache of its own generated data, ``portbench/.cache``.

Each entry is one ``.npz`` of arrays at a fixed path made from its kind
and a hash of the parameters that generate it (the collection of a
configuration and data seed; the reference index built from it; the
reference's fits), so
every run of a cell in one checkout after the first reads it.  Nothing
the program makes is kept here.
"""

from __future__ import annotations

import hashlib
import json
import os
from pathlib import Path

import numpy as np

CACHE_DIR = Path(__file__).resolve().parents[1] / ".cache"


def _path(kind: str, key: dict) -> Path:
    digest = hashlib.sha256(json.dumps(key, sort_keys=True).encode())
    return CACHE_DIR / f"{kind}-{digest.hexdigest()[:16]}.npz"


def cached(kind: str, key: dict, build) -> dict:
    """The arrays ``build()`` returns for ``key``: read from the cache, or
    built and written there (to a temporary name in the same directory,
    then renamed)."""
    path = _path(kind, key)
    if path.is_file():
        with np.load(path) as f:
            return {k: f[k] for k in f.files}
    arrays = build()
    CACHE_DIR.mkdir(parents=True, exist_ok=True)
    tmp = path.with_suffix(".tmp.npz")
    np.savez(tmp, **arrays)
    os.replace(tmp, path)
    return arrays
