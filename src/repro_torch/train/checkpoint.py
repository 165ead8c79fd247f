"""Fault-tolerant checkpointing: atomic, async, layout-independent.

A port of the reference's ``train/checkpoint.py`` with its behaviour and
its on-disk format, so that each package reads the other's checkpoints:

* **Atomicity** — write to a temp dir, fsync the manifest, then
  ``os.rename`` (POSIX-atomic), so a crash mid-write never corrupts the
  latest checkpoint.
* **Integrity** — a manifest with each array's shape, dtype and sha1 (the
  first 16 hex digits, over its bytes); restore verifies them and falls
  back to the previous step on a mismatch (torn-write detection).
* **Async** — ``save_async`` copies to the host now and hands the disk
  write to a thread (at most one pending write).
* **Layout independence** — arrays are whole, under the keys of
  ``_flatten`` (dict keys sorted, ``/``-joined), in one ``arrays.npz``.
* **Retention** — keep the last ``keep`` checkpoints, deleting older ones
  only after the newest is durable.

bf16: NumPy has no bfloat16 of its own (the reference's comes from
``ml_dtypes``), so a bf16 tensor is written as its raw 2-byte words, an
``np.void`` array of itemsize 2 — what the reference's file holds too —
with the manifest dtype ``"bfloat16"`` and the sha1 of the same bytes.  On
restore a ``"bfloat16"`` entry is read back from those words.  (The
reference's own restore refuses such an entry: JAX takes no void array;
ROADMAP §3.)

``restore_latest(template, device=None, shardings=None)`` puts the arrays
on ``device`` (the card unless the caller names another); a leaf whose
path has a ``NamedSharding`` in ``shardings`` comes back as that DTensor
(``models.common.distribute``: each rank keeps its block of the whole
array it read).
"""

from __future__ import annotations

import hashlib
import json
import os
import shutil
import threading
import time

import numpy as np
import torch

from repro_torch.isn.backend import resolve_device
from repro_torch.models.common import distribute

BF16 = "bfloat16"


def _flatten(tree, prefix=""):
    # dict keys sorted, as the reference flattens (jax's pytree order)
    out = {}
    if isinstance(tree, dict):
        for k in sorted(tree):
            out.update(_flatten(tree[k], f"{prefix}{k}/"))
    elif isinstance(tree, (list, tuple)) and not hasattr(tree, "_fields"):
        for i, v in enumerate(tree):
            out.update(_flatten(v, f"{prefix}{i}/"))
    elif hasattr(tree, "_fields"):
        for k in tree._fields:
            out.update(_flatten(getattr(tree, k), f"{prefix}{k}/"))
    else:
        out[prefix[:-1]] = tree
    return out


def _checksum(a: np.ndarray) -> str:
    return hashlib.sha1(np.ascontiguousarray(a).view(np.uint8)).hexdigest()[:16]


def to_host(x) -> tuple[np.ndarray, str]:
    """(the array as written, its manifest dtype): a bf16 tensor as its raw
    2-byte words."""
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu()
        if x.dtype == torch.bfloat16:
            words = x.contiguous().view(torch.int16).numpy()
            return words.view(np.dtype("V2")), BF16
        x = x.numpy()
    a = np.asarray(x)
    return a, str(a.dtype)


def from_host(a: np.ndarray, dtype: str, device) -> torch.Tensor:
    """An array read from a checkpoint as a tensor on ``device``."""
    if dtype == BF16:
        words = np.ascontiguousarray(a).view(np.int16)
        return torch.from_numpy(words.copy()).view(torch.bfloat16).to(device)
    return torch.from_numpy(np.array(a)).to(device)


class CheckpointManager:
    def __init__(self, directory: str, keep: int = 3):
        self.dir = directory
        self.keep = keep
        os.makedirs(directory, exist_ok=True)
        self._pending: threading.Thread | None = None

    # ---------------- write path ----------------

    def save(self, step: int, tree, extra: dict | None = None):
        self._write(step, self._host(tree), extra or {})

    def save_async(self, step: int, tree, extra: dict | None = None):
        """Device->host copy happens now; disk write on a worker thread."""
        self.wait()
        t = threading.Thread(target=self._write,
                             args=(step, self._host(tree), extra or {}))
        t.start()
        self._pending = t

    @staticmethod
    def _host(tree) -> dict:
        return {k: to_host(v) for k, v in _flatten(tree).items()}

    def wait(self):
        if self._pending is not None:
            self._pending.join()
            self._pending = None

    def _write(self, step: int, arrays: dict, extra: dict):
        tmp = os.path.join(self.dir, f".tmp_step_{step}_{os.getpid()}")
        final = os.path.join(self.dir, f"step_{step:010d}")
        os.makedirs(tmp, exist_ok=True)
        manifest = {"step": step, "time": time.time(), "extra": extra,
                    "arrays": {}}
        np.savez(os.path.join(tmp, "arrays.npz"),
                 **{k: a for k, (a, _) in arrays.items()})
        for k, (a, dtype) in arrays.items():
            manifest["arrays"][k] = {"shape": list(a.shape), "dtype": dtype,
                                     "sha1": _checksum(a)}
        with open(os.path.join(tmp, "manifest.json"), "w") as f:
            json.dump(manifest, f)
            f.flush()
            os.fsync(f.fileno())
        if os.path.exists(final):
            shutil.rmtree(final)
        os.rename(tmp, final)
        self._gc()

    def _gc(self):
        steps = self.list_steps()
        for s in steps[:-self.keep]:
            shutil.rmtree(os.path.join(self.dir, f"step_{s:010d}"),
                          ignore_errors=True)

    # ---------------- read path ----------------

    def list_steps(self):
        out = []
        for name in os.listdir(self.dir):
            if name.startswith("step_"):
                out.append(int(name.split("_")[1]))
        return sorted(out)

    def restore_latest(self, template, device=None, shardings=None):
        """Restore the newest *valid* checkpoint into ``template``'s
        structure, each array on ``device`` in the type it was written in.

        A leaf whose path appears in ``shardings`` (a tree of
        ``NamedSharding``, as the template's) is restored as that DTensor.

        Returns (step, tree, extra) or (None, None, None) if nothing valid.
        Corrupt checkpoints (checksum/manifest mismatch) are skipped.
        """
        dev = resolve_device(device)
        placed = _flatten(shardings) if shardings is not None else {}
        for step in reversed(self.list_steps()):
            path = os.path.join(self.dir, f"step_{step:010d}")
            try:
                with open(os.path.join(path, "manifest.json")) as f:
                    manifest = json.load(f)
                data = np.load(os.path.join(path, "arrays.npz"))
                arrays = {}
                for k, info in manifest["arrays"].items():
                    a = data[k]
                    if _checksum(a) != info["sha1"]:
                        raise IOError(f"checksum mismatch for {k}")
                    arrays[k] = (a, info["dtype"])
                tree = _unflatten(template, arrays, dev, placed)
                return step, tree, manifest.get("extra", {})
            except Exception as e:
                print(f"[ckpt] step {step} invalid ({e}); trying older")
        return None, None, None


def _unflatten(template, arrays: dict, device, placed: dict, prefix=""):
    """``template``'s structure with each leaf read from ``arrays``: onto
    its sharding in ``placed`` where it has one, else onto ``device``."""
    if isinstance(template, dict):
        return {k: _unflatten(template[k], arrays, device, placed,
                              f"{prefix}{k}/")
                for k in template}
    if hasattr(template, "_fields"):
        return type(template)(*(
            _unflatten(getattr(template, k), arrays, device, placed,
                       f"{prefix}{k}/")
            for k in template._fields))
    if isinstance(template, (list, tuple)):
        return type(template)(_unflatten(v, arrays, device, placed,
                                         f"{prefix}{i}/")
                              for i, v in enumerate(template))
    key = prefix[:-1]
    if key in placed:
        return distribute(from_host(*arrays[key], "cpu"), placed[key])
    return from_host(*arrays[key], device)
