"""Host data pipeline: a prefetch thread and the copy to the device.

A port of the reference's ``data/pipeline.py``.  Where the reference
``device_put``s each batch onto per-argument shardings, this loader takes
one ``device``: each array of a batch becomes a tensor there, copied from
pinned host memory when the device is a card.  With ``device=None`` the
batches pass through as the generator yields them, as the reference's do
without shardings.  Resumable cursors belong to the generator
(``data.synthetic.lm_batches``' ``start_index``).
"""

from __future__ import annotations

import queue
import threading

import numpy as np
import torch


def _to_device(item, device: torch.device):
    """A batch (a dict of arrays, or one array) as tensors on ``device``."""
    if isinstance(item, dict):
        return {k: _to_device(v, device) for k, v in item.items()}
    t = torch.from_numpy(np.ascontiguousarray(item))
    if device.type == "cuda":
        return t.pin_memory().to(device, non_blocking=True)
    return t.to(device)


class PrefetchingLoader:
    """Wraps a host generator with a background prefetch thread that puts
    each batch on ``device`` (``depth`` batches ahead)."""

    def __init__(self, gen, device=None, depth: int = 2):
        self.gen = gen
        self.device = torch.device(device) if device is not None else None
        self.q: queue.Queue = queue.Queue(maxsize=depth)
        self._stop = threading.Event()
        self.t = threading.Thread(target=self._worker, daemon=True)
        self.t.start()

    def _worker(self):
        try:
            for item in self.gen:
                if self._stop.is_set():
                    return
                if self.device is not None:
                    item = _to_device(item, self.device)
                self.q.put(item)
        finally:
            self.q.put(None)

    def __iter__(self):
        return self

    def __next__(self):
        item = self.q.get()
        if item is None:
            raise StopIteration
        return item

    def close(self):
        self._stop.set()
