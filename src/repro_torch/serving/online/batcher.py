"""Dynamic micro-batcher: form Stage-1 batches under a deadline/size policy.

The batched engines amortize dispatch across the Q axis, but an online
server cannot wait for a full batch at low load — the classic dynamic
batching trade-off (cf. the Kuaishou pre-ranking serving stack,
arXiv:2304.02434).  Policy here:

* a batch **closes** as soon as ``max_batch`` admitted queries are waiting,
  or when the *oldest* waiting query has waited ``batch_deadline_us``
  (whichever comes first), but never before the server is free;
* a closed batch is **padded** up to the next power-of-two Q bucket
  (``OnlineSpec.bucket_q``) by replicating a real query, so the engines see
  a handful of distinct ``(Q, n_tiles)`` grid shapes instead of one per
  batch size — the Q-axis analogue of the posting-lane rounding in
  ``isn.backend.query_lane_budget``.  Pads are served (their work is real
  in a deployment) and dropped from per-query results.

Because every stage of the cascade is row-independent on the jnp backend,
a query's top-k is bit-identical whether it is served alone, in any batch,
or next to pad rows — certified by ``benchmarks/bench_online.py``.

A copy of ``repro.serving.online.batcher`` (the port imports nothing of the
reference package).  Its ``export_metrics``, a telemetry hook, waits for
the telemetry item.
"""

from __future__ import annotations

import numpy as np

from repro_torch.serving.spec import OnlineSpec


def bucket_size(n: int, max_batch: int, bucket_q: bool = True) -> int:
    """The padded Q width for a batch of ``n`` real queries: the next
    power of two, capped at ``max_batch`` (identity when bucketing is
    off)."""
    if n < 1:
        raise ValueError("empty batch")
    if n > max_batch:
        raise ValueError(f"batch of {n} exceeds max_batch={max_batch}")
    if not bucket_q:
        return n
    return min(1 << int(np.ceil(np.log2(n))), max_batch)


def pad_batch(rows: np.ndarray, max_batch: int,
              bucket_q: bool = True) -> tuple[np.ndarray, int]:
    """(padded row indices, n_real): pads replicate ``rows[0]`` — a real
    query, so the batch max service time (device occupancy) is unchanged
    and row-independent stages are unaffected."""
    rows = np.asarray(rows, np.int64)
    n = len(rows)
    width = bucket_size(n, max_batch, bucket_q)
    if width == n:
        return rows, n
    return np.concatenate([rows, np.full(width - n, rows[0], np.int64)]), n


class MicroBatcher:
    """Incremental batch former over an arrival-ordered queue.

    The simulator owns the clock and the queue; this class answers one
    question — *when does the next batch close, and with which queries?* —
    via :meth:`close`.  Kept separate so the policy is testable without an
    event loop.
    """

    def __init__(self, cfg: OnlineSpec):
        cfg.validate()
        self.cfg = cfg

    def deadline(self, oldest_arrival: float, server_free: float) -> float:
        """Latest close time for a non-full batch headed by a query that
        arrived at ``oldest_arrival``: its deadline, or the moment the
        server frees up, whichever is later (a busy server extends the
        window — waiting costs nothing while the device is occupied)."""
        return max(oldest_arrival + self.cfg.batch_deadline_us, server_free)

    def close(self, pending_arrivals: np.ndarray,
              server_free: float) -> tuple[int, float]:
        """(batch size, close time) for the current queue.

        ``pending_arrivals`` are the arrival times of queued queries in
        order; the head must exist.  Returns how many queries the next
        batch takes and the virtual time it closes."""
        arr = np.asarray(pending_arrivals, np.float64)
        if arr.size == 0:
            raise ValueError("close() needs a non-empty queue")
        if arr.size >= self.cfg.max_batch:
            # full batch: closes as soon as its last member is here and
            # the server is free
            take = self.cfg.max_batch
            return take, max(float(arr[take - 1]), server_free)
        return int(arr.size), self.deadline(float(arr[0]), server_free)
