"""Observability of the serving cascade: the modeled clock's record, and
the host's wall clock under a profiler.

The :class:`Telemetry` facade owns one :class:`MetricsRegistry`, one
:class:`TraceStore`, and the ring of periodic online snapshots.  It is
allocated by ``SearchSystem`` only when ``TelemetrySpec.enabled`` — a
disabled spec is provably inert: no registry exists and every hook in
the serving path is guarded on ``system.telemetry is None``.  This part is
a copy of ``repro.serving.telemetry`` (the port imports nothing of the
reference package): host NumPy on the virtual serving clock, which reads
no wall clock, draws no random number and launches no kernel, so a system
on the card and one on the CPU record the same snapshot.

:mod:`.host` is the port's own: spans and counters on the wall clock that
``torch.profiler`` uses (where each stage's host time goes, every copy
between host and card, postings scored, the set-up phases).  Its spans
and counters are on exactly while a profiler records and cost one flag
read otherwise; its set-up phases are always recorded.  It imports only
the standard library and ``torch``, so every layer of the port may use it.
"""

from __future__ import annotations

import numpy as np

from . import host
from .metrics import Counter, Gauge, LogHistogram, MetricsRegistry
from .trace import QueryTrace, Span, TraceStore, why_slow

__all__ = ["host", "Telemetry", "MetricsRegistry", "Counter", "Gauge",
           "LogHistogram", "QueryTrace", "Span", "TraceStore", "why_slow"]


class Telemetry:
    """Registry + trace store + snapshot cadence for one SearchSystem."""

    def __init__(self, spec, budget_us: float) -> None:
        self.spec = spec
        self.budget_us = float(budget_us)
        self.registry = MetricsRegistry(
            bins_per_decade=spec.bins_per_decade, exact_n=spec.exact_n,
            hist_lo=spec.hist_lo, hist_hi=spec.hist_hi)
        self.traces = TraceStore(spec.trace_reservoir)
        self.snapshots: list[dict] = []
        # the online simulator sets this around system.serve() with
        # per-padded-row queue waits and admission modes so traces can
        # attribute response time, then clears it
        self.batch_context: dict | None = None
        self.query_seq = 0   # offline qid assignment (no simulator ids)
        self._adm = None
        self._batcher = None
        self._next_snapshot_us = (float(spec.snapshot_every_us)
                                  if spec.snapshot_every_us > 0
                                  else float("inf"))

    # -- online wiring --------------------------------------------------
    def attach_online(self, adm, batcher) -> None:
        """Keep refs to the admission controller / micro-batcher so the
        next snapshot can export their counters and policy gauges."""
        self._adm = adm
        self._batcher = batcher

    def export_online(self) -> None:
        if self._adm is not None:
            self._adm.export_metrics(self.registry)
        if self._batcher is not None:
            self._batcher.export_metrics(self.registry)

    # -- batch-level recording ------------------------------------------
    def record_batch(self, lat, stage_latency: dict, budget_us: float,
                     trimmed: int = 0, skipped: int = 0) -> None:
        """Fold one served batch into the registry: per-query service
        latency, per-stage latency histograms, violation and stage2
        degradation counters."""
        reg = self.registry
        lat = np.asarray(lat, dtype=np.float64)
        reg.counter("queries_served").inc(lat.size)
        reg.counter("batches_served").inc()
        reg.histogram("service_latency_us").observe(lat)
        n_over = int((lat > budget_us).sum())
        if n_over:
            reg.counter("budget_violations").inc(n_over)
        for name, t in stage_latency.items():
            t = np.asarray(t, dtype=np.float64)
            live = t[t > 0]
            if live.size:
                reg.histogram("stage_latency_us", stage=name).observe(live)
        if trimmed:
            reg.counter("stage2_trimmed").inc(trimmed)
        if skipped:
            reg.counter("stage2_skipped").inc(skipped)

    # -- periodic snapshots ---------------------------------------------
    def maybe_snapshot(self, system, now: float) -> bool:
        """Take a periodic snapshot if the virtual clock crossed the
        cadence boundary; bounded by ``spec.max_snapshots``."""
        if now < self._next_snapshot_us:
            return False
        if len(self.snapshots) >= self.spec.max_snapshots:
            self._next_snapshot_us = float("inf")
            return False
        self.snapshots.append(system.snapshot(now=now))
        every = float(self.spec.snapshot_every_us)
        # advance past `now` in whole cadence steps (deterministic)
        while self._next_snapshot_us <= now:
            self._next_snapshot_us += every
        return True
