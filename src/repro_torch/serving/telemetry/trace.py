"""Per-query span trees with bounded retention and budget attribution.

A trace is a tree of :class:`Span` objects rooted at a ``query`` span:
stage0 predict -> routing decision -> per-shard Stage-1 attempts (with
retries/failovers) -> fusion -> Stage-2 rerank/trim/skip, plus cache and
admission outcomes in the metadata.  The :class:`TraceStore` keeps only
the slowest / budget-violating traces in bounded memory, and
:func:`why_slow` names the stage that consumed the budget.

A copy of ``repro.serving.telemetry.trace`` (the port imports nothing of
the reference package).
"""

from __future__ import annotations

import heapq
from dataclasses import dataclass, field

__all__ = ["Span", "QueryTrace", "TraceStore", "why_slow"]


@dataclass
class Span:
    """One timed node in a query's execution tree.

    ``start_us`` is relative to the query's service start on the virtual
    clock; zero-duration spans record decisions (routing, skip)."""

    name: str
    start_us: float = 0.0
    duration_us: float = 0.0
    meta: dict = field(default_factory=dict)
    children: list["Span"] = field(default_factory=list)

    def child(self, name: str, start_us: float = 0.0,
              duration_us: float = 0.0, **meta) -> "Span":
        s = Span(name, float(start_us), float(duration_us), dict(meta))
        self.children.append(s)
        return s

    def to_dict(self) -> dict:
        d = {"name": self.name, "start_us": float(self.start_us),
             "duration_us": float(self.duration_us)}
        if self.meta:
            d["meta"] = {k: self.meta[k] for k in sorted(self.meta)}
        if self.children:
            d["children"] = [c.to_dict() for c in self.children]
        return d


@dataclass
class QueryTrace:
    qid: int
    clock_us: float          # virtual-clock time the query was served
    latency_us: float        # total (wait + service for online traffic)
    budget_us: float
    violation: bool
    root: Span
    meta: dict = field(default_factory=dict)

    def to_dict(self) -> dict:
        return {
            "qid": int(self.qid),
            "clock_us": float(self.clock_us),
            "latency_us": float(self.latency_us),
            "budget_us": float(self.budget_us),
            "violation": bool(self.violation),
            "meta": {k: self.meta[k] for k in sorted(self.meta)},
            "spans": self.root.to_dict(),
            "why_slow": why_slow(self),
        }


class TraceStore:
    """Bounded retention of the most interesting traces.

    Priority: budget violations first, then latency; ties broken by
    arrival order (older wins) so replays are deterministic.  A min-heap
    over ``(violation, latency, -seq)`` keeps the top ``capacity``."""

    def __init__(self, capacity: int = 32) -> None:
        if capacity < 0:
            raise ValueError("capacity must be >= 0")
        self.capacity = int(capacity)
        self.offered = 0
        self.kept = 0
        self._seq = 0
        self._heap: list[tuple[tuple, int, QueryTrace]] = []

    def _priority(self, latency_us: float, violation: bool) -> tuple:
        return (1 if violation else 0, float(latency_us), -self._seq)

    def would_keep(self, latency_us: float, violation: bool) -> bool:
        """Cheap pre-check so callers can skip building span trees for
        queries that would be dropped anyway."""
        if self.capacity == 0:
            return False
        if len(self._heap) < self.capacity:
            return True
        return self._priority(latency_us, violation) > self._heap[0][0]

    def offer(self, trace: QueryTrace) -> bool:
        self.offered += 1
        if self.capacity == 0:
            return False
        pri = self._priority(trace.latency_us, trace.violation)
        self._seq += 1
        if len(self._heap) < self.capacity:
            heapq.heappush(self._heap, (pri, self._seq, trace))
            self.kept += 1
            return True
        if pri > self._heap[0][0]:
            heapq.heapreplace(self._heap, (pri, self._seq, trace))
            self.kept += 1
            return True
        return False

    def slowest(self, n: int | None = None) -> list[QueryTrace]:
        """Retained traces, most interesting first."""
        out = [t for _, _, t in
               sorted(self._heap, key=lambda e: e[0], reverse=True)]
        return out if n is None else out[:n]

    def __len__(self) -> int:
        return len(self._heap)


def why_slow(trace: QueryTrace) -> dict:
    """Attribute the query's latency to the stage that consumed it.

    Walks the top-level stage spans (plus queue wait from the trace
    metadata), compares each against its share of the budget when one is
    recorded (``reserve_us`` for stage2's reservation), and names the
    largest consumer.  Returns a dict with the culprit stage, its
    duration, its fraction of total latency, and a readable detail line.
    """
    parts: list[tuple[str, float]] = []
    wait = float(trace.meta.get("wait_us", 0.0))
    if wait > 0:
        parts.append(("queue", wait))
    for s in trace.root.children:
        if s.duration_us > 0:
            parts.append((s.name, float(s.duration_us)))
    if not parts:
        return {"stage": "none", "duration_us": 0.0, "fraction": 0.0,
                "detail": "no timed spans recorded"}
    total = max(trace.latency_us, 1e-9)
    stage, dur = max(parts, key=lambda p: p[1])
    frac = dur / total
    detail = (f"{stage} consumed {dur:.0f}us of {trace.latency_us:.0f}us "
              f"({100.0 * frac:.0f}%)")
    reserve = trace.meta.get("reserve_us")
    if stage == "stage1" and reserve is not None:
        slack = trace.budget_us - float(reserve) - dur
        detail += (f"; stage2 reserve {float(reserve):.0f}us left "
                   f"{slack:.0f}us of slack")
    if trace.violation:
        detail += f"; budget {trace.budget_us:.0f}us VIOLATED"
    return {"stage": stage, "duration_us": dur,
            "fraction": frac, "detail": detail}
