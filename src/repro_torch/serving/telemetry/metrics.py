"""Deterministic metrics core: counters, gauges, log-bucketed histograms.

Everything here is driven by values the serving path already computes on
the virtual clock — no wall time, no RNG — so a replay with the same
seeds produces a byte-identical snapshot.

The histogram is log-bucketed: bucket edges grow geometrically with
ratio ``gamma = 10 ** (1 / bins_per_decade)``.  A quantile answered from
the buckets uses the geometric midpoint of the covering bucket, clamped
to the observed [min, max], which bounds the relative error by
``sqrt(gamma) - 1`` for any value inside [lo, hi] (~1.8% at the default
64 bins/decade).  While the stream holds at most ``exact_n`` values the
histogram keeps them verbatim and answers quantiles *exactly*, matching
``np.quantile(..., method="inverted_cdf")``.

A copy of ``repro.serving.telemetry.metrics`` (the port imports nothing of
the reference package): the bucket index and the quantile interpolation
are the reference's float for float, so a snapshot renders the same
bytes.
"""

from __future__ import annotations

import math
from bisect import insort

import numpy as np

__all__ = ["Counter", "Gauge", "LogHistogram", "MetricsRegistry"]


class Counter:
    """Monotone cumulative count."""

    __slots__ = ("value",)

    def __init__(self) -> None:
        self.value = 0.0

    def inc(self, n: float = 1.0) -> None:
        if n < 0:
            raise ValueError("counter increments must be >= 0")
        self.value += float(n)

    def set_total(self, v: float) -> None:
        """Mirror an externally maintained cumulative total (e.g. a legacy
        stats dict).  Must never move backwards."""
        v = float(v)
        if v < self.value - 1e-9:
            raise ValueError(
                f"counter total moved backwards: {self.value} -> {v}")
        self.value = v


class Gauge:
    """Point-in-time value (queue depth, fill fraction, EWMA...)."""

    __slots__ = ("value",)

    def __init__(self) -> None:
        self.value = 0.0

    def set(self, v: float) -> None:
        self.value = float(v)


class LogHistogram:
    """Streaming histogram with geometric buckets and exact small-N path.

    Parameters
    ----------
    bins_per_decade:
        Buckets per factor-of-10; relative error of bucketed quantiles
        is ``sqrt(10 ** (1/bins_per_decade)) - 1``.
    exact_n:
        Keep up to this many raw values; while within, quantiles are
        exact.  The buffer is flushed into buckets on overflow.
    lo, hi:
        Bucketed range.  Values below ``lo`` (including zero) land in an
        underflow bucket whose representative is ``lo/2`` (absolute
        error <= lo); values above ``hi`` land in an overflow bucket
        represented by the tracked maximum.
    """

    def __init__(self, bins_per_decade: int = 64, exact_n: int = 256,
                 lo: float = 1e-3, hi: float = 1e7) -> None:
        if bins_per_decade <= 0:
            raise ValueError("bins_per_decade must be > 0")
        if exact_n < 0:
            raise ValueError("exact_n must be >= 0")
        if not (0 < lo < hi):
            raise ValueError("need 0 < lo < hi")
        self.bins_per_decade = int(bins_per_decade)
        self.exact_n = int(exact_n)
        self.lo = float(lo)
        self.hi = float(hi)
        self._scale = bins_per_decade / math.log(10.0)
        self._n_buckets = (
            int(math.ceil(math.log(hi / lo) * self._scale)) + 1)
        self.count = 0
        self.sum = 0.0
        self.min = math.inf
        self.max = -math.inf
        self._exact: list[float] | None = []  # sorted; None once flushed
        self._under = 0
        self._over = 0
        self._buckets: dict[int, int] = {}

    # -- error bound ----------------------------------------------------
    @property
    def rel_err_bound(self) -> float:
        """Guaranteed relative error of bucketed quantiles for values in
        [lo, hi]: half a bucket in log space."""
        gamma = 10.0 ** (1.0 / self.bins_per_decade)
        return math.sqrt(gamma) - 1.0

    @property
    def exact(self) -> bool:
        return self._exact is not None

    # -- ingest ---------------------------------------------------------
    def _bucket_index(self, x: float) -> int:
        # floor with an epsilon so exact edges land in the lower bucket's
        # successor deterministically across platforms
        return int(math.floor(math.log(x / self.lo) * self._scale + 1e-9))

    def _bucket_add(self, x: float) -> None:
        if x < self.lo:
            self._under += 1
        elif x > self.hi:
            self._over += 1
        else:
            i = min(self._bucket_index(x), self._n_buckets - 1)
            self._buckets[i] = self._buckets.get(i, 0) + 1

    def observe(self, values) -> None:
        arr = np.atleast_1d(np.asarray(values, dtype=np.float64)).ravel()
        if arr.size == 0:
            return
        if np.any(arr < 0):
            raise ValueError("histogram values must be >= 0")
        self.count += int(arr.size)
        self.sum += float(arr.sum())
        self.min = min(self.min, float(arr.min()))
        self.max = max(self.max, float(arr.max()))
        if self._exact is not None:
            if self.count <= self.exact_n:
                for x in arr.tolist():
                    insort(self._exact, float(x))
                return
            # flush the exact buffer into buckets, then continue bucketed
            for x in self._exact:
                self._bucket_add(x)
            self._exact = None
        for x in arr.tolist():
            self._bucket_add(float(x))

    # -- query ----------------------------------------------------------
    def quantile(self, q: float) -> float:
        """Inverted-CDF quantile: the smallest observed value whose
        cumulative count reaches ``ceil(q * N)``."""
        if not (0.0 <= q <= 1.0):
            raise ValueError("q must be in [0, 1]")
        if self.count == 0:
            return float("nan")
        rank = max(1, int(math.ceil(q * self.count)))
        if self._exact is not None:
            return float(self._exact[rank - 1])
        c = self._under
        if rank <= c:
            return min(self.lo / 2.0, self.max)
        for i in sorted(self._buckets):
            c += self._buckets[i]
            if rank <= c:
                edge_lo = self.lo * 10.0 ** (i / self.bins_per_decade)
                edge_hi = edge_lo * 10.0 ** (1.0 / self.bins_per_decade)
                rep = math.sqrt(edge_lo * edge_hi)
                return float(min(max(rep, self.min), self.max))
        return float(self.max)  # overflow bucket

    def snapshot(self) -> dict:
        if self.count == 0:
            return {"count": 0, "sum": 0.0}
        return {
            "count": int(self.count),
            "sum": float(self.sum),
            "min": float(self.min),
            "max": float(self.max),
            "p50": self.quantile(0.50),
            "p95": self.quantile(0.95),
            "p99": self.quantile(0.99),
            "p99.99": self.quantile(0.9999),
            "exact": bool(self.exact),
            "rel_err_bound": 0.0 if self.exact else self.rel_err_bound,
        }


def _key(name: str, labels: dict) -> str:
    if not labels:
        return name
    inner = ",".join(f'{k}="{labels[k]}"' for k in sorted(labels))
    return f"{name}{{{inner}}}"


class MetricsRegistry:
    """Flat registry keyed ``name{label="v",...}`` (labels sorted)."""

    def __init__(self, bins_per_decade: int = 64, exact_n: int = 256,
                 hist_lo: float = 1e-3, hist_hi: float = 1e7) -> None:
        self._hist_args = dict(bins_per_decade=bins_per_decade,
                               exact_n=exact_n, lo=hist_lo, hi=hist_hi)
        self.counters: dict[str, Counter] = {}
        self.gauges: dict[str, Gauge] = {}
        self.histograms: dict[str, LogHistogram] = {}

    def counter(self, name: str, **labels) -> Counter:
        k = _key(name, labels)
        c = self.counters.get(k)
        if c is None:
            c = self.counters[k] = Counter()
        return c

    def gauge(self, name: str, **labels) -> Gauge:
        k = _key(name, labels)
        g = self.gauges.get(k)
        if g is None:
            g = self.gauges[k] = Gauge()
        return g

    def histogram(self, name: str, **labels) -> LogHistogram:
        k = _key(name, labels)
        h = self.histograms.get(k)
        if h is None:
            h = self.histograms[k] = LogHistogram(**self._hist_args)
        return h

    def snapshot(self) -> dict:
        return {
            "counters": {k: float(c.value)
                         for k, c in sorted(self.counters.items())},
            "gauges": {k: float(g.value)
                       for k, g in sorted(self.gauges.items())},
            "histograms": {k: h.snapshot()
                           for k, h in sorted(self.histograms.items())},
        }
