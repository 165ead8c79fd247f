"""Arrival-process generators: timestamped query streams from a seeded PRNG.

The paper's 99.99 % claim is about a system under *continuous load* —
response time = queueing delay + service time — so the online subsystem
needs arrival processes whose burstiness actually stresses the queue, not
just a pre-formed batch.  Four generators, all deterministic in
``TrafficSpec.seed``:

* **poisson** — memoryless baseline (exponential interarrivals at ``qps``);
* **bursty** — 2-state MMPP: a burst state at ``qps * burst_factor`` and a
  quiet state whose rate is solved so the long-run mean stays ``qps``;
  exponential dwell times.  This is the tail-stressing workload: queue
  depth during a burst is what admission control exists for;
* **diurnal** — sinusoidal rate ramp ``qps * (1 + a*sin(2πt/period))``
  sampled by thinning against the peak rate (a compressed day cycle);
* **trace** — replay recorded timestamps from a JSON list or ``.npy``
  array, shifted to start at 0.

Timestamps are in cost-model time units (ms at ``CostModel.paper_scale``);
``qps`` is queries per 1000 units, i.e. literally queries/second there.

A NumPy copy of ``repro.serving.online.traffic`` (the port imports nothing
of the reference package): the draws come from ``np.random.RandomState``
in the same order, so every timestamp is the reference's bit for bit.
"""

from __future__ import annotations

import json

import numpy as np

from repro_torch.serving.spec import TrafficSpec

_KILO = 1000.0  # time units per "second" (the qps denominator)


def _poisson(rng: np.random.RandomState, n: int, qps: float) -> np.ndarray:
    return np.cumsum(rng.exponential(_KILO / qps, size=n))


def _bursty(rng: np.random.RandomState, n: int, spec: TrafficSpec
            ) -> np.ndarray:
    """2-state Markov-modulated Poisson process.

    Long-run mean rate:  f·r_hi + (1-f)·r_lo = qps  with
    r_hi = qps·burst_factor, so r_lo = qps·(1 - f·burst_factor)/(1 - f)
    (positive by ``TrafficSpec.validate``).  Dwell means follow the
    stationary fractions: burst dwell ``burst_dwell_us``, quiet dwell
    ``burst_dwell_us · (1-f)/f``.
    """
    f = spec.burst_fraction
    r_hi = spec.qps * spec.burst_factor / _KILO
    r_lo = spec.qps * (1.0 - f * spec.burst_factor) / (1.0 - f) / _KILO
    dwell = {True: spec.burst_dwell_us,
             False: spec.burst_dwell_us * (1.0 - f) / f}
    out = np.empty(n)
    t, got, burst = 0.0, 0, False
    seg_end = rng.exponential(dwell[burst])
    while got < n:
        # exponential interarrival at the current state's rate; a gap that
        # crosses the state boundary is redrawn from the boundary at the
        # new rate (memorylessness makes this exact for a piecewise-
        # constant-rate Poisson process)
        gap = rng.exponential(1.0 / (r_hi if burst else r_lo))
        if t + gap > seg_end:
            t = seg_end
            burst = not burst
            seg_end = t + rng.exponential(dwell[burst])
            continue
        t += gap
        out[got] = t
        got += 1
    return out


def _diurnal(rng: np.random.RandomState, n: int, spec: TrafficSpec
             ) -> np.ndarray:
    """Thinning against the peak rate ``qps * (1 + amplitude)``."""
    peak = spec.qps * (1.0 + spec.diurnal_amplitude) / _KILO
    out = np.empty(n)
    t, got = 0.0, 0
    while got < n:
        t += rng.exponential(1.0 / peak)
        rate = (spec.qps / _KILO) * (1.0 + spec.diurnal_amplitude
                                     * np.sin(2.0 * np.pi * t
                                              / spec.diurnal_period_us))
        if rng.random_sample() * peak <= rate:
            out[got] = t
            got += 1
    return out


def load_trace(path: str) -> np.ndarray:
    """Recorded arrival timestamps from a ``.npy`` array or a JSON list."""
    if path.endswith(".npy"):
        ts = np.load(path)
    else:
        with open(path) as f:
            ts = np.asarray(json.load(f), np.float64)
    return np.asarray(ts, np.float64).ravel()


def zipf_query_mix(spec: TrafficSpec, n: int,
                   n_unique: int | None = None) -> np.ndarray:
    """``n`` query-log row indices with Zipfian repetition: arrival ``j``
    serves log row ``out[j]``, drawn with probability ∝ 1/rank^skew over
    the first ``n_unique`` rows (default: all of them).  This is the
    *identity* half of a production workload — a small head of queries
    repeating constantly — composable with ANY arrival process above:
    identities are drawn from their own seeded stream
    (``seed + 0x5EED``), so toggling ``skew`` never moves a timestamp.

    ``skew <= 0`` returns the uniform in-order replay ``arange(n) %
    n_unique`` — the historical behavior, bit-identical and RNG-free.
    """
    spec.validate()
    if n < 1:
        raise ValueError("need n >= 1 arrivals")
    n_unique = int(n_unique) if n_unique is not None else int(n)
    if n_unique < 1:
        raise ValueError("need n_unique >= 1 distinct queries")
    if spec.skew <= 0:
        return np.arange(n, dtype=np.int64) % n_unique
    ranks = np.arange(1, n_unique + 1, dtype=np.float64)
    p = ranks ** -float(spec.skew)
    p /= p.sum()
    rng = np.random.RandomState(spec.seed + 0x5EED)
    return rng.choice(n_unique, size=n, p=p).astype(np.int64)


def feed_arrival_times(ingest, n: int) -> np.ndarray:
    """``n`` non-decreasing feed-batch arrival timestamps for an
    :class:`~repro_torch.serving.spec.IngestSpec` — a Poisson process at
    ``feed_qps`` (batches per 1000 time units), drawn from its own seeded
    stream (``seed + 0xFEED``, the same independence discipline as
    ``zipf_query_mix``) so toggling ingest never moves a query timestamp."""
    if n < 1:
        raise ValueError("need n >= 1 feed arrivals")
    rng = np.random.RandomState(int(ingest.seed) + 0xFEED)
    return np.maximum.accumulate(_poisson(rng, n, float(ingest.feed_qps)))


def arrival_times(spec: TrafficSpec, n: int) -> np.ndarray:
    """``n`` non-decreasing arrival timestamps for the process ``spec``
    names, starting at >= 0.  Deterministic in ``spec.seed``."""
    spec.validate()
    if n < 1:
        raise ValueError("need n >= 1 arrivals")
    if spec.arrival == "trace":
        ts = load_trace(spec.trace_path)
        if len(ts) < n:
            raise ValueError(f"trace {spec.trace_path!r} has {len(ts)} "
                             f"timestamps, need {n}")
        ts = np.sort(ts[:n])
        return ts - ts[0]
    rng = np.random.RandomState(spec.seed)
    if spec.arrival == "poisson":
        out = _poisson(rng, n, spec.qps)
    elif spec.arrival == "bursty":
        out = _bursty(rng, n, spec)
    else:
        out = _diurnal(rng, n, spec)
    return np.maximum.accumulate(out)  # guard fp monotonicity
