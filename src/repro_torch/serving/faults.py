"""Deterministic fault injection for the serving cascade.

The paper's 99.99 % response-time regime is exactly where machine
failures — crashed replicas, stragglers, lost partitions — dominate the
tail, and its ISN architecture presumes replicas that can fail and be
routed around.  This module turns a
:class:`~repro_torch.serving.spec.FaultSpec` schedule into per-request
outcomes the serve path can consult:

* :meth:`FaultInjector.is_up` — is this replica reachable *now*?
  (crash windows + whole-partition outages, with ``-1`` wildcards);
* :meth:`FaultInjector.slowdown` — straggler multiplier on a successful
  response (1.0 outside any straggler window);
* :meth:`FaultInjector.transient` — one seeded per-request timeout draw
  inside the transient-storm window.

Everything is deterministic: the schedule is pure data, and transient
draws come from one seeded stream consumed in serve order — the same
``(CascadeSpec, TrafficSpec)`` pair replays bit-identically, which is what
lets the fault benchmark *certify* (not sample) the guarantee under each
scenario.  An inactive spec short-circuits every query at zero
cost and zero RNG draws, keeping fault-free serving bit-identical.

:func:`fault_scenario` names the canonical certification scenarios
(crash-one-replica, rolling restarts, stragglers, transient-timeout storm,
one-partition outage) sized to a deployment shape and trace horizon —
shared by the benchmark, the tests, and ``launch/serve.py
--fault-scenario``.

A copy of ``repro.serving.faults`` (the port imports nothing of the
reference package): the same schedule, and the transient draws from the
same ``np.random.RandomState(spec.seed)`` stream in the same order, so a
system on the card consumes exactly the draws of one on the CPU.  Its
``FaultInjector.export_metrics``, a telemetry hook, waits for the
telemetry item.
"""

from __future__ import annotations

import numpy as np

from repro_torch.serving.spec import FaultSpec


def _matches(sel: int, value: int) -> bool:
    return sel == -1 or sel == value


class FaultInjector:
    """Per-request oracle over a :class:`FaultSpec` schedule."""

    def __init__(self, spec: FaultSpec, n_partitions: int):
        spec.validate()
        self.spec = spec
        self.n_partitions = n_partitions
        self.rng = np.random.RandomState(spec.seed)
        self.draws = 0           # transient draws consumed (determinism aid)

    @property
    def active(self) -> bool:
        return self.spec.active

    # ------------------------------------------------------------------
    def is_up(self, partition: int, replica_id: int, now: float) -> bool:
        """Whether a request to (partition, replica) at ``now`` can ever
        respond — False inside a crash window or a partition outage."""
        for p, t0, t1 in self.spec.outages:
            if _matches(p, partition) and t0 <= now < t1:
                return False
        for p, r, t0, t1 in self.spec.crashes:
            if (_matches(p, partition) and _matches(r, replica_id)
                    and t0 <= now < t1):
                return False
        return True

    def partition_up(self, partition: int, n_replicas: int,
                     now: float) -> bool:
        """Whether the partition has any replica the schedule leaves up —
        the ground truth behind the ``coverage >= surviving / total``
        certification."""
        return any(self.is_up(partition, r, now) for r in range(n_replicas))

    def surviving(self, n_replicas: int, now: float) -> int:
        """How many partitions the schedule leaves reachable at ``now``."""
        return sum(self.partition_up(p, n_replicas, now)
                   for p in range(self.n_partitions))

    def slowdown(self, partition: int, replica_id: int, now: float) -> float:
        """Straggler multiplier on a successful response (>= 1.0;
        overlapping windows take the worst one)."""
        m = 1.0
        for p, r, t0, t1, s in self.spec.stragglers:
            if (_matches(p, partition) and _matches(r, replica_id)
                    and t0 <= now < t1):
                m = max(m, float(s))
        return m

    def transient(self, now: float) -> bool:
        """One seeded per-request transient-timeout draw.  Draws happen
        only inside the storm window, in serve order, so a fixed seed
        replays bit-identically."""
        sp = self.spec
        if sp.timeout_p <= 0 or not (sp.timeout_start <= now
                                     < sp.timeout_end):
            return False
        self.draws += 1
        return bool(self.rng.rand() < sp.timeout_p)


# ---------------------------------------------------------------------------
# canonical certification scenarios
# ---------------------------------------------------------------------------

SCENARIOS = ("none", "crash_one", "rolling_restart", "stragglers",
             "timeout_storm", "partition_outage")


def fault_scenario(name: str, *, n_partitions: int, replicas: int,
                   horizon: float, seed: int = 0) -> FaultSpec:
    """The named certification scenario, sized to a deployment shape and a
    trace of ``horizon`` time units.

    ============== ======================================================
    none           empty schedule (the bit-identical control)
    crash_one      one replica of partition 0 crashes at 10 % of the
                   horizon and never recovers — failover must keep full
                   coverage
    rolling_restart each partition's replica 0 goes down for a staggered
                   window and comes back — the probe/recovery path
    stragglers     ~10 % of replicas run 8x slow for the whole trace —
                   the hedging/enforcement path
    timeout_storm  5 % transient per-request timeouts over the middle
                   half of the trace — the bounded-retry path
    partition_outage the last partition loses every replica for the
                   middle half — the partial-coverage path
    ============== ======================================================
    """
    if name == "none":
        return FaultSpec()
    if name == "crash_one":
        return FaultSpec(crashes=((0, replicas - 1, 0.1 * horizon,
                                   float("inf")),), seed=seed)
    if name == "rolling_restart":
        w = horizon / max(2 * n_partitions, 1)
        return FaultSpec(crashes=tuple(
            (p, 0, 0.1 * horizon + 2 * p * w, 0.1 * horizon + (2 * p + 1) * w)
            for p in range(n_partitions)), seed=seed)
    if name == "stragglers":
        total = n_partitions * replicas
        n_slow = max(int(round(0.1 * total)), 1)
        slow = []
        for j in range(n_slow):
            # spread the slow replicas across partitions
            p = j % n_partitions
            r = (j // n_partitions) % replicas
            slow.append((p, r, 0.0, float("inf"), 8.0))
        return FaultSpec(stragglers=tuple(slow), seed=seed)
    if name == "timeout_storm":
        return FaultSpec(timeout_p=0.05, timeout_start=0.25 * horizon,
                         timeout_end=0.75 * horizon, seed=seed)
    if name == "partition_outage":
        return FaultSpec(outages=((n_partitions - 1, 0.25 * horizon,
                                   0.75 * horizon),), seed=seed)
    raise ValueError(f"unknown fault scenario {name!r}; "
                     f"available: {SCENARIOS}")
