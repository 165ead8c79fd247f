"""ISN replica pool management: mirror placement, load balancing, failure
handling — the distributed-IR layer the paper's "index mirroring" rides on
(paper §4: "selecting algorithm a ∈ A actually refers to selecting an ISN
configured to run algorithm a").

A deployment is a set of *partitions* (document shards); each partition has
R replicas, each replica built as one mirror type (BMW or JASS).  The pool:

* routes a (query, mirror) request to the least-loaded healthy replica of
  every partition (power-of-two-choices);
* tracks in-flight work with an EWMA latency estimate per replica —
  stragglers get deprioritized before they fail health checks;
* handles replica failure/recovery (mark unhealthy after `fail_after`
  consecutive timeouts; re-admit after a probe succeeds);
* rebalances mirror ratios from the observed routing mix (the paper routes
  ~40–60 % to JASS at its operating points; a static 50/50 mirror split
  wastes capacity if the scheduler's mix drifts).

A copy of ``repro.serving.replicas`` (the port imports nothing of the reference
package).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

BMW, JASS = "bmw", "jass"


@dataclass
class Replica:
    partition: int
    mirror: str
    replica_id: int
    inflight: int = 0
    ewma_latency: float = 1.0
    healthy: bool = True
    consecutive_failures: int = 0
    served: int = 0


@dataclass
class PoolConfig:
    n_partitions: int = 4
    replicas_per_partition: int = 4
    jass_fraction: float = 0.5
    ewma_alpha: float = 0.2
    fail_after: int = 3


class ReplicaPool:
    def __init__(self, cfg: PoolConfig, seed: int = 0):
        self.cfg = cfg
        self.rng = np.random.RandomState(seed)
        self.replicas: list[Replica] = []
        for p in range(cfg.n_partitions):
            n_jass = max(int(round(cfg.replicas_per_partition
                                   * cfg.jass_fraction)), 1)
            for r in range(cfg.replicas_per_partition):
                mirror = JASS if r < n_jass else BMW
                self.replicas.append(Replica(p, mirror, r))

    # ------------------------------------------------------------------
    def candidates(self, partition: int, mirror: str):
        return [r for r in self.replicas
                if r.partition == partition and r.mirror == mirror
                and r.healthy]

    def _pick_from(self, cands: list[Replica]) -> Replica | None:
        """Power-of-two-choices on (inflight, ewma latency) over an
        explicit candidate list (RNG draw only when there is a choice)."""
        if not cands:
            return None
        if len(cands) == 1:
            return cands[0]
        a, b = self.rng.choice(len(cands), size=2, replace=False)
        ra, rb = cands[a], cands[b]
        # expected time-to-drain; the random pair ordering breaks ties fairly
        key = (lambda r: (r.inflight + 1) * r.ewma_latency)
        return ra if key(ra) <= key(rb) else rb

    def pick(self, partition: int, mirror: str) -> Replica | None:
        """Power-of-two-choices on (inflight, ewma latency)."""
        cands = self.candidates(partition, mirror)
        if not cands:
            # mirror exhausted (failures): fall back to the other mirror —
            # JASS can always stand in for BMW (rank-safety traded for the
            # budget guarantee), BMW for JASS (budget risk, logged)
            other = JASS if mirror == BMW else BMW
            cands = self.candidates(partition, other)
        return self._pick_from(cands)

    def route_query(self, mirror: str) -> list[Replica] | None:
        """A query fans out to one replica of EVERY partition; all-or-
        nothing — a partition with no healthy replica releases the picks
        already made so no inflight count leaks."""
        picks = []
        for p in range(self.cfg.n_partitions):
            r = self.pick(p, mirror)
            if r is None:
                for rr in picks:
                    rr.inflight = max(rr.inflight - 1, 0)
                return None
            r.inflight += 1
            picks.append(r)
        return picks

    def route_query_partial(self, mirror: str) -> list[Replica | None]:
        """Like :meth:`route_query` but a partition with no healthy replica
        yields ``None`` in its slot instead of aborting the whole fan-out —
        the degraded-serving entry point.  When every partition is healthy
        the pick sequence (and RNG stream) is identical to
        :meth:`route_query`."""
        picks: list[Replica | None] = []
        for p in range(self.cfg.n_partitions):
            r = self.pick(p, mirror)
            if r is not None:
                r.inflight += 1
            picks.append(r)
        return picks

    def pick_retry(self, partition: int, mirror: str,
                   tried_ids: set[int]) -> Replica | None:
        """Failover pick for a timed-out shard request: prefer a healthy
        replica of the same partition not yet tried for this (query, shard)
        — routed mirror first, then the other mirror — and only then allow
        a re-try of an already-tried healthy replica (transient timeouts
        clear).  Returns ``None`` when the partition has no healthy replica
        at all."""
        other = JASS if mirror == BMW else BMW
        for pool in (self.candidates(partition, mirror),
                     self.candidates(partition, other)):
            fresh = [r for r in pool if id(r) not in tried_ids]
            if fresh:
                return self._pick_from(fresh)
        return self.pick(partition, mirror)

    def probe_unhealthy(self, is_up_fn=None) -> tuple[int, int]:
        """Probe every unhealthy replica; ``is_up_fn(replica) -> bool``
        decides the probe outcome (default: always up, i.e. the fault has
        cleared).  Returns (probes sent, replicas recovered)."""
        probes = recovered = 0
        for r in self.replicas:
            if r.healthy:
                continue
            probes += 1
            ok = True if is_up_fn is None else bool(is_up_fn(r))
            self.probe(r, ok=ok)
            recovered += int(ok)
        return probes, recovered

    def complete(self, replica: Replica, latency: float, ok: bool = True):
        replica.inflight = max(replica.inflight - 1, 0)
        if ok:
            a = self.cfg.ewma_alpha
            replica.ewma_latency = ((1 - a) * replica.ewma_latency
                                    + a * latency)
            replica.consecutive_failures = 0
            replica.served += 1
        else:
            replica.consecutive_failures += 1
            if replica.consecutive_failures >= self.cfg.fail_after:
                replica.healthy = False

    def probe(self, replica: Replica, ok: bool):
        """Health-check a failed replica; re-admit on success."""
        if ok:
            replica.healthy = True
            replica.consecutive_failures = 0
            replica.inflight = 0

    # ------------------------------------------------------------------
    def rebalance(self, observed_jass_fraction: float):
        """Re-split mirrors toward the observed routing mix (rounded to
        whole replicas; each partition keeps >= 1 of each mirror).

        Driven online by ``SearchSystem.serve`` from the scheduler's
        observed JASS fraction (``DeploySpec.rebalance_every``), not just by
        offline simulation.  A partition needs >= 2 replicas to hold both
        mirrors — single-replica deployments keep their static split."""
        cfg = self.cfg
        if cfg.replicas_per_partition < 2:
            return
        want = int(round(cfg.replicas_per_partition
                         * np.clip(observed_jass_fraction, 0.2, 0.8)))
        want = min(max(want, 1), cfg.replicas_per_partition - 1)
        for p in range(cfg.n_partitions):
            reps = sorted((r for r in self.replicas if r.partition == p),
                          key=lambda r: r.replica_id)
            for i, r in enumerate(reps):
                mirror = JASS if i < want else BMW
                if mirror != r.mirror:
                    r.mirror = mirror
                    # latency history belongs to the old mirror; restart
                    # the estimate so pick() is not biased by stale data
                    r.ewma_latency = 1.0
        self.cfg = PoolConfig(**{**cfg.__dict__,
                                 "jass_fraction": want
                                 / cfg.replicas_per_partition})

    def mirror_ewma(self) -> dict:
        """Mean EWMA latency per mirror over replicas that have served —
        the pool-side signal ``SearchSystem._adapt_routing`` feeds back
        into the ``t_time`` routing threshold (None until a mirror has
        observed traffic)."""
        out = {}
        for m in (JASS, BMW):
            v = [r.ewma_latency for r in self.replicas
                 if r.mirror == m and r.served]
            out[m] = float(np.mean(v)) if v else None
        return out

    def stats(self) -> dict:
        healthy = sum(r.healthy for r in self.replicas)
        return {
            "replicas": len(self.replicas),
            "healthy": healthy,
            "jass": sum(r.mirror == JASS for r in self.replicas),
            "bmw": sum(r.mirror == BMW for r in self.replicas),
            "jass_fraction": self.cfg.jass_fraction,
            "served": sum(r.served for r in self.replicas),
            "max_inflight": max((r.inflight for r in self.replicas),
                                default=0),
            "ewma_latency": self.mirror_ewma(),
        }
