"""Two-level serving cache: exact results (L1) + Stage-1 candidates (L2).

Production query streams are heavily skewed — a small head of queries
repeats constantly (the ``retr:{tenant}:{hash(query)}`` pattern of
production retrieval stacks) — yet the cascade recomputes every repeat
from scratch.  This module is the deterministic cache a
:class:`~repro_torch.serving.spec.CacheSpec` describes:

* **L1** — exact result cache.  The key is the *normalized query*
  (sorted active ``(term, weight)`` pairs + topic) combined with the
  resolved routing decision (mirror, clamped ρ and k — so an operating
  point whose thresholds adapted since the fill can never serve a stale
  route's results; the old entry just misses and ages out) and the
  Stage-2 parameters (``k_serve``, ``t_final`` and the effective per-query
  candidate cap).  A hit bypasses the whole cascade and costs
  ``CostModel.cache_hit_us``.
* **L2** — Stage-1 candidate cache.  Keyed on the normalized query and
  the routing decision only: a hit skips retrieval (the expensive half)
  but re-runs Stage-2, so trimmed/degraded rungs and differing re-rank
  depths still get a partial win from an earlier fill.

Both levels are capacity-bounded LRUs with **entry- and byte-limits**
(O(1) dict + doubly-linked list — no ordered-dict re-sorting, no
wall-clock reads, no RNG draws; recency is pure access order).  They are
evaluated on the same serving clock as the fault schedule:

* results served with partial coverage are **never admitted** (the fill
  guard is per-query coverage == 1);
* every entry is tagged with the **coverage/fault epoch** at fill time —
  the tuple of per-partition up/down states (plus the transient-storm
  window flag) the :class:`~repro_torch.serving.faults.FaultInjector` reports —
  and a lookup only hits when the entry's epoch matches the current one,
  so a result cached while a partition was down can never be served after
  it heals (and a healthy-epoch result can never mask a live outage).

An inactive :class:`~repro_torch.serving.spec.CacheSpec` never constructs
this object at all (``SearchSystem.cache is None``): zero lookups, zero
RNG, bit-identical serving — the same inertness discipline as
``FaultSpec``.

A copy of ``repro.serving.cache`` (the port imports nothing of the
reference package).  Keys and byte charges are the reference's: keys are
the bytes of host NumPy rows, and cached values are host NumPy copies,
never device tensors (``entry_nbytes`` charges an array its ``nbytes`` and
anything else 8 B, so a tensor would bend byte-capped eviction).
"""

from __future__ import annotations

import numpy as np

from repro_torch.serving.spec import CacheSpec

# epoch of a fault-free deployment (FaultInjector inactive): one constant,
# so healthy fills and healthy lookups always agree
HEALTHY_EPOCH = ()


# ---------------------------------------------------------------------------
# key normalization
# ---------------------------------------------------------------------------

def normalize_query(terms_row: np.ndarray, mask_row: np.ndarray,
                    topic) -> bytes:
    """The canonical byte string naming one query: active ``(term, weight)``
    pairs sorted by term id, plus the topic scalar/vector.  Padding slots
    (mask <= 0) and term order are normalized away, so the same logical
    query hits regardless of how its row was laid out."""
    terms_row = np.asarray(terms_row)
    mask_row = np.asarray(mask_row)
    live = mask_row > 0
    t = terms_row[live].astype(np.int64)
    w = mask_row[live].astype(np.float64)
    order = np.argsort(t, kind="stable")
    parts = [t[order].tobytes(), w[order].tobytes()]
    if topic is not None:
        parts.append(np.asarray(topic, np.float64).tobytes())
    return b"|".join(parts)


def route_sig(is_jass: bool, rho: float, k: float,
              extra: bytes = b"") -> bytes:
    """The byte signature of one resolved routing decision.  ρ determines
    the SAAT traversal (the global impact-level cut) and k the Stage-2
    depth, so two serves agree bit-for-bit iff their signatures match —
    which is exactly what makes a hit safe after online threshold
    adaptation (a changed route simply misses).

    ``extra`` extends the signature with any further serve-shaping
    dimension — the dense subsystem passes its resolved modality
    (``b"|M0"``/``b"|M1"``/``b"|M2"``) so lexical, dense and fused entries
    for the same query can never collide.  The default ``b""`` keeps every
    key byte-identical to the pre-dense layout, so a disabled
    ``DenseSpec`` is provably inert at the cache layer too."""
    return (b"J" if is_jass else b"B") + np.float64(rho).tobytes() \
        + np.float64(k).tobytes() + extra


def l1_key(qkey: bytes, rsig: bytes, k_serve: int, t_final: int,
           cap: int) -> bytes:
    """Exact-result key: query + route + every Stage-2 parameter that can
    change the final list (``cap`` is the effective per-query candidate
    cap — admission's trim rung — so a trimmed result can never stand in
    for a full one)."""
    return b"1|%d|%d|%d|" % (k_serve, t_final, cap) + rsig + qkey


def l2_key(qkey: bytes, rsig: bytes) -> bytes:
    """Stage-1 candidate key: query + route only — re-rank depth is
    re-decided at hit time."""
    return b"2|" + rsig + qkey


def entry_nbytes(value) -> int:
    """Byte charge of one cached value: the array payloads (results are
    tuples of numpy rows / scalars)."""
    n = 0
    for v in value if isinstance(value, tuple) else (value,):
        if isinstance(v, np.ndarray):
            n += v.nbytes
        elif v is not None:
            n += 8
    return n


# ---------------------------------------------------------------------------
# the LRU
# ---------------------------------------------------------------------------

class _Node:
    __slots__ = ("key", "value", "nbytes", "epoch", "prev", "nxt")

    def __init__(self, key, value, nbytes, epoch):
        self.key = key
        self.value = value
        self.nbytes = nbytes
        self.epoch = epoch
        self.prev = None
        self.nxt = None


class LRUCache:
    """Entry- and byte-bounded LRU: dict for O(1) lookup, an intrusive
    doubly-linked list for O(1) recency moves and tail eviction.

    Deterministic by construction — recency is access order, eviction is
    strictly from the LRU tail, and nothing reads a clock or an RNG — so
    two replays of the same serve sequence hold identical contents.
    """

    def __init__(self, max_entries: int, max_bytes: int = 0):
        if max_entries < 0 or max_bytes < 0:
            raise ValueError("capacities must be >= 0")
        self.max_entries = int(max_entries)
        self.max_bytes = int(max_bytes)   # 0 = entries-only bound
        self._map: dict = {}
        self._head: _Node | None = None   # most recently used
        self._tail: _Node | None = None   # eviction end
        self.nbytes = 0
        self.stats = {"hits": 0, "misses": 0, "fills": 0, "updates": 0,
                      "evicted_entries": 0, "evicted_bytes": 0,
                      "epoch_misses": 0}

    def __len__(self) -> int:
        return len(self._map)

    # -- list plumbing ----------------------------------------------------
    def _unlink(self, node: _Node) -> None:
        if node.prev is not None:
            node.prev.nxt = node.nxt
        else:
            self._head = node.nxt
        if node.nxt is not None:
            node.nxt.prev = node.prev
        else:
            self._tail = node.prev
        node.prev = node.nxt = None

    def _push_front(self, node: _Node) -> None:
        node.prev, node.nxt = None, self._head
        if self._head is not None:
            self._head.prev = node
        self._head = node
        if self._tail is None:
            self._tail = node

    def _drop(self, node: _Node) -> None:
        self._unlink(node)
        del self._map[node.key]
        self.nbytes -= node.nbytes

    def _evict_to_fit(self, incoming_nbytes: int) -> None:
        """Make room for one incoming entry: evict from the LRU tail until
        both an entry slot and (when byte-bounded) the payload fit."""
        while self._tail is not None and (
                len(self._map) >= self.max_entries
                or (self.max_bytes
                    and self.nbytes + incoming_nbytes > self.max_bytes)):
            victim = self._tail
            self._drop(victim)
            self.stats["evicted_entries"] += 1
            self.stats["evicted_bytes"] += victim.nbytes

    # -- public API -------------------------------------------------------
    def get(self, key, epoch=HEALTHY_EPOCH):
        """The cached value, or ``None``.  A key present under a different
        coverage/fault epoch is dropped and reported as a miss — degraded
        and healthy serving can never poison each other."""
        node = self._map.get(key)
        if node is None:
            self.stats["misses"] += 1
            return None
        if node.epoch != epoch:
            self._drop(node)
            self.stats["epoch_misses"] += 1
            self.stats["misses"] += 1
            return None
        self._unlink(node)
        self._push_front(node)
        self.stats["hits"] += 1
        return node.value

    def contains(self, key, epoch=HEALTHY_EPOCH) -> bool:
        """Side-effect-free membership probe (no recency move, no stats):
        the admission controller's dispatch-time peek."""
        node = self._map.get(key)
        return node is not None and node.epoch == epoch

    def put(self, key, value, epoch=HEALTHY_EPOCH) -> None:
        """Insert/refresh an entry at the MRU end, evicting from the LRU
        tail until both the entry and the byte bound hold.  An entry larger
        than the whole byte budget is refused outright."""
        if self.max_entries == 0:
            return
        nbytes = entry_nbytes(value)
        if self.max_bytes and nbytes > self.max_bytes:
            return
        node = self._map.get(key)
        if node is not None:
            self.nbytes += nbytes - node.nbytes
            node.value, node.nbytes, node.epoch = value, nbytes, epoch
            self._unlink(node)
            self._push_front(node)
            self.stats["updates"] += 1
            return
        self._evict_to_fit(nbytes)
        node = _Node(key, value, nbytes, epoch)
        self._map[key] = node
        self._push_front(node)
        self.nbytes += nbytes
        self.stats["fills"] += 1

    def keys_mru(self) -> list:
        """Keys in most-recently-used-first order (tests/debug)."""
        out, node = [], self._head
        while node is not None:
            out.append(node.key)
            node = node.nxt
        return out


# ---------------------------------------------------------------------------
# the two-level serving cache
# ---------------------------------------------------------------------------

class ServingCache:
    """The :class:`CacheSpec`-shaped pair of LRUs plus serving counters.

    ``SearchSystem`` owns one of these when (and only when) the spec is
    active; every method is deterministic and RNG-free.
    """

    def __init__(self, spec: CacheSpec):
        spec.validate()
        if not spec.active:
            raise ValueError("ServingCache built from an inactive CacheSpec "
                             "— the serve path must keep cache=None instead")
        self.spec = spec
        self.l1 = (LRUCache(spec.l1_entries, spec.l1_bytes)
                   if spec.l1_entries > 0 else None)
        self.l2 = (LRUCache(spec.l2_entries, spec.l2_bytes)
                   if spec.l2_entries > 0 else None)
        self.counters = {"lookups": 0, "l1_hits": 0, "l2_hits": 0,
                         "full_misses": 0, "skipped_partial": 0}

    # -- L1 ---------------------------------------------------------------
    def l1_get(self, key: bytes, epoch):
        return self.l1.get(key, epoch) if self.l1 is not None else None

    def l1_contains(self, key: bytes, epoch) -> bool:
        return self.l1 is not None and self.l1.contains(key, epoch)

    def l1_put(self, key: bytes, value, epoch) -> None:
        if self.l1 is not None:
            self.l1.put(key, value, epoch)

    # -- L2 ---------------------------------------------------------------
    def l2_get(self, key: bytes, epoch):
        return self.l2.get(key, epoch) if self.l2 is not None else None

    def l2_put(self, key: bytes, value, epoch) -> None:
        if self.l2 is not None:
            self.l2.put(key, value, epoch)

    # -- reporting --------------------------------------------------------
    def hit_ratio(self) -> float:
        """Lifetime L1 hit ratio over every lookup so far."""
        n = self.counters["lookups"]
        return self.counters["l1_hits"] / n if n else 0.0

    def stats(self) -> dict:
        s = dict(self.counters)
        s["hit_ratio"] = self.hit_ratio()
        for name, lru in (("l1", self.l1), ("l2", self.l2)):
            s[name] = (None if lru is None else
                       {"entries": len(lru), "nbytes": lru.nbytes,
                        **lru.stats})
        return s

    def export_metrics(self, reg) -> None:
        """Mirror cache counters + per-level occupancy into a telemetry
        registry."""
        for k, v in self.counters.items():
            reg.counter("cache", key=k).set_total(v)
        reg.gauge("cache_hit_ratio").set(self.hit_ratio())
        for name, lru in (("l1", self.l1), ("l2", self.l2)):
            if lru is None:
                continue
            reg.gauge("cache_entries", level=name).set(len(lru))
            reg.gauge("cache_nbytes", level=name).set(lru.nbytes)
            for k, v in lru.stats.items():
                reg.counter("cache_level", level=name, key=k).set_total(v)


def ingest_epoch(epoch: tuple, counter: int) -> tuple:
    """Fold the live-ingest generation counter into a coverage/fault epoch.

    Every applied feed batch and every merge bumps the counter, so L1/L2
    entries filled before a mutation can never be served after it — the
    same mechanism that keeps fault-window entries from leaking across
    partition state changes.  With ingest disabled the epoch is passed
    through untouched, keeping cache behavior bit-identical.
    """
    return tuple(epoch) + (("ingest", int(counter)),)
