"""The dense Stage-1 engine: sharded query×doc similarity top-k.

The port of ``repro.dense.engine``.  The embedding matrix is partitioned by
the same contiguous doc ranges as the inverted index (``shard_ranges``);
per-shard results carry global doc ids and merge through
``merge_shard_topk`` (ascending doc-range order and a stable top-k keep
the lower-global-doc-id tie rule; ``drop`` masks degrade a dense query
exactly like a lexical one).  Per-shard cost is shape-static: every query
scores every doc of every shard, so ``CostModel.dense_time(n_tiles)``
prices the route from the spec alone.

Each shard's scan is one call of ``repro_torch.kernels.dense_topk``: the
hand-written CUDA kernel on the card, its plain version on the CPU.  On
grid-quantized embeddings ``serve`` equals the unsharded brute force
(``oracle``) bit for bit.

Live ingest attaches a capacity-padded delta matrix (``set_delta``) that
every query also scans: the whole capacity is ranked (k = its row count,
one more kernel call), ghost rows are masked after the ranking, and the
delta's list joins the merge last, never dropped.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.dense.embeddings import embed_queries
from repro_torch.isn.backend import merge_shard_topk, resolve_device
from repro_torch.kernels.dense_topk.ops import dense_topk, dense_topk_plain
from repro_torch.serving.telemetry.host import to_card, to_host

SCORE_FILL = float(np.finfo(np.float32).min)


class DenseEngine:
    """Doc-range-sharded dense retrieval over a quantized embedding matrix.

    Args:
      doc_emb: (n_docs, d) float32 grid-quantized doc embeddings (host).
      term_table: (vocab, d) float32 grid-quantized per-term vectors
        (queries embed as the quantized mean of their active terms).
      ranges: the deployment's ``shard_ranges`` — the same doc-range
        partitioning the lexical shards use.
      tile_d: docs per tile of the reference kernel's grid.  It sets the
        modeled cost (``n_tiles``), not the CUDA kernel's own chunking.
      device: where the shard embeddings live (the card unless the caller
        asks for the CPU).
    """

    def __init__(self, doc_emb: np.ndarray, term_table: np.ndarray,
                 ranges, *, tile_d: int = 512, device=None):
        self.device = resolve_device(device)
        self.doc_emb = np.asarray(doc_emb, np.float32)
        self.term_table = np.asarray(term_table, np.float32)
        self.tile_d = int(tile_d)
        self.d = self.doc_emb.shape[1]
        self.doc_lo = [lo for lo, _ in ranges]
        full = torch.from_numpy(self.doc_emb).to(self.device)
        self.shard_emb = [full[lo:hi] for lo, hi in ranges]
        self.shard_docs = [hi - lo for lo, hi in ranges]
        # live delta segment (capacity-padded, appended above the ranges)
        self.delta_emb = None
        self.delta_live = 0
        self.delta_lo = 0

    @property
    def n_shards(self) -> int:
        return len(self.shard_emb)

    def n_tiles(self, s: int) -> int:
        """Tiles of shard ``s`` in the reference kernel's grid,
        ``ceil(shard_docs / tile_d)`` — the shape-static work unit the cost
        model prices."""
        return -(-self.shard_docs[s] // self.tile_d)

    def max_tiles(self) -> int:
        """Largest per-shard tile count: the scatter-gather bound's term."""
        return max(self.n_tiles(s) for s in range(self.n_shards))

    def embed(self, terms: np.ndarray, mask: np.ndarray) -> np.ndarray:
        """(Q, d) quantized query embeddings (host, row-independent)."""
        return embed_queries(self.term_table, terms, mask)

    def set_delta(self, emb: np.ndarray, n_live: int, doc_lo: int) -> None:
        """Attach/refresh the live delta segment.

        ``emb`` is the capacity-padded (cap, d) quantized matrix (rows
        >= ``n_live`` are ghosts), ``doc_lo`` the global id of delta doc 0.
        The shape is the fixed delta capacity, whatever the fill.  The
        matrix is copied to the engine's device as a new tensor.
        """
        self.delta_emb = torch.from_numpy(
            np.ascontiguousarray(emb, np.float32)).to(self.device)
        self.delta_live = int(n_live)
        self.delta_lo = int(doc_lo)

    def clear_delta(self) -> None:
        self.delta_emb = None
        self.delta_live = 0
        self.delta_lo = 0

    def delta_tiles(self) -> int:
        """Tiles the delta scan adds to every query's cost (the reference
        kernel's grid over the delta capacity)."""
        if self.delta_emb is None:
            return 0
        return -(-int(self.delta_emb.shape[0]) // self.tile_d)

    def serve(self, q_emb: np.ndarray, k: int, drop=None):
        """Scatter-gather dense top-k: host (ids int64, scores f32), each
        (Q, k).

        Ids are global; ``drop`` ((n_shards, Q) bool) excludes lost or
        never-requested shard responses like the lexical merge (surviving-
        shard merge, ``-1`` padding).  Requires ``k <= min(shard docs)``.
        With a delta attached its whole capacity is ranked and ghost rows
        are masked to id -1 / float32-min after the ranking: a ghost's
        zero vector scores 0, which would outrank genuinely negative live
        scores, and asking for only k could let ghosts displace live docs.
        """
        q_t = to_card(np.ascontiguousarray(q_emb, np.float32), self.device)
        sc_list, id_list = [], []
        for s in range(self.n_shards):
            sc, ids = dense_topk(q_t, self.shard_emb[s], k)
            sc_list.append(sc)
            id_list.append(ids + self.doc_lo[s])
        if self.n_shards == 1 and self.delta_emb is None:
            ids = to_host(id_list[0]).numpy()
            sc = to_host(sc_list[0]).numpy()
            if drop is not None and drop[0].any():
                ids[drop[0]] = -1
                sc[drop[0]] = SCORE_FILL
            return ids, sc
        if self.delta_emb is not None:
            cap = int(self.delta_emb.shape[0])
            dsc, dids = dense_topk(q_t, self.delta_emb, cap)
            ghost = dids >= self.delta_live
            sc_list.append(torch.where(ghost, SCORE_FILL, dsc))
            id_list.append(torch.where(ghost, -1, dids + self.delta_lo))
            if drop is not None:
                drop = np.concatenate(
                    [np.asarray(drop),
                     np.zeros((1, np.asarray(drop).shape[1]), bool)])
        ids, sc = merge_shard_topk(sc_list, id_list, k, drop=drop)
        return to_host(ids).numpy(), to_host(sc).numpy()

    def oracle(self, q_emb: np.ndarray, k: int):
        """Brute-force ground truth over the unsharded matrix, on the CPU:
        host (ids, scores) — what ``serve`` must match bit for bit."""
        sc, ids = dense_topk_plain(torch.from_numpy(
            np.ascontiguousarray(q_emb, np.float32)),
            torch.from_numpy(self.doc_emb), k)
        return ids.numpy(), sc.numpy()
