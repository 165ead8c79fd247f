"""Synthetic data generators for every architecture family.

A NumPy copy of the reference's ``data/synthetic.py``: the same seeds and
draws, so ``lm_batches`` yields the reference's tokens bit for bit.  The
generators yield host NumPy arrays; ``data.pipeline.PrefetchingLoader``
copies them to a device.
"""

from __future__ import annotations

import numpy as np


def lm_batches(vocab: int, batch: int, seq: int, seed: int = 0,
               start_index: int = 0):
    """Deterministic, resumable token stream (Zipfian unigrams with local
    structure). `start_index` is the elastic-restart cursor."""
    probs = (np.arange(1, vocab + 1) ** -1.1)
    probs = probs / probs.sum()
    cdf = np.cumsum(probs)
    i = start_index
    while True:
        rng = np.random.RandomState((seed * 1_000_003 + i) % (1 << 31))
        u = rng.random_sample((batch, seq + 1))
        toks = np.minimum(np.searchsorted(cdf, u), vocab - 1).astype(np.int32)
        # inject local repetition so the loss can actually fall
        rep = rng.random_sample((batch, seq)) < 0.3
        toks[:, 1:][rep] = toks[:, :-1][rep]
        yield {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
        i += batch


def ctr_batches(n_fields: int, rows_per_field: int, batch: int, seed: int = 0):
    """Criteo-like CTR stream: skewed categorical ids + a planted logistic
    ground truth so AUC is learnable."""
    rng = np.random.RandomState(seed)
    w = rng.randn(n_fields) * 0.5
    while True:
        z = rng.zipf(1.3, size=(batch, n_fields)) % rows_per_field
        ids = (z + np.arange(n_fields) * rows_per_field).astype(np.int32)
        logit = (np.sin(z * 0.7) * w).sum(axis=1) - 0.5
        label = (rng.random_sample(batch) < 1 / (1 + np.exp(-logit)))
        yield {"ids": ids, "label": label.astype(np.int32)}


def seqrec_batches(n_items: int, batch: int, seq: int, n_masked: int = 8,
                   n_cands: int = 256, seed: int = 0):
    """BERT4Rec-style masked item sequences with sampled-softmax candidates."""
    rng = np.random.RandomState(seed)
    mask_token = n_items
    while True:
        items = (rng.zipf(1.2, size=(batch, seq)) % n_items).astype(np.int32)
        pos = np.stack([rng.choice(seq, n_masked, replace=False)
                        for _ in range(batch)]).astype(np.int32)
        true_items = np.take_along_axis(items, pos, axis=1)
        for b in range(batch):
            items[b, pos[b]] = mask_token
        cands = rng.randint(0, n_items, size=n_cands).astype(np.int32)
        cands[:n_masked] = true_items[0]
        label_idx = rng.randint(0, n_cands, size=(batch, n_masked))
        # plant each true item into the candidate set
        for b in range(batch):
            slots = rng.choice(n_cands, n_masked, replace=False)
            cands_local = cands.copy()
            label_idx[b] = slots
        cands[label_idx[0]] = true_items[0]
        yield {"items": items, "positions": pos,
               "label_idx": label_idx.astype(np.int32), "candidates": cands}


def molecule_batches(n_graphs: int, n_nodes: int, n_edges: int, d_feat: int,
                     trip_factor: int = 4, seed: int = 0):
    """Batched small molecules: random 3-D conformers, radius-ish edges,
    exact-ish triplets, and a smooth geometric regression target."""
    rng = np.random.RandomState(seed)
    while True:
        yield make_molecule_batch(rng, n_graphs, n_nodes, n_edges, d_feat,
                                  trip_factor)


def make_molecule_batch(rng, n_graphs, n_nodes, n_edges, d_feat,
                        trip_factor=4):
    n = n_graphs * n_nodes
    e = n_graphs * n_edges
    t = e * trip_factor
    pos = rng.randn(n, 3).astype(np.float32) * 1.5
    feat = rng.randn(n, d_feat).astype(np.float32) * 0.3
    src = np.zeros(e, np.int32)
    dst = np.zeros(e, np.int32)
    for g in range(n_graphs):
        s = rng.randint(0, n_nodes, n_edges) + g * n_nodes
        d = rng.randint(0, n_nodes, n_edges) + g * n_nodes
        src[g * n_edges:(g + 1) * n_edges] = s
        dst[g * n_edges:(g + 1) * n_edges] = d
    # triplets: edge pairs sharing the middle node
    order = np.argsort(dst, kind="stable")
    sorted_dst = dst[order]
    ji = rng.randint(0, e, t)
    j = src[ji]
    lo = np.searchsorted(sorted_dst, j, "left")
    hi = np.searchsorted(sorted_dst, j, "right")
    span = np.maximum(hi - lo, 1)
    kj = order[np.minimum(lo + rng.randint(0, 1 << 30, t) % span, e - 1)]
    tmask = ((hi > lo) & (kj != ji)).astype(np.float32)
    # smooth target: sum of inverse pairwise distances along edges
    dvec = pos[src] - pos[dst]
    dd = np.sqrt((dvec ** 2).sum(1) + 1e-6)
    target = np.zeros(n, np.float32)
    np.add.at(target, dst, 1.0 / (1.0 + dd))
    return {
        "feat": feat, "pos": pos,
        "edge_src": src, "edge_dst": dst,
        "trip_kj": kj.astype(np.int32), "trip_ji": ji.astype(np.int32),
        "edge_mask": np.ones(e, np.float32), "trip_mask": tmask,
        "node_mask": np.ones(n, np.float32), "target": target,
    }
