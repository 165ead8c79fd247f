"""Elastic scaling: the batch and data-cursor arithmetic of a restart on
another device count.

A port of the reference's ``train/elastic.py``.  Checkpoints hold whole
(unsharded) arrays by logical name (``train.checkpoint``), so a restart
places them onto its own mesh (``reshard_tree``: each leaf's logical names
resolved under the rules and fitted to its shape, then a DTensor of that
spec) and re-derives the batch split and the data cursor.
"""

from __future__ import annotations

from repro_torch.models import common


def sharding_tree(tree, names_tree, rules, mesh):
    """The ``NamedSharding`` of every leaf of ``tree`` on ``mesh``: its
    names' spec under ``rules``, fitted to the leaf's shape."""
    if isinstance(tree, dict):
        return {k: sharding_tree(v, names_tree[k], rules, mesh)
                for k, v in tree.items()}
    spec = common.fit_spec_to_shape(
        common.resolve_pspec(names_tree, rules, mesh), tree.shape, mesh)
    return common.NamedSharding(mesh, spec)


def reshard_tree(tree, names_tree, rules, mesh):
    """Place an (unsharded, host) tree onto ``mesh`` per the logical rules:
    each leaf a DTensor whose local shard is this rank's block, cut from the
    whole leaf every rank holds (no scatter from another rank)."""
    if isinstance(tree, dict):
        return {k: reshard_tree(v, names_tree[k], rules, mesh)
                for k, v in tree.items()}
    return common.distribute(tree, sharding_tree(tree, names_tree, rules,
                                                 mesh))


def rebalance_batch_size(global_batch: int, old_ways: int, new_ways: int):
    """Keep the global batch when the DP degree changes; returns the new
    per-replica batch and the padded global batch if not divisible."""
    per = -(-global_batch // new_ways)
    return per, per * new_ways


def data_cursor_after_restart(step: int, global_batch: int) -> int:
    """Deterministic data-pipeline cursor: sample index to resume from."""
    return step * global_batch
