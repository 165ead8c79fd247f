"""Elastic scaling: the batch and data-cursor arithmetic of a restart on
another device count.

A port of the reference's ``train/elastic.py``.  Checkpoints hold whole
(unsharded) arrays by logical name (``train.checkpoint``), so a restart
restores them onto its own devices and re-derives the batch split and the
data cursor.  ``reshard_tree`` places a tree onto a mesh by the logical
sharding rules of the launch stack, which is not ported yet: it raises
``NotImplementedError`` naming ROADMAP §1 item 11.
"""

from __future__ import annotations


def reshard_tree(tree, names_tree, rules, mesh):
    raise NotImplementedError(
        "reshard_tree needs the launch stack's logical-rule sharding, which "
        "is not ported yet (ROADMAP §1 item 11)")


def rebalance_batch_size(global_batch: int, old_ways: int, new_ways: int):
    """Keep the global batch when the DP degree changes; returns the new
    per-replica batch and the padded global batch if not divisible."""
    per = -(-global_batch // new_ways)
    return per, per * new_ways


def data_cursor_after_restart(step: int, global_batch: int) -> int:
    """Deterministic data-pipeline cursor: sample index to resume from."""
    return step * global_batch
