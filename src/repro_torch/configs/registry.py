"""Architecture registry: ``get_arch(id)`` -> (config, family).

A port of the reference's ``configs/registry.py``: one module per
architecture under ``repro_torch/configs/`` (the LM family, DimeNet, the
four recsys heads and the paper's ISN), each with the reference's
``FAMILY``, ``CONFIG`` and ``REDUCED``; ``all_cells`` lists every (arch,
shape) cell of ``configs/shapes``.
"""

from __future__ import annotations

import importlib

ARCH_IDS = [
    "yi_6b", "minitron_8b", "minicpm3_4b", "moonshot_v1_16b_a3b",
    "granite_moe_3b_a800m",
    "dimenet",
    "bert4rec", "xdeepfm", "two_tower_retrieval", "deepfm",
    "paper_isn",
]

_ALIAS = {i.replace("_", "-"): i for i in ARCH_IDS}


def _module(arch_id: str):
    arch_id = _ALIAS.get(arch_id, arch_id)
    return importlib.import_module(f"repro_torch.configs.{arch_id}")


def get_arch(arch_id: str):
    mod = _module(arch_id)
    return mod.CONFIG, mod.FAMILY


def get_reduced(arch_id: str):
    mod = _module(arch_id)
    return mod.REDUCED, mod.FAMILY


def all_cells():
    """Every (arch × shape) dry-run cell (40 assigned + paper ISN extras)."""
    from repro_torch.configs.shapes import FAMILY_SHAPES
    cells = []
    for a in ARCH_IDS:
        _, family = get_arch(a)
        for s in FAMILY_SHAPES[family]:
            cells.append((a, s))
    return cells
