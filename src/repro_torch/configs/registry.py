"""Architecture registry: ``get_arch(id)`` -> (config, family).

A port of the reference's ``configs/registry.py`` over the configurations
the port has: the LM family (Yi-6B, Minitron-8B, MiniCPM3-4B, Moonlight,
granite-MoE) and the paper's ISN.  The GNN and recsys heads (``dimenet``,
``bert4rec``, ``deepfm``, ``xdeepfm``) and the full two-tower
configuration are not ported yet and raise ``NotImplementedError`` naming
ROADMAP §1 item 11 (the port has the two-tower's ``REDUCED`` tower only,
``configs.two_tower_retrieval``).  ``all_cells`` and ``configs/shapes``
go with the dry run of the launch stack.
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
UNPORTED = ("dimenet", "bert4rec", "xdeepfm", "two_tower_retrieval",
            "deepfm")

_ALIAS = {i.replace("_", "-"): i for i in ARCH_IDS}


def _module(arch_id: str):
    arch_id = _ALIAS.get(arch_id, arch_id)
    if arch_id in UNPORTED:
        raise NotImplementedError(
            f"architecture {arch_id!r} is not ported yet (ROADMAP §1 item "
            f"11)")
    return importlib.import_module(f"repro_torch.configs.{arch_id}")


def get_arch(arch_id: str):
    mod = _module(arch_id)
    return mod.CONFIG, mod.FAMILY


def get_reduced(arch_id: str):
    mod = _module(arch_id)
    return mod.REDUCED, mod.FAMILY
