"""Keeping JAX, the JAX package and its benchmarks out of a run.

Module names are compared by their top-level name (the part before the
first dot), taken whole: ``repro_torch`` is the port and passes, ``repro``
is the JAX package and does not.
"""

from __future__ import annotations

import sys

BANNED = frozenset({"jax", "jaxlib", "flax", "repro", "benchmarks"})


def top(name: str) -> str:
    return name.split(".")[0]


def loaded() -> list[str]:
    """The banned modules in ``sys.modules``."""
    return sorted(m for m in list(sys.modules) if top(m) in BANNED)


def clean() -> bool:
    """True where no banned module is loaded; else names them on standard
    error."""
    bad = loaded()
    if bad:
        print("portbench: loaded " + ", ".join(bad), file=sys.stderr)
    return not bad


class _Refuse:
    """A meta-path finder that refuses the banned names."""

    def find_spec(self, name, path=None, target=None):
        if top(name) in BANNED:
            raise ImportError(f"portbench: {name!r} may not be imported "
                              "(JAX, the JAX package or its benchmarks)")
        return None


def install() -> None:
    """Refuse every later import of a banned module."""
    if not any(isinstance(f, _Refuse) for f in sys.meta_path):
        sys.meta_path.insert(0, _Refuse())
