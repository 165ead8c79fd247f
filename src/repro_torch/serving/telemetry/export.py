"""Snapshot renderers: Prometheus text format and deterministic JSON.

``render_json`` is the canonical byte-deterministic export (sorted keys,
fixed indentation, trailing newline) — two same-seed runs produce
identical bytes.  ``render_prometheus`` emits the same snapshot in the
text exposition format so any Prometheus-compatible scraper can ingest
it; histograms become summary-style quantile series.

A copy of ``repro.serving.telemetry.export`` (the port imports nothing of
the reference package).
"""

from __future__ import annotations

import json
import re

__all__ = ["render_json", "render_prometheus", "legacy_stats_view"]

_NAME_RE = re.compile(r"[^a-zA-Z0-9_:]")
_KEYED = re.compile(r'^([a-zA-Z0-9_:.]+)\{(.*)\}$')


def render_json(snap: dict) -> str:
    return json.dumps(snap, indent=2, sort_keys=True, default=float) + "\n"


def _split(key: str) -> tuple[str, str]:
    """Split a registry key into (metric name, label string)."""
    m = _KEYED.match(key)
    if m:
        return m.group(1), m.group(2)
    return key, ""


def _prom_name(name: str) -> str:
    return "repro_" + _NAME_RE.sub("_", name)


def _series(name: str, labels: str, extra: str = "") -> str:
    inner = ",".join(x for x in (labels, extra) if x)
    return f"{name}{{{inner}}}" if inner else name


def render_prometheus(snap: dict) -> str:
    """Prometheus text exposition of a registry snapshot dict."""
    lines: list[str] = []
    seen: set[str] = set()

    def head(pname: str, kind: str) -> None:
        if pname not in seen:
            seen.add(pname)
            lines.append(f"# TYPE {pname} {kind}")

    for key, v in snap.get("counters", {}).items():
        name, labels = _split(key)
        pname = _prom_name(name) + "_total"
        head(pname, "counter")
        lines.append(f"{_series(pname, labels)} {v:g}")
    for key, v in snap.get("gauges", {}).items():
        name, labels = _split(key)
        pname = _prom_name(name)
        head(pname, "gauge")
        lines.append(f"{_series(pname, labels)} {v:g}")
    for key, h in snap.get("histograms", {}).items():
        name, labels = _split(key)
        pname = _prom_name(name)
        head(pname, "summary")
        for q, fld in (("0.5", "p50"), ("0.95", "p95"),
                       ("0.99", "p99"), ("0.9999", "p99.99")):
            if fld in h:
                qlabel = 'quantile="%s"' % q
                lines.append(f"{_series(pname, labels, qlabel)} "
                             f"{h[fld]:g}")
        lines.append(f"{pname}_sum{{{labels}}} {h.get('sum', 0.0):g}"
                     if labels else f"{pname}_sum {h.get('sum', 0.0):g}")
        lines.append(f"{pname}_count{{{labels}}} {h.get('count', 0)}"
                     if labels else f"{pname}_count {h.get('count', 0)}")
    return "\n".join(lines) + "\n"


def legacy_stats_view(snap: dict, section: str) -> dict:
    """Reconstruct a legacy ``stats()`` scalar section from registry
    metrics exported with a ``key="<orig-key>"`` label.

    Counters mirrored via ``reg.counter(section, key=k).set_total(v)``
    come back as ``{k: v}`` with integral values cast to int, preserving
    the shape existing tests and benches consume.
    """
    out: dict = {}
    prefix = f'{section}{{key="'
    for kind in ("counters", "gauges"):
        for key, v in snap.get(kind, {}).items():
            if key.startswith(prefix) and key.endswith('"}'):
                orig = key[len(prefix):-2]
                out[orig] = int(v) if float(v).is_integer() else float(v)
    return out
