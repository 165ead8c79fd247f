"""Hybrid ISN routing — Algorithms 1 and 2 from the paper.

Given the Stage-0 predictions for a query trace, decide per query which
index mirror serves it and with what parameters:

* Algorithm 1 (``Hybrid_k``):  P_k > T_k          → JASS(P_k, min(P_ρ, ρ_max))
                                else               → BMW(P_k), rank-safe
* Algorithm 2 (``Hybrid_h``):  P_k > T_k OR P_t > T_t → JASS, else BMW

ρ is always capped at ρ_max; operating points whose ρ_max · per-posting
cost is under the budget get the worst-case guarantee from the cap alone.
For the large-ρ_max presets the guarantee comes from the scheduler's
deadline re-route instead (`repro.serving.scheduler`, "Guarantee
accounting"): stragglers are re-issued with the small `late_rho` cap.

These are pure routing functions over arrays; the online path
(`repro.serving.scheduler`) applies the same logic per request batch.

A copy of ``repro.core.hybrid`` (the port imports nothing of the reference
package).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

ROUTE_BMW = 0
ROUTE_JASS = 1


@dataclass(frozen=True)
class HybridConfig:
    t_k: float = 1000.0        # k threshold T_k
    t_time_us: float = 150.0   # response-time threshold T_t (Algorithm 2)
    rho_max: int = 1 << 20     # postings cap → worst-case guarantee
    rho_min: int = 4096        # floor: never run JASS below this budget
    k_min: int = 10
    k_max: int = 16384


def route_algorithm1(pred_k: np.ndarray, cfg: HybridConfig) -> np.ndarray:
    return np.where(pred_k > cfg.t_k, ROUTE_JASS, ROUTE_BMW)


def route_algorithm2(pred_k: np.ndarray, pred_t_us: np.ndarray,
                     cfg: HybridConfig) -> np.ndarray:
    jass = (pred_k > cfg.t_k) | (pred_t_us > cfg.t_time_us)
    return np.where(jass, ROUTE_JASS, ROUTE_BMW)


def clamp_parameters(pred_k: np.ndarray, pred_rho: np.ndarray,
                     cfg: HybridConfig) -> tuple[np.ndarray, np.ndarray]:
    k = np.clip(np.round(pred_k), cfg.k_min, cfg.k_max).astype(np.int64)
    rho = np.clip(np.round(pred_rho), cfg.rho_min, cfg.rho_max).astype(np.int64)
    return k, rho
