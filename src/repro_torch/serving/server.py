"""Compatibility shim: the historical Stage-1-only ``HybridServer``
interface on top of the spec-built serving stack.

The port of ``repro.serving.server``.  ``HybridServer(index, models, cfg)``
assembles a one-shard, Stage-1-only ``CascadeSpec`` (through the
``CascadePipeline`` shim) and delegates serving to ``SearchSystem`` on
``device`` (the card unless the caller names the CPU): the
``stage1_only`` operating point the preset registry names.  The
budget-guarantee tests drive this class.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from repro_torch.index.builder import InvertedIndex
from repro_torch.serving.latency import CostModel
from repro_torch.serving.pipeline import CascadePipeline
from repro_torch.serving.scheduler import SchedulerConfig


@dataclass
class ServeResult:
    topk: np.ndarray
    latency: np.ndarray
    stats: dict


class HybridServer:
    """One ISN worth of the paper's hybrid system, servable end to end:
    serves the first stage and reports Stage-0 + Stage-1 latency."""

    def __init__(self, index: InvertedIndex, models: dict,
                 cfg: SchedulerConfig, k_serve: int = 128,
                 cost: CostModel | None = None,
                 device: str | torch.device | None = None):
        self.pipeline = CascadePipeline(index, models, cfg, k_serve=k_serve,
                                        cost=cost, device=device)
        # historical attribute surface
        self.index = index
        self.shard = self.pipeline.shard
        self.spec = self.pipeline.spec
        self.models = models
        self.cost = self.pipeline.cost
        self.sched = self.pipeline.sched
        self.k_serve = k_serve

    def stage0(self, terms: np.ndarray, mask: np.ndarray):
        return self.pipeline.stage0(terms, mask)

    def serve(self, terms: np.ndarray, mask: np.ndarray) -> ServeResult:
        res = self.pipeline.serve(terms, mask)
        return ServeResult(topk=res.topk, latency=res.latency,
                           stats=res.stats)
