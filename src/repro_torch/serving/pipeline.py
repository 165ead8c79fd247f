"""Compatibility shim: the historical ``CascadePipeline`` constructor on
top of the spec-built ``SearchSystem``.

The port of ``repro.serving.pipeline``.  ``CascadePipeline`` keeps the
pre-spec keyword surface (an untyped model dict plus loose knobs) for
existing callers and tests: it assembles the equivalent one-shard
``CascadeSpec`` and delegates everything to ``SearchSystem`` on ``device``
(the card unless the caller names the CPU), so its results are those of
that system, bit for bit.  New code should build a spec (or pick a preset
from ``repro_torch.configs.cascade_presets``) and call ``build_system``.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.index.builder import InvertedIndex
from repro_torch.ltr.ranker import LTRModel
from repro_torch.serving.latency import CostModel
from repro_torch.serving.scheduler import SchedulerConfig
from repro_torch.serving.spec import (BackendSpec, CascadeSpec, DeploySpec,
                                      IndexSpec, Stage2Spec)
from repro_torch.serving.system import (PipelineResult, SearchSystem,  # noqa: F401
                                        routing_spec)


class CascadePipeline(SearchSystem):
    """The whole multi-stage retrieval cascade as one batched query program.

    Args:
      index: the built collection (both mirrors + Stage-0 stats).
      models: ``{"k": GBRTModel, "rho": ..., "t": ...}`` Stage-0 predictors.
      cfg: scheduler/routing configuration.
      corpus: required when ``ltr`` is given (Stage-2 reads doc topics).
      ltr: Stage-2 point-wise LTR model; None serves Stage-1 only.
      k_serve: Stage-1 retrieval depth (the candidate grid width C).
      t_final: result-list depth after Stage-2.
      backend: a shipped spec's backend field: None or the reference's
        "pallas" | "interpret" | "jnp" (it selects nothing: the device
        picks the path).
      device: where the cascade runs (the card unless the caller names
        the CPU).
    """

    def __init__(self, index: InvertedIndex, models: dict,
                 cfg: SchedulerConfig, *, corpus=None,
                 ltr: LTRModel | None = None, k_serve: int = 128,
                 t_final: int = 10, cost: CostModel | None = None,
                 backend: str | None = None,
                 device: str | torch.device | None = None):
        spec = CascadeSpec(
            index=IndexSpec(block_size=index.block_size),
            routing=routing_spec(cfg),
            stage2=Stage2Spec(enabled=ltr is not None, k_serve=k_serve,
                              t_final=t_final),
            backend=BackendSpec(backend=backend),
            # replicas=2 so the single partition holds one replica of EACH
            # mirror (a 1-replica pool is JASS-only and would count all BMW
            # traffic through the mirror-exhaustion fallback)
            deploy=DeploySpec(n_shards=1, replicas=2, rebalance_every=0),
            name="compat_pipeline",
        )
        super().__init__(spec, index, corpus=corpus, models=models, ltr=ltr,
                         cost=cost, device=device)

    # historical attribute surface: the single shard and its spec
    @property
    def shard(self):
        return self.shards[0]

    @property
    def spec(self):
        return self.shard_specs[0]

    def stage1(self, terms: np.ndarray, mask: np.ndarray, routed):
        """Historical signature: returns (topk, t_bmw).  Threads a fresh
        per-call split memo so same-batch duplicates share their SAAT
        level-cut resolution."""
        topk, _, t_bmw, _ = self._stage1_full(terms, mask, routed, {})
        return topk, t_bmw
