"""The dense Stage-1 modality: embeddings, the sharded engine, fusion."""

from repro_torch.dense.embeddings import (GRID, build_embeddings,
                                          embed_queries, quantize,
                                          synthetic_embeddings)
from repro_torch.dense.engine import DenseEngine
from repro_torch.dense.fusion import (M_BOTH, M_DENSE, M_LEX, fuse, rrf_fuse,
                                      weighted_fuse)

__all__ = ["GRID", "M_BOTH", "M_DENSE", "M_LEX", "DenseEngine",
           "build_embeddings", "embed_queries", "fuse", "quantize",
           "rrf_fuse", "synthetic_embeddings", "weighted_fuse"]
