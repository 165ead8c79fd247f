"""Carry fitted models and specs from the JAX reference to the port.

Training is not ported yet, so the port serves models the reference
(``repro``) fitted.  This module reads them by attribute and ``np.asarray``
alone — it imports nothing of the reference package and no JAX — and builds
the port's tensors on ``device`` (the card unless the caller asks for the
CPU):

* a reference ``GBRTModel`` (``.forest.feat/.thresh/.leaf``, ``.base``,
  ``.bin_edges``, ``.params``) → ``repro_torch.core.gbrt.GBRTModel``;
* a reference ``LTRModel`` (``.model``) → ``repro_torch.ltr.ranker.LTRModel``;
* a reference ``CascadeSpec`` → the port's, through its JSON.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.gbrt import GBRTModel, GBRTParams
from repro_torch.core.trees import Forest
from repro_torch.isn.backend import resolve_device
from repro_torch.ltr.ranker import LTRModel
from repro_torch.serving.spec import CascadeSpec


def _tensor(a, dtype, device) -> torch.Tensor:
    return torch.from_numpy(np.array(a, dtype=dtype, order="C")).to(device)


def gbrt_model(ref_model, device=None) -> GBRTModel:
    """A fitted reference GBRT as the port's ``GBRTModel`` on ``device``."""
    dev = resolve_device(device)
    f = ref_model.forest
    forest = Forest(feat=_tensor(f.feat, np.int32, dev),
                    thresh=_tensor(f.thresh, np.int32, dev),
                    leaf=_tensor(f.leaf, np.float32, dev))
    params = GBRTParams(**{name: getattr(ref_model.params, name)
                           for name in GBRTParams._fields})
    return GBRTModel(forest=forest,
                     base=_tensor(ref_model.base, np.float32, dev).reshape(()),
                     bin_edges=_tensor(ref_model.bin_edges, np.float32, dev),
                     params=params)


def stage0_models(ref_models: dict, device=None) -> dict:
    """The Stage-0 predictors ({"k", "rho", "t"} → GBRTModel)."""
    return {name: gbrt_model(m, device) for name, m in ref_models.items()}


def ltr_model(ref_ltr, device=None) -> LTRModel:
    """A fitted reference LTR model as the port's ``LTRModel``."""
    return LTRModel(gbrt_model(ref_ltr.model, device))


def cascade_spec(ref_spec) -> CascadeSpec:
    """A reference ``CascadeSpec`` as the port's, through its JSON."""
    return CascadeSpec.from_json(ref_spec.to_json())


def system_models(ref_system, device=None) -> tuple[dict, LTRModel | None]:
    """(Stage-0 models, LTR model or None) of a fitted reference system."""
    ltr = (ltr_model(ref_system.ltr, device)
           if ref_system.ltr is not None else None)
    return stage0_models(ref_system.models, device), ltr
