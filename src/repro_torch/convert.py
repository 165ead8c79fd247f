"""Carry fitted models and specs from the JAX reference to the port.

The port fits its own models (``SearchSystem.fit``, bit-equal to the
reference's); this module carries the reference's across where a test or a
run compares the two or serves what ``repro`` fitted.  It reads them by
attribute and ``np.asarray`` alone — it imports nothing of the reference
package and no JAX — and builds the port's tensors on ``device`` (the card
unless the caller asks for the CPU):

* a reference ``GBRTModel`` (``.forest.feat/.thresh/.leaf``, ``.base``,
  ``.bin_edges``, ``.params``) → ``repro_torch.core.gbrt.GBRTModel``;
* a reference ``LTRModel`` (``.model``) → ``repro_torch.ltr.ranker.LTRModel``;
* a reference ``RFModel`` (``.forest``, ``.bin_edges``, ``.params``) and
  ``LinRegModel`` (``.w``, ``.b``, ``.mu``, ``.sigma``) → the port's
  ``core.random_forest.RFModel`` and ``core.linreg.LinRegModel``;
* the reference's two-tower params (``recsys.init(REDUCED, key)``: tables
  and per-side MLP dicts) → ``repro_torch.models.recsys.TwoTower``;
* the reference's LM params (``transformer.init(c, key)``: ``embed``,
  ``unembed``, ``final_ln``, stacked ``layers`` with GQA or MLA attention
  and a dense or MoE FFN) → the port's tree of tensors
  (``repro_torch.models.transformer``);
* the reference's recsys parameter trees (``recsys.init(c, key)`` of each
  kind: DeepFM, xDeepFM, two-tower, BERT4Rec) and DimeNet's
  (``gnn.init(c, key)``) → the port's trees of tensors, leaf by leaf
  (``repro_torch.models.recsys``, ``repro_torch.models.gnn``);
* the reference's AdamW state (``train.optimizer.OptState``: fp32 moment
  trees beside the parameters, an int32 step) → the port's
  ``repro_torch.train.optimizer.OptState``;
* a reference ``CascadeSpec`` → the port's, through its JSON;
* the reference's in-step Stage-0 ensemble (``repro.isn.shard.ForestArrays``)
  → the port's ``repro_torch.isn.shard.ForestArrays``.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.gbrt import GBRTModel, GBRTParams
from repro_torch.core.linreg import LinRegModel
from repro_torch.core.random_forest import RFModel, RFParams
from repro_torch.core.trees import Forest
from repro_torch.isn.backend import resolve_device
from repro_torch.isn.shard import ForestArrays
from repro_torch.ltr.ranker import LTRModel
from repro_torch.models.recsys import SIDES, TwoTower
from repro_torch.models.transformer import ATTN_KEYS, FFN_KEYS
from repro_torch.serving.spec import CascadeSpec
from repro_torch.train.optimizer import OptState


def _tensor(a, dtype, device) -> torch.Tensor:
    return torch.from_numpy(np.array(a, dtype=dtype, order="C")).to(device)


def _forest(f, dev) -> Forest:
    return Forest(feat=_tensor(f.feat, np.int32, dev),
                  thresh=_tensor(f.thresh, np.int32, dev),
                  leaf=_tensor(f.leaf, np.float32, dev))


def _params(cls, ref_params):
    return cls(**{name: getattr(ref_params, name) for name in cls._fields})


def gbrt_model(ref_model, device=None) -> GBRTModel:
    """A fitted reference GBRT as the port's ``GBRTModel`` on ``device``."""
    dev = resolve_device(device)
    return GBRTModel(forest=_forest(ref_model.forest, dev),
                     base=_tensor(ref_model.base, np.float32, dev).reshape(()),
                     bin_edges=_tensor(ref_model.bin_edges, np.float32, dev),
                     params=_params(GBRTParams, ref_model.params))


def rf_model(ref_model, device=None) -> RFModel:
    """A fitted reference random forest as the port's ``RFModel``."""
    dev = resolve_device(device)
    return RFModel(forest=_forest(ref_model.forest, dev),
                   bin_edges=_tensor(ref_model.bin_edges, np.float32, dev),
                   params=_params(RFParams, ref_model.params))


def linreg_model(ref_model, device=None) -> LinRegModel:
    """A fitted reference ridge model as the port's ``LinRegModel``."""
    dev = resolve_device(device)
    return LinRegModel(*(_tensor(getattr(ref_model, name), np.float32, dev)
                         for name in LinRegModel._fields))


def stage0_models(ref_models: dict, device=None) -> dict:
    """The Stage-0 predictors ({"k", "rho", "t"} → GBRTModel)."""
    return {name: gbrt_model(m, device) for name, m in ref_models.items()}


def ltr_model(ref_ltr, device=None) -> LTRModel:
    """A fitted reference LTR model as the port's ``LTRModel``."""
    return LTRModel(gbrt_model(ref_ltr.model, device))


def two_tower_params(ref_params, device=None) -> TwoTower:
    """The reference's two-tower parameter tree as the port's ``TwoTower``
    on ``device`` (each leaf read by key, as float32)."""
    params = {}
    for side in SIDES:
        params[f"{side}_table"] = np.asarray(ref_params[f"{side}_table"],
                                             np.float32)
        params[f"{side}_mlp"] = {k: np.asarray(v, np.float32)
                                 for k, v in ref_params[f"{side}_mlp"].items()}
    return TwoTower(params, device)


def _lm_leaf(a, device, dtype) -> torch.Tensor:
    """One leaf as a tensor of ``dtype`` (default: its own; a bfloat16 leaf
    passes through float32, which holds it exactly)."""
    a = np.asarray(a)
    own = torch.bfloat16 if a.dtype.name == "bfloat16" else torch.float32
    t = torch.from_numpy(np.array(a, dtype=np.float32, order="C"))
    return t.to(device=device, dtype=dtype or own)


def lm_params(ref_params, device=None, dtype=None) -> dict:
    """The reference's LM parameter tree as the port's, on ``device``, each
    leaf read by key (``dtype`` None keeps each leaf's): GQA or MLA
    attention (MLA's tree holds ``wdq``), a dense or MoE FFN (MoE's holds
    ``router``, and ``shared_gate`` with shared experts)."""
    dev = resolve_device(device)
    lay = ref_params["layers"]
    ffn = FFN_KEYS["dense"]
    if "router" in lay["ffn"]:
        ffn = FFN_KEYS["moe"] + (FFN_KEYS["shared"]
                                 if "shared_gate" in lay["ffn"] else ())
    keys = {"attn": ATTN_KEYS["mla" if "wdq" in lay["attn"] else "gqa"],
            "ffn": ffn}
    layers = {group: {k: _lm_leaf(lay[group][k], dev, dtype) for k in ks}
              for group, ks in keys.items()}
    for k in ("ln1", "ln2"):
        layers[k] = _lm_leaf(lay[k], dev, dtype)
    params = {k: _lm_leaf(ref_params[k], dev, dtype)
              for k in ("embed", "unembed", "final_ln")}
    params["layers"] = layers
    return params


def _tree(ref, device, dtype=None):
    """A nested dict of arrays as the same dict of tensors (each leaf read
    by key, ``dtype`` None keeping each leaf's)."""
    if isinstance(ref, dict):
        return {k: _tree(v, device, dtype) for k, v in ref.items()}
    return _lm_leaf(ref, device, dtype)


def recsys_params(ref_params, device=None, dtype=None) -> dict:
    """The reference's recsys parameter tree (any kind) as the port's, on
    ``device``."""
    return _tree(ref_params, resolve_device(device), dtype)


# DimeNet's tree is a nested dict of arrays too, carried over the same way
gnn_params = recsys_params


def opt_state(ref_opt, device=None, like=None) -> OptState:
    """The reference's AdamW state as the port's on ``device``: each moment
    leaf as an fp32 tensor, read by the keys of ``like`` (the port's
    parameter tree; the reference's moment tree when None), and the step
    as an int32 scalar."""
    dev = resolve_device(device)

    def tree(ref, shape):
        return {k: tree(ref[k], v) if isinstance(v, dict)
                else _lm_leaf(ref[k], dev, torch.float32)
                for k, v in shape.items()}
    like = like if like is not None else ref_opt.m
    step = torch.tensor(int(np.asarray(ref_opt.step)), dtype=torch.int32,
                        device=dev)
    return OptState(tree(ref_opt.m, like), tree(ref_opt.v, like), step)


def cascade_spec(ref_spec) -> CascadeSpec:
    """A reference ``CascadeSpec`` as the port's, through its JSON."""
    return CascadeSpec.from_json(ref_spec.to_json())


def forest_arrays(ref_fa, device=None) -> ForestArrays:
    """The reference's ``ForestArrays`` (three targets' trees, bases and the
    shared bin edges) as the port's on ``device``."""
    dev = resolve_device(device)
    return ForestArrays(feat=_tensor(ref_fa.feat, np.int32, dev),
                        thresh=_tensor(ref_fa.thresh, np.int32, dev),
                        leaf=_tensor(ref_fa.leaf, np.float32, dev),
                        base=_tensor(ref_fa.base, np.float32, dev),
                        bin_edges=_tensor(ref_fa.bin_edges, np.float32, dev))


def system_models(ref_system, device=None) -> tuple[dict, LTRModel | None]:
    """(Stage-0 models, LTR model or None) of a fitted reference system."""
    ltr = (ltr_model(ref_system.ltr, device)
           if ref_system.ltr is not None else None)
    return stage0_models(ref_system.models, device), ltr
