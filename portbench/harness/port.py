"""The program's side of a configuration: the port's system built from the
benchmark's collection and fitted on its fit log, and its fitted forests
read back for the check.  The port is imported only here and in the
configurations' modules, when a run builds it."""

from __future__ import annotations

import numpy as np

from portbench.harness.traffic import fit_log


def program_corpus(cfg: dict, corpus: dict):
    from repro_torch.index.corpus import Corpus, CorpusParams
    return Corpus(CorpusParams(**cfg["corpus"]), **corpus)


def fitted_system(cfg: dict, corpus: dict, device, preset: str,
                  stage2: bool = True):
    """The port's system of ``preset`` on ``device``, built from the
    collection and fitted on the configuration's fit log (Stage-2 off
    where ``stage2`` is false: the Stage-0 forests are the same, since the
    LTR fit draws after their targets).  Returns (system, index,
    layouts)."""
    from dataclasses import replace

    from repro_torch.configs.cascade_presets import get_preset
    from repro_torch.index.builder import build_index
    from repro_torch.index.corpus import QueryLog
    from repro_torch.index.postings import shard_layouts
    from repro_torch.serving.system import build_system
    spec = get_preset(preset)
    ix = cfg["index"]
    spec = replace(spec, index=replace(spec.index, **ix))
    if not stage2:
        spec = replace(spec, stage2=replace(spec.stage2, enabled=False))
    pc = program_corpus(cfg, corpus)
    index = build_index(pc, block_size=ix["block_size"], stop_k=ix["stop_k"])
    layouts = shard_layouts(index, spec.deploy.n_shards, ix["tile_d"])
    system = build_system(spec, index, corpus=pc, device=device,
                          layouts=layouts)
    terms, mask, topic = fit_log(cfg, corpus)
    system.fit(QueryLog(terms, mask, topic,
                        (mask > 0).sum(1).astype(np.int32)),
               None, seed=cfg["fit"]["seed"])
    return system, index, layouts


def forest_state(model) -> dict:
    """A fitted GBRT's arrays, copied to the host."""
    f = model.forest
    return {"feat": f.feat.cpu(), "thresh": f.thresh.cpu(),
            "leaf": f.leaf.cpu(),
            "base": model.base.float().reshape(()).cpu(),
            "bin_edges": model.bin_edges.cpu()}
