"""``paper_isn``: one rank's step of the paper's hybrid ISN, the port's
``isn.shard.hybrid_serve_fn`` on a (1, 1) mesh (NCCL at world size 1).

Set-up builds the ``paper_200ms`` system, Stage-2 off, from the
benchmark's collection and fits its Stage-0 forests as that configuration
does (they are the step's), copies the shard's layout and term statistics to the card and
builds the step with ``paper_isn.CONFIG``'s per-chip sizes (k 1,024 and
ρ_max 131,072; the thresholds of ``serve_cell_sizes``).  A batch is one
step: the queries copied to the card, Stage-0, both engines on every
query, the gather and merge, and the ids, scores, work and routes copied
back.  Spans: ``stage0`` around the module's ``_stage0``, ``stage1``
around its ``saat_serve``, ``daat_serve`` and ``merge_shard_topk``.
"""

from __future__ import annotations

import numpy as np
import torch

from portbench import work
from portbench.harness.port import fitted_system, forest_state
from portbench.harness.spans import wrap
from portbench.reference import cascade, stage0, stage1


class Step:
    def __init__(self, cfg, corpus, device):
        import torch.distributed as dist
        from repro_torch.index.postings import shard_to_device
        from repro_torch.isn import shard as isn
        from repro_torch.launch.mesh import make_local_mesh
        self.cfg = cfg
        self.device = torch.device(device)
        system, index, layouts = fitted_system(cfg, corpus, device,
                                               cfg["fit"]["preset"],
                                               stage2=cfg["fit"]["stage2"])
        st = cfg["step"]
        models = system.models
        self.forests = {n: forest_state(models[n]) for n in ("k", "rho", "t")}
        fa = isn.stage0_forest(models)
        depth = models["k"].params.depth
        del system
        spec = layouts[0].spec
        self.shard, _ = shard_to_device(layouts[0], self.device)
        self.term_stats = torch.from_numpy(index.term_stats).to(self.device)
        self.fa = fa
        self.mesh = make_local_mesh(device=self.device)
        self._dist = dist
        n_blocks = spec.n_blocks
        self.sizes = dict(
            n_docs_shard=spec.n_docs, n_model=1, k_shard=st["k_shard"],
            k_global=st["k_global"], rho_max=st["rho_max"],
            daat_cap=min(spec.n_docs, 1 << 19),
            daat_bcap=min(n_blocks, 1 << 14), n_blocks=n_blocks,
            block_size=spec.block_size, t_k=st["t_k"], t_time=st["t_time"],
            tile_d=spec.tile_d)
        if (self.sizes["daat_cap"] < spec.max_df
                or self.sizes["daat_bcap"] < spec.max_blocks_per_term):
            raise ValueError(f"the step's caps {self.sizes} do not cover "
                             f"the shard {spec}")
        self.step = isn.hybrid_serve_fn(self.mesh, forest_depth=depth,
                                        **self.sizes)
        self.kept: list = []
        self.traced: list = []
        self._undo = [wrap(isn, "_stage0", "stage0"),
                      wrap(isn, "saat_serve", "stage1"),
                      wrap(isn, "daat_serve", "stage1"),
                      wrap(isn, "merge_shard_topk", "stage1")]

    def serve(self, terms, mask, topic):
        t = torch.from_numpy(terms).to(self.device)
        m = torch.from_numpy(mask).to(self.device)
        ids, sc, wk, route = self.step(self.shard, self.fa, self.term_stats,
                                       t, m)
        return (ids.cpu().numpy(), sc.cpu().numpy(), wk.cpu().numpy(),
                route.cpu().numpy())

    def keep(self, rows, terms, mask, topic, res, traced: bool):
        ids, sc, wk, route = res
        if traced:
            self.traced.append(dict(terms=terms, mask=mask, route=route))
        for i in rows:
            self.kept.append(dict(terms=terms[i], mask=mask[i], ids=ids[i],
                                  scores=sc[i], work=wk[i], jass=route[i]))

    def state(self) -> dict:
        return {"fit": {"models": self.forests}, **self.sizes}

    def close(self):
        for undo in self._undo:
            undo()
        self.shard = self.fa = self.term_stats = self.step = None
        if self._dist.is_initialized():
            self._dist.destroy_process_group()


def build(cfg, corpus, device, traffic):
    return Step(cfg, corpus, device)


def _stack(kept):
    return {k: np.stack([np.asarray(d[k]) for d in kept]) for k in kept[0]}


def outputs(cfg, state, kept, ref, ref_dev, corpus, memo,
            dtype=torch.float32) -> dict:
    """The reference's (float32) or the control's (bfloat16) step for the
    sampled queries, on its own fit's Stage-0 forests: Stage-0 and its
    route (JASS where k̂ > t_k or t̂ > t_time, ρ̂ clamped to [1,024,
    ρ_max] and truncated), then that engine's top k, scores and work."""
    fit = cascade.fitted(cfg, ref, corpus, dtype, ltr=False)
    st = cfg["step"]
    s = _stack(kept)
    x = stage0.features(ref["term_stats"], ref["df"], s["terms"], s["mask"],
                        dtype)
    p = [stage0.expm1_step(stage0.forest_predict(fit["models"][n], x,
                                                 dtype))
         for n in cascade.MODELS]
    t_k = float(np.float32(st["t_k"]))
    t_time = float(np.float32(st["t_time"]))
    jass = ((p[0] > t_k) | (p[2] > t_time)).numpy()
    rho = torch.clamp(p[1], st["rho_min"], st["rho_max"]).to(torch.int32)
    ids, sc, wk = stage1.serve(ref_dev, s["terms"], s["mask"], jass,
                               rho.numpy(), st["k_shard"], dtype)
    return dict(jass=jass, ids=ids, scores=sc, work=wk,
                fit={"models": fit["models"]})


def program_outputs(kept, state) -> dict:
    s = _stack(kept)
    return dict(jass=s["jass"], ids=s["ids"], scores=s["scores"],
                work=s["work"], fit=state["fit"])


def numbers(got: dict, want: dict) -> dict:
    """``answers``: list slots whose global id differs, with the queries
    whose route or postings count differs (one number, since the control
    moves a route or a count on few seeds); ``stage1_scores``: the widest
    score gap; ``forests``: entries of the Stage-0 forests that differ."""
    return {
        "answers": int((got["ids"] != want["ids"]).sum()
                       + (got["jass"] != want["jass"]).sum()
                       + (got["work"] != want["work"]).sum()),
        "stage1_scores": cascade.gap(got["scores"], want["scores"]),
        **cascade.fitted_numbers(got["fit"], want["fit"]),
    }


def traced_work(cfg, state, traced, ref, ref_dev) -> dict:
    """Kernels 1 and 2 run on every query of a step: JASS at the query's
    own cut (the ρ of the program's Stage-0 forest) and BMW (see
    ``portbench.work``)."""
    k = state["k_shard"]
    forest = state["fit"]["models"]["rho"]
    s1 = 0.0
    for b in traced:
        for lo in range(0, len(b["terms"]), 64):
            terms = b["terms"][lo:lo + 64]
            mask = b["mask"][lo:lo + 64]
            x = stage0.features(ref["term_stats"], ref["df"], terms, mask)
            rho = torch.clamp(stage0.expm1_step(stage0.forest_predict(
                forest, x)), cfg["step"]["rho_min"], state["rho_max"])
            kept, _ = stage1.bmw_work(ref_dev, torch.from_numpy(terms),
                                      torch.from_numpy(mask), k)
            blocks = (ref["term_blocks"][terms] * (mask > 0)).sum(1)
            s1 += work.jass_bytes(stage1.jass_work(
                ref, terms, mask, rho.to(torch.int32).numpy()), k)
            s1 += work.bmw_bytes(blocks, kept.cpu().numpy(), k)
    return {"stage1_bytes": s1}
