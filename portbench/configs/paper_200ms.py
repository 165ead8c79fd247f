"""``paper_200ms``: the paper's three-stage cascade on one ISN shard, served
by the port's ``SearchSystem.serve``.

Set-up builds the port's index and its host layout from the benchmark's
collection, the system on the card, and fits it (``SearchSystem.fit`` on
the configuration's fit log, pseudo-labels).  A batch is one ``serve``
call; its results are on the host when it returns.  Spans: ``stage0``
around ``SearchSystem.stage0``, ``stage1`` around ``_stage1_full``,
``stage2`` around ``stage2``.  Every batch served since set-up is logged
(the reference replays them all in order, since routing adapts after
each); for the sampled queries the Stage-0 predictions and route
(``sched.route``), the Stage-1 lists and scores, the Stage-2 budgets, the
final lists and the modeled latency are kept.
"""

from __future__ import annotations

import numpy as np
import torch

from portbench import work
from portbench.harness.port import fitted_system, forest_state
from portbench.harness.spans import wrap
from portbench.reference import cascade, stage1

MODELS = cascade.MODELS


class Cascade:
    """The served system and what its batches produced."""

    def __init__(self, cfg, corpus, device):
        self.cfg = cfg
        self.device = torch.device(device)
        self.system, _, _ = fitted_system(cfg, corpus, device, "paper_200ms")
        # the fit's calibration, before serving adapts t_time
        r = self.system.cascade_spec.routing
        self.calibrated = {"t_k": r.t_k, "t_time": r.t_time}
        self.k_serve = self.system.k_serve
        self.cur: dict = {}
        self.log: list = []
        self.kept: list = []
        self.traced: list = []
        s = self.system
        wrap(s, "stage0", "stage0")
        wrap(s.sched, "route", None, self._on_route)
        wrap(s, "_stage1_full", "stage1", self._on_stage1)
        wrap(s, "stage2", "stage2", self._on_stage2)

    def _on_route(self, args, kwargs, routed):
        pk, pr, pt = args
        self.cur.update(pk=pk, pr=pr, pt=pt, routed=routed)

    def _on_stage1(self, args, kwargs, out):
        self.cur.update(topk=out[0], topk_sc=out[1])

    def _on_stage2(self, args, kwargs, out):
        self.cur.update(k2=np.asarray(args[4]))

    def serve(self, terms, mask, topic):
        self.cur = {}
        self.log.append((terms, mask))
        res = self.system.serve(terms, mask, topic)
        if self.device.type == "cuda":
            torch.cuda.synchronize()
        return res

    def keep(self, rows, terms, mask, topic, res, traced: bool):
        """Keep the sampled ``rows`` of the last batch; the whole batch's
        routes where the window is traced."""
        c = self.cur
        r = c["routed"]
        q = len(terms)
        jass = np.zeros(q, bool)
        jass[r.jass_rows] = True
        hedged = np.zeros(q, bool)
        hedged[r.hedged_rows] = True
        if traced:
            self.traced.append(dict(terms=terms, mask=mask, jass=jass,
                                    rho=r.rho))
        if not len(rows):
            return
        k2 = c.get("k2", np.zeros(q, np.int64))
        batch = len(self.log) - 1
        for i in rows:
            self.kept.append(dict(
                batch=batch, row=int(i), terms=terms[i], mask=mask[i],
                topic=topic[i], pk=c["pk"][i], pr=c["pr"][i], pt=c["pt"][i],
                jass=jass[i], hedged=hedged[i], k=r.k[i], rho=r.rho[i],
                topk=c["topk"][i], topk_sc=c["topk_sc"][i], k2=k2[i],
                final=res.final[i], used=res.candidates_used[i],
                lat=res.latency[i]))

    def state(self) -> dict:
        """The batches served, and what the program derived, copied to the
        host to be judged: its fitted forests and calibrated thresholds,
        and the routing thresholds as serving has adapted them."""
        s = self.system
        c = s.sched.cfg
        return {"log": self.log, "k_serve": self.k_serve,
                "fit": {"models": {n: forest_state(s.models[n])
                                   for n in MODELS},
                        "ltr": forest_state(s.ltr.model),
                        **self.calibrated},
                "adapted": {"t_time": c.t_time, "hedge_band": c.hedge_band,
                            "hedge_deadline": c.hedge_deadline}}

    def close(self):
        self.system = None


def build(cfg, corpus, device, traffic):
    return Cascade(cfg, corpus, device)


def _stack(kept, keys):
    return {k: np.stack([np.asarray(d[k]) for d in kept]) for k in keys}


def outputs(cfg, state, kept, ref, ref_dev, corpus, memo,
            dtype=torch.float32) -> dict:
    """What the plain reference (float32) or the control (bfloat16) gives:
    its own fit, every batch since set-up replayed in order through the
    modeled loop, and for the sampled queries Stage-0's predictions and
    route, Stage-1's lists, Stage-2's budgets and final lists and the
    modeled latency, each at the reference's own routes and budgets."""
    fit = cascade.fitted(cfg, ref, corpus, dtype)
    if "replay" not in memo:
        memo["replay"] = cascade.Replay(cfg, fit, ref, ref_dev, dtype)
    rp = memo["replay"]
    rp.run(state["log"], {(d["batch"], d["row"]) for d in kept})
    rows = [rp.out[(d["batch"], d["row"])] for d in kept]
    s = {**_stack(rows, rows[0]), **_stack(kept, ("terms", "mask", "topic"))}
    ids, sc, final, used, lat = cascade.serve_sampled(cfg, fit, s, ref,
                                                      ref_dev, corpus, dtype)
    return dict(pk=s["pk"], pr=s["pr"], pt=s["pt"], jass=s["jass"],
                hedged=s["hedged"], k=s["k"], rho=s["rho"], ids=ids,
                scores=sc, k2=s["k2"], final=final, used=used, lat=lat,
                fit=fit, adapted=rp.adapted())


def program_outputs(kept, state) -> dict:
    s = _stack(kept, ("pk", "pr", "pt", "jass", "hedged", "k", "rho",
                      "topk", "topk_sc", "k2", "final", "used", "lat"))
    return dict(pk=s["pk"], pr=s["pr"], pt=s["pt"], jass=s["jass"],
                hedged=s["hedged"], k=s["k"], rho=s["rho"], ids=s["topk"],
                scores=s["topk_sc"], k2=s["k2"], final=s["final"],
                used=s["used"], lat=s["lat"], fit=state["fit"],
                adapted=state["adapted"])


def numbers(got: dict, want: dict) -> dict:
    """The numbers compared: ``stage0_gap`` the widest gap of a prediction
    (relative to max(1, |reference|)); ``routes`` the queries whose route,
    hedge, k or ρ differ; ``stage1_ids`` the Stage-1 list slots whose id
    differs; ``stage1_scores`` the widest score gap; ``budgets`` the
    queries whose Stage-2 budget differs; ``stage2_ids`` the final-list
    slots and candidate counts that differ; ``latency`` the widest gap of
    a modeled latency; ``adapted`` the widest gap of the routing
    thresholds after the last batch; ``forests`` and ``thresholds`` the
    fit's (``cascade.fitted_numbers``)."""
    gap = cascade.gap
    return {
        "stage0_gap": max(gap(got[n], want[n]) for n in ("pk", "pr", "pt")),
        "routes": int(((got["jass"] != want["jass"])
                       | (got["hedged"] != want["hedged"])
                       | (got["k"] != want["k"])
                       | (got["rho"] != want["rho"])).sum()),
        "stage1_ids": int((got["ids"] != want["ids"]).sum()),
        "stage1_scores": gap(got["scores"], want["scores"]),
        "budgets": int((got["k2"] != want["k2"]).sum()),
        "stage2_ids": int((got["final"] != want["final"]).sum()
                          + (got["used"] != want["used"]).sum()),
        "latency": gap(got["lat"], want["lat"]),
        "adapted": max(gap(got["adapted"][k], want["adapted"][k])
                       for k in want["adapted"]),
        **cascade.fitted_numbers(got["fit"], want["fit"]),
    }


def traced_work(cfg, state, traced, ref, ref_dev) -> dict:
    """The bytes kernels 1, 2 and 3 need for the traced batches (see
    ``portbench.work``), at the routes and budgets the program served."""
    k = state["k_serve"]
    s1 = s2 = 0.0
    for b in traced:
        terms, mask = b["terms"], b["mask"]
        live = mask > 0
        dfs = ref["df"][terms] * live
        s2 += work.stage2_bytes(dfs, k)
        j = np.flatnonzero(b["jass"])
        if len(j):
            s1 += work.jass_bytes(stage1.jass_work(
                ref, terms[j], mask[j], b["rho"][j]), k)
        m = np.flatnonzero(~b["jass"])
        for lo in range(0, len(m), 64):
            rows = m[lo:lo + 64]
            kept, _ = stage1.bmw_work(ref_dev, torch.from_numpy(terms[rows]),
                                      torch.from_numpy(mask[rows]), k)
            blocks = (ref["term_blocks"][terms[rows]] * live[rows]).sum(1)
            s1 += work.bmw_bytes(blocks, kept.cpu().numpy(), k)
    return {"stage1_bytes": s1, "stage2_bytes": s2}
