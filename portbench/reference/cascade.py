"""The cascade of the plain reference: its fit from the benchmark's own
fit log, and its serving loop replayed batch by batch.

``fitted`` works out what the system derives at set-up: the pseudo-labels
of the fit log (each query's summed document frequency, scaled and given
log-normal noise from ``RandomState(fit seed)``), the three Stage-0
forests, the LTR forest (on the features of 64 random documents for each
of the first 32 fit queries, the topic weight plus a fifth of the BM25 sum
as the gain) and the calibrated thresholds (t_k the 60th percentile of the
k forest's predictions on the fit log, t_time the 75th of the t forest's,
at most three quarters of the budget).

``Replay`` serves the same batches in the same order through the
configuration's modeled loop (``routing``, ``cost``, ``deploy``): Algorithm
2 with the hedge band, the engines' modeled times from the reference's own
work counts, the late hedges, the Stage-2 budgets the remaining time
affords, the pool's per-mirror moving averages, the t predictor's pinball
loss, and the thresholds adapted after every batch.  Nothing here reads
what the program derived.
"""

from __future__ import annotations

import numpy as np
import torch

from portbench.harness import store
from portbench.harness.traffic import fit_log
from portbench.reference import fit as F
from portbench.reference import stage0, stage1, stage2

MODELS = ("k", "rho", "t")


def gap(a, b) -> float:
    """The widest |a - b| / max(1, |b|) (inf where one is NaN)."""
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    if not a.size:
        return 0.0
    d = np.abs(a - b) / np.maximum(1.0, np.abs(b))
    return float(np.nan_to_num(d, nan=np.inf).max())


def _pseudo_targets(cfg, ref, terms, mask, rng):
    pl = cfg["pseudo_labels"]
    eff = ((ref["df"][terms] * (mask > 0)).sum(axis=1).astype(np.float64))
    return {n: eff * pl["scales"][n] * np.exp(rng.randn(len(eff))
                                              * pl["noise"])
            for n in MODELS}


def _fit_stage0(cfg, ref, corpus, dtype):
    s0 = cfg["stage0"]
    terms, mask, _ = fit_log(cfg, corpus)
    x = stage0.features(ref["term_stats"], ref["df"], terms, mask, dtype)
    rng = np.random.RandomState(cfg["fit"]["seed"])
    targets = _pseudo_targets(cfg, ref, terms, mask, rng)
    models = {n: F.fit(x.numpy(), np.log1p(targets[n].astype(np.float32)),
                       n_trees=s0["n_trees"], depth=s0["depth"],
                       loss="quantile", tau=s0["tau"][n],
                       learning_rate=s0["learning_rate"],
                       n_bins=s0["n_bins"],
                       min_child_weight=s0["min_child_weight"],
                       l2=s0["l2"], dtype=dtype)
              for n in MODELS}
    pk, pt = (np.expm1(stage0.forest_predict(models[n], x, dtype).numpy())
              for n in ("k", "t"))
    budget = cfg["routing"]["budget"]
    cal = {"t_k": float(np.percentile(pk, 60)),
           "t_time": float(min(budget * 0.75, np.percentile(pt, 75)))}
    return models, cal, rng


def _fit_ltr(cfg, ref, corpus, rng, dtype):
    s2, pl = cfg["stage2"], cfg["pseudo_labels"]
    terms, mask, topic = fit_log(cfg, corpus)
    n_docs = int(ref["n_docs"])
    feats = []
    for q in range(min(len(terms), pl["ltr_queries"])):
        docs = rng.randint(0, n_docs, pl["ltr_docs"])
        feats.append(stage2.qd_features(ref, corpus["doc_topics"], terms[q],
                                        mask[q], topic[q],
                                        docs.astype(np.int64)))
    lf = np.concatenate(feats)
    lg = (lf[:, 5] + 0.2 * lf[:, 1]).astype(np.float32)
    return F.fit(lf, lg, n_trees=s2["ltr_trees"], depth=s2["ltr_depth"],
                 loss="l2", learning_rate=s2["ltr_learning_rate"],
                 n_bins=s2["ltr_n_bins"],
                 min_child_weight=s2["ltr_min_child_weight"],
                 l2=s2["ltr_l2"], dtype=dtype)


def _flatten(fitted: dict) -> dict:
    out = {f"{m}.{k}": v.numpy() for m, forest in fitted["models"].items()
           for k, v in forest.items()}
    if fitted.get("ltr") is not None:
        out.update({f"ltr.{k}": v.numpy() for k, v in fitted["ltr"].items()})
    out.update(t_k=np.float64(fitted["t_k"]),
               t_time=np.float64(fitted["t_time"]))
    return out


def _unflatten(arrays: dict) -> dict:
    out = {"models": {}, "ltr": None}
    for key, a in arrays.items():
        if "." not in key:
            out[key] = float(a)
            continue
        m, k = key.split(".")
        forest = out.setdefault("ltr_", {}) if m == "ltr" else \
            out["models"].setdefault(m, {})
        forest[k] = torch.from_numpy(np.asarray(a))
    if "ltr_" in out:
        out["ltr"] = out.pop("ltr_")
    return out


def fitted(cfg: dict, ref: dict, corpus: dict, dtype=torch.float32,
           ltr: bool = True) -> dict:
    """{"models": {k, rho, t: forest}, "ltr": forest or None, "t_k",
    "t_time"}: the reference's fit (``dtype`` bfloat16: the control's),
    kept in the benchmark's cache, since it depends only on the
    configuration."""
    key = {"corpus": cfg["corpus"], "index": cfg["index"], "fit": cfg["fit"],
           "stage0": cfg["stage0"], "pseudo": cfg["pseudo_labels"],
           "budget": cfg["routing"]["budget"], "dtype": str(dtype),
           "ltr": cfg["stage2"] if ltr else None}

    def build():
        models, cal, rng = _fit_stage0(cfg, ref, corpus, dtype)
        out = {"models": models, **cal}
        if ltr:
            out["ltr"] = _fit_ltr(cfg, ref, corpus, rng, dtype)
        return _flatten(out)
    return _unflatten(store.cached("reffit", key, build))


def fitted_numbers(state: dict, want: dict) -> dict:
    """``forests``: entries of the program's forests that differ from the
    reference's; ``thresholds``: the widest gap of the calibrated t_k and
    t_time (where the configuration calibrates)."""
    n = sum(F.forest_gap(state["models"][m], want["models"][m])
            for m in MODELS)
    if want.get("ltr") is not None:
        n += F.forest_gap(state["ltr"], want["ltr"])
    out = {"forests": n}
    if "t_k" in state:
        out["thresholds"] = max(gap(state[k], want[k])
                                for k in ("t_k", "t_time"))
    return out


class Cost:
    """The configuration's cost model (abstract time units)."""

    def __init__(self, c: dict):
        self.__dict__.update(c)

    def saat(self, work):
        return self.saat_fixed + work * self.saat_per_posting

    def daat(self, work, blocks):
        return (self.daat_fixed + work * self.daat_per_posting
                + blocks * self.daat_per_block)

    def ltr(self, n):
        return self.ltr_fixed + np.asarray(n, np.float64) * \
            self.ltr_per_candidate

    def afford(self, remaining, k_serve: int):
        """The most candidates whose Stage-2 time fits ``remaining``."""
        a = np.floor((np.asarray(remaining, np.float64) - self.ltr_fixed)
                     / max(self.ltr_per_candidate, 1e-12) + 1e-9)
        return np.clip(a, 0, k_serve).astype(np.int64)


class Replay:
    """The serving loop's routes, budgets and modeled latencies from the
    reference's own Stage-0 and engine work, one batch at a time, with the
    state the loop carries from batch to batch (the routing thresholds,
    one replica a mirror and its moving average, the scheduler's counts,
    the pinball loss).  ``run`` takes the batches served since the last
    call."""

    def __init__(self, cfg: dict, fit: dict, ref: dict, ref_dev, dtype):
        r, d = cfg["routing"], cfg["deploy"]
        if (d["replicas"] != 2 or d["n_shards"] != 1 or r["algorithm"] != 2
                or r["adapt_every"] != 1):
            raise ValueError("the replay models Algorithm 2 on one shard, "
                             "one replica a mirror, adapting every batch")
        self.ref, self.ref_dev, self.dtype, self.fit = ref, ref_dev, dtype, fit
        self.cost = Cost(cfg["cost"])
        self.ewma_alpha = d["ewma_alpha"]
        self.k_serve = cfg["stage2"]["k_serve"]
        self.tau_t = cfg["stage0"]["tau"]["t"]
        self.budget = r["budget"]
        # the scheduler's budget: the cascade's less Stage-0's cost and
        # Stage-2's worst case
        self.b1 = max(self.budget - self.cost.predict
                      - float(self.cost.ltr(np.asarray(self.k_serve))), 0.0)
        self.r = dict(r, t_k=fit["t_k"], t_time=fit["t_time"])
        self.n_bmw = self.n_late = 0
        self.last_bmw = self.last_late = 0
        self.ewma = {"jass": 1.0, "bmw": 1.0}
        self.served = {"jass": False, "bmw": False}
        self.pinball = None
        self.done = 0
        self.out: dict = {}

    # -- per query, independent of the loop's state --------------------
    def _stage0(self, terms, mask):
        x = stage0.features(self.ref["term_stats"], self.ref["df"], terms,
                            mask, self.dtype)
        return [np.expm1(stage0.forest_predict(self.fit["models"][n], x,
                                               self.dtype).numpy())
                for n in MODELS]

    def _bmw_work(self, terms, mask, block: int = 256):
        w = np.zeros(len(terms), np.int64)
        b = np.zeros(len(terms), np.int64)
        for lo in range(0, len(terms), block):
            sl = slice(lo, lo + block)
            ww, bb = stage1.bmw_work(self.ref_dev,
                                     torch.from_numpy(terms[sl]),
                                     torch.from_numpy(mask[sl]),
                                     self.k_serve, self.dtype)
            w[sl], b[sl] = ww.cpu().numpy(), bb.cpu().numpy()
        return w, b

    # -- the loop --------------------------------------------------------
    def _route(self, pk, pr, pt):
        r = self.r
        jass = (pk > r["t_k"]) | (pt > r["t_time"])
        k = np.clip(np.round(pk), 10, 16384).astype(np.int64)
        rho = np.clip(np.round(pr), r["rho_min"], r["rho_max"]).astype(
            np.int64)
        bmw = ~jass
        hedged = np.zeros_like(bmw)
        if r["enable_hedging"]:
            b = r["hedge_band"]
            hedged = ((pt > r["t_time"] * (1 - b))
                      & (pt <= r["t_time"] * (1 + b)) & bmw)
        self.n_bmw += int(bmw.sum())
        return jass, hedged, k, rho

    def _jass_t(self, lc, rows, rho):
        return self.cost.saat(stage1.cut_work(lc[rows], rho)
                              .astype(np.float64))

    def _late(self, lc, rows, rho, t):
        cap = np.minimum(rho[rows], self.r["late_rho"])
        return np.minimum(t, self.b1 * self.r["hedge_deadline"]
                          + self._jass_t(lc, rows, cap))

    def _batch(self, lc, pk, pr, pt, bw, bb):
        cost, r = self.cost, self.r
        q = len(pk)
        jass, hedged, k, rho = self._route(pk, pr, pt)
        jr, br = np.flatnonzero(jass), np.flatnonzero(~jass)
        t_sh = np.zeros(q)
        t_bmw = np.zeros(q)
        if len(jr):
            t_sh[jr] = cost.saat(stage1.cut_work(lc[jr], rho[jr])
                                 .astype(np.float64))
        if len(br):
            t_sh[br] = cost.daat(bw[br], bb[br])
            t_bmw[br] = t_sh[br] + 0.0
        lat = np.zeros(q)
        if len(jr):
            tj = self._jass_t(lc, jr, rho[jr])
            if r["enforce_budget"]:
                late = tj > self.b1
                if late.any():
                    tj = tj.copy()
                    tj[late] = self._late(lc, jr[late], rho, tj[late])
            lat[jr] = tj
        if len(br):
            tb = t_bmw[br].copy()
            hm = hedged[br]
            if hm.any():
                rows = br[hm]
                tb[hm] = np.minimum(tb[hm], self._jass_t(lc, rows, rho[rows])
                                    + cost.predict)
            late = tb > self.b1
            if late.any():
                tb[late] = self._late(lc, br[late], rho, tb[late])
                self.n_late += int(late.sum())
            lat[br] = tb
        lat = lat + cost.predict
        if len(br):
            e = t_bmw[br] - pt[br]
            tau = self.tau_t
            pin = float(np.mean(np.maximum(tau * e, (tau - 1.0) * e)))
            self.pinball = (pin if self.pinball is None
                            else 0.8 * self.pinball + 0.2 * pin)
        k2 = np.minimum(k, self.k_serve)
        k2 = np.minimum(k2, cost.afford(self.budget - lat, self.k_serve))
        a = self.ewma_alpha
        for i in range(q):
            m = "jass" if jass[i] else "bmw"
            self.ewma[m] = (1 - a) * self.ewma[m] + a * float(t_sh[i])
            self.served[m] = True
        hr = np.flatnonzero(hedged)
        if len(hr):
            th = self._jass_t(lc, hr, rho[hr])
            for j in range(len(hr)):
                self.ewma["jass"] = ((1 - a) * self.ewma["jass"]
                                     + a * float(th[j]))
                self.served["jass"] = True
        self._adapt()
        return dict(pk=pk, pr=pr, pt=pt, jass=jass, hedged=hedged, k=k,
                    rho=rho, k2=k2, lat01=lat)

    def _adapt(self):
        r, b1 = self.r, self.b1
        changed = {}
        e_j = self.ewma["jass"] if self.served["jass"] else None
        e_b = self.ewma["bmw"] if self.served["bmw"] else None
        if e_j is not None and e_b is not None and e_j + e_b > 0:
            alpha = 0.2
            target = b1 * float(np.clip(e_j / (e_j + e_b), 0.1, 0.9))
            changed["t_time"] = float(np.clip(
                (1 - alpha) * r["t_time"] + alpha * target,
                0.05 * b1, 0.95 * b1))
        d_late = self.n_late - self.last_late
        d_bmw = self.n_bmw - self.last_bmw
        self.last_late, self.last_bmw = self.n_late, self.n_bmw
        if d_bmw > 0:
            band = r["hedge_band"] * (1.25 if d_late > 0 else 0.98)
            changed["hedge_band"] = float(np.clip(band, 0.05, 0.5))
        if self.pinball is not None:
            late = float(self.cost.saat(np.float64(r["late_rho"])))
            d_max = (b1 - late - 0.0) / b1
            if d_max > 0.05:
                err = self.pinball / b1
                d_target = float(np.clip(
                    d_max * (1.0 - min(2.0 * err, 0.8)), 0.05, d_max))
                changed["hedge_deadline"] = float(np.clip(
                    0.8 * r["hedge_deadline"] + 0.2 * d_target,
                    0.05, min(d_max, 1.0)))
        self.r.update(changed)

    def run(self, log: list, wanted) -> None:
        """Serve ``log[self.done:]`` (each batch's (terms, mask)); keep the
        per-query results of the (batch, row) pairs in ``wanted`` (those
        of the last call stay where no batch is new)."""
        new = log[self.done:]
        if not new:
            return
        self.out = {}
        terms = np.concatenate([b[0] for b in new])
        mask = np.concatenate([b[1] for b in new])
        pk, pr, pt = self._stage0(terms, mask)
        bw, bb = self._bmw_work(terms, mask)
        lc = stage1.level_totals(self.ref, terms, mask)
        lo = 0
        for j, b in enumerate(new):
            sl = slice(lo, lo + len(b[0]))
            lo += len(b[0])
            res = self._batch(lc[sl], pk[sl], pr[sl], pt[sl], bw[sl],
                              bb[sl])
            bi = self.done + j
            for i in range(len(b[0])):
                if (bi, i) in wanted:
                    self.out[(bi, i)] = {k: v[i] for k, v in res.items()}
        self.done = len(log)

    def adapted(self) -> dict:
        return {k: self.r[k] for k in ("t_time", "hedge_band",
                                       "hedge_deadline")}


def serve_sampled(cfg, fit, rows: dict, ref, ref_dev, corpus, dtype):
    """Stage-1 and Stage-2 of the sampled queries at the replay's routes and
    budgets: the lists, scores, final lists and modeled latencies."""
    s = rows
    ids, sc, _ = stage1.serve(ref_dev, s["terms"], s["mask"], s["jass"],
                              s["rho"], cfg["stage2"]["k_serve"], dtype)
    final, used = stage2.rerank(ref, corpus["doc_topics"], fit["ltr"],
                                s["terms"], s["mask"], s["topic"], ids,
                                s["k2"], ids, cfg["stage2"]["t_final"],
                                dtype)
    cost = Cost(cfg["cost"])
    lat = s["lat01"] + np.where(used > 0, cost.ltr(used), 0.0)
    return ids, sc, final, used, lat
