"""The one traffic generator: reads a mix's parameters
(``traffic/<mix>.json``) and draws its queries from ``--seed``.

Every mix is a closed loop of batches, one in flight: ``batch`` fresh
queries a call from a pool of ``pool`` MQ2009-like queries (the
benchmark's copy of ``build_queries``: ``min_terms``..``max_terms`` terms,
the background Zipf raised to ``zipf_power``, a topical share), served in
pool order and again from its start if the window outlasts it.  Warm-up
batches come from a pool of their own.  ``sample`` positions of the pool
(and its heaviest query among the first eight batches) are the answers
the check compares.
"""

from __future__ import annotations

import numpy as np

from portbench.data.corpus import build_queries

POOL_STREAM, WARM_STREAM, SAMPLE_STREAM = 1, 2, 3


def sub_seed(seed: int, stream: int) -> int:
    """A 32-bit seed for one stream of ``seed`` (any whole number)."""
    ss = np.random.SeedSequence([abs(int(seed)) % 2 ** 64, int(seed < 0),
                                 stream])
    return int(ss.generate_state(1)[0])


def _queries(corpus, mix, cfg, n, seed):
    return build_queries(corpus, n, seed=seed,
                         max_len=mix.get("max_len", 8),
                         min_terms=mix["min_terms"],
                         max_terms=mix["max_terms"],
                         stop_k=cfg["index"]["stop_k"],
                         zipf_power=mix["zipf_power"],
                         topical_share=mix["topical_share"])


def pool(corpus: dict, mix: dict, cfg: dict, seed: int):
    """(terms, mask, topic) of the window's pool."""
    return _queries(corpus, mix, cfg, mix["pool"], sub_seed(seed,
                                                            POOL_STREAM))


def warm(corpus: dict, mix: dict, cfg: dict, seed: int):
    n = mix["batch"] * mix["warmup_batches"]
    return _queries(corpus, mix, cfg, n, sub_seed(seed, WARM_STREAM))


def sample(corpus: dict, mix: dict, seed: int, terms, mask) -> np.ndarray:
    """(pool,) bool: the positions whose answers are compared, drawn from
    the seed, and the query with the most postings among the first eight
    batches."""
    n = len(terms)
    rng = np.random.default_rng(sub_seed(seed, SAMPLE_STREAM))
    out = np.zeros(n, bool)
    out[rng.choice(n, size=min(mix["sample"], n), replace=False)] = True
    df = np.bincount(corpus["postings_term"],
                     minlength=len(corpus["zipf_probs"]))
    head = min(n, 8 * mix["batch"])
    out[int(np.argmax((df[terms[:head]] * (mask[:head] > 0)).sum(1)))] = True
    return out


def fit_log(cfg: dict, corpus: dict):
    """The configuration's fit log (terms, mask, topic): ``fit.queries``
    queries of the default trace from the fixed ``fit.seed``."""
    return build_queries(corpus, cfg["fit"]["queries"],
                         seed=cfg["fit"]["seed"],
                         stop_k=cfg["index"]["stop_k"])
