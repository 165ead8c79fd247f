"""Online traffic subsystem: event-driven arrivals, dynamic micro-batching,
and admission control — the layer that turns the cascade's *service-time*
guarantees into **response-time** guarantees under load.

    from repro_torch.serving.online import simulate, estimate_capacity
    from repro_torch.serving.spec import TrafficSpec

    res = system.serve_online(ql.terms, ql.mask, ql.topic,
                              traffic=TrafficSpec(arrival="poisson",
                                                  qps=120.0))
    res.stats["response"]["p99.99"], res.stats["over_budget"]

See ``traffic`` (arrival processes), ``batcher`` (micro-batch policy),
``admission`` (degrade/shed ladder), and ``simulator`` (the event loop).
The port of ``repro.serving.online``: the loop runs on the host, and each
batch it dispatches is a ``SearchSystem.serve`` on the system's device.
"""

from repro_torch.serving.online.admission import (FULL, MODE_NAMES, PARTIAL,
                                                  SHED, STAGE1, TRIM,
                                                  AdmissionController)
from repro_torch.serving.online.batcher import (MicroBatcher, bucket_size,
                                                pad_batch)
from repro_torch.serving.online.simulator import (OnlineResult,
                                                  estimate_capacity,
                                                  fresh_probe, simulate)
from repro_torch.serving.online.traffic import (arrival_times, load_trace,
                                                zipf_query_mix)

__all__ = [
    "AdmissionController", "FULL", "MODE_NAMES", "MicroBatcher",
    "OnlineResult", "PARTIAL", "SHED", "STAGE1", "TRIM", "arrival_times",
    "bucket_size", "estimate_capacity", "fresh_probe", "load_trace",
    "pad_batch", "simulate", "zipf_query_mix",
]
