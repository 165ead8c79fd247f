"""``device_ops_per_q``: device operations (kernels, copies, fills) in the
traced window, a query."""


def read(ctx):
    if not ctx["ops"] or not ctx["queries"]:
        return None
    return len(ctx["ops"]) / ctx["queries"]
