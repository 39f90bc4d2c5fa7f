"""queue_wait_p95_ms (layer: scheduler, ``serving/scheduler.py``): the
95th percentile, over the foreground tenants' requests due in the window,
of the time each waited in the fleet's WRR queue, from ``submit`` to the
scheduler handing it to the engine (``dequeued_at - submitted_at``), in
ms."""


def read(run):
    waits = [(r.dequeued_at - r.submitted_at) * 1e3
             for _, r in run.foreground if r is not None and r.dequeued_at]
    if not waits:
        return None
    return run.stats.pct(waits, 95)
