"""admit_call_ms (layer: engine, ``serving/engine.py``): the mean wall time
of the engine's ``admit_many`` calls that ended in the window, in ms
(host-clock spans around the public call; it ends in a host sync)."""


def read(run):
    if not run.admits:
        return None
    return sum(a.t1 - a.t0 for a in run.admits) / len(run.admits) / 1e6
