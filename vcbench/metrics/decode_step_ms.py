"""decode_step_ms (layer: engine, ``serving/engine.py``): the wall time of
the engine's ``step`` calls that ended in the window over their number,
in ms (a graph replay and its one host sync each)."""


def read(run):
    if not run.steps:
        return None
    return sum(s.t1 - s.t0 for s in run.steps) / len(run.steps) / 1e6
