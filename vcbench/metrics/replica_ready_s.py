"""replica_ready_s (layer: fleet and control plane, ``serving/host.py``,
``core/``): seconds from the resize that creates the fleet's WorkUnit to
its replica being live (placed, started by its node agent, the engine
built, its decode step captured and its warmed admission shapes
captured)."""


def read(run):
    return run.replica_ready_s
