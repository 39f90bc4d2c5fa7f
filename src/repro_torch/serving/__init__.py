"""Serving data plane of the port: the fused-admission engine, the
continuous batcher, the per-tenant WRR slot scheduler and the
control-plane bridge that hosts engine replicas as WorkUnits."""
from .engine import ContinuousBatcher, GenerationEngine, Request, generate
from .host import EngineProvider, EngineReplica, ServingFleet, SERVING_NS
from .scheduler import SlotScheduler

__all__ = ["GenerationEngine", "ContinuousBatcher", "Request", "generate",
           "SlotScheduler", "ServingFleet", "EngineProvider",
           "EngineReplica", "SERVING_NS"]
