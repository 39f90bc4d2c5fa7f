"""Serving data plane of the port: the fused-admission engine, the
continuous batcher and the per-tenant WRR slot scheduler."""
from .engine import ContinuousBatcher, GenerationEngine, Request, generate
from .scheduler import SlotScheduler

__all__ = ["GenerationEngine", "ContinuousBatcher", "Request", "generate",
           "SlotScheduler"]
