"""VirtualCluster core: the paper's multi-tenant control plane."""
from .agent import CallableProvider, MockProvider, NodeAgent, Provider, VnAgent
from .apiserver import APIClient, APIServer, TenantControlPlane
from .audit import AuditLog
from .autoscaler import Autoscaler, ScalingPolicy, SignalWindow
from .cluster import VirtualClusterFramework
from .executor import CooperativeExecutor, Task
from .fairqueue import FairWorkQueue
from .informer import Informer, InformerCache
from .metering import DETECTOR_AXES, UsageMeter, obj_nbytes
from .objects import (KINDS, ConfigMap, Event, Namespace, Node, Secret,
                      Service, VirtualClusterCR, VirtualNode, WorkUnit,
                      WorkUnitSpec)
from .ring import ShardRing, shard_for
from .router import IsolationViolation, MeshRouter
from .runtime import (Controller, ControllerManager, Histogram,
                      MetricsRegistry, RetryLater)
from .scheduler import SuperScheduler
from .slo import SLO, SLOTracker
from .store import (ADDED, BOOKMARK, DELETED, MODIFIED, AlreadyExistsError,
                    ConflictError, ContinueToken, NotFoundError, ObjectStore,
                    ResourceVersionExpired)
from .syncer import Syncer, ns_prefix
from .tenant_operator import TenantOperator
from .trace import TRACEPARENT_KEY, Span, Tracer
from .upward import EventRecorder, UpwardPipeline, UpwardShard
from .vnode import VNodeManager
from .workqueue import DelayingQueue, RateLimiter, WorkQueue

__all__ = [
    "APIClient", "APIServer", "TenantControlPlane", "VirtualClusterFramework",
    "Controller", "ControllerManager", "MetricsRegistry", "Histogram",
    "RetryLater", "CooperativeExecutor", "Task",
    "Tracer", "Span", "TRACEPARENT_KEY", "SLOTracker", "SLO",
    "AuditLog", "UsageMeter", "DETECTOR_AXES", "obj_nbytes",
    "Autoscaler", "ScalingPolicy", "SignalWindow",
    "FairWorkQueue", "WorkQueue", "DelayingQueue", "RateLimiter",
    "Informer", "InformerCache", "ObjectStore", "Syncer", "ns_prefix",
    "shard_for", "ShardRing",
    "EventRecorder", "UpwardPipeline", "UpwardShard",
    "SuperScheduler", "TenantOperator", "VNodeManager", "MeshRouter",
    "IsolationViolation", "NodeAgent", "VnAgent", "Provider", "MockProvider",
    "CallableProvider", "WorkUnit", "WorkUnitSpec", "Service", "Secret",
    "ConfigMap", "Namespace", "Node", "VirtualNode", "VirtualClusterCR",
    "Event", "KINDS", "ADDED", "MODIFIED", "DELETED", "BOOKMARK",
    "ConflictError", "AlreadyExistsError", "NotFoundError",
    "ContinueToken", "ResourceVersionExpired",
]
