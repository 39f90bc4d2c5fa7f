"""Sharding of the port (twin of ``repro.sharding``): logical axis rules,
the planner and the collectives of the explicit bodies.

``repro_torch.sharding.planner`` is imported directly (not re-exported
here), as in the reference: models -> sharding.api, planner -> models."""
from .api import (AbstractMesh, ShardingRules, abstract_mesh, active_rules,
                  record_collectives, shard, use_rules, validate_groups)

__all__ = ["ShardingRules", "shard", "use_rules", "active_rules",
           "abstract_mesh", "AbstractMesh", "record_collectives",
           "validate_groups"]
