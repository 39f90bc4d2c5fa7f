"""Logical-axis sharding API (twin of ``repro.sharding.api``).

Models annotate tensors with *logical* axis names ("batch", "seq", "embed",
"heads", "mlp", "vocab", "expert", ...). A ``ShardingRules`` mapping binds
logical names to mesh axis names; ``shard(x, *names)`` redistributes a
DTensor to the layout the names give when rules are active (inside
``use_rules``) and is the identity otherwise, or for a plain tensor, so the
same model code runs unsharded on one device and sharded on a mesh.

A spec maps tensor dims to mesh axes (the reference's ``PartitionSpec``);
DTensor placements map mesh dims to tensor dims. ``ShardingRules.spec``
returns the former as a tuple, ``ShardingRules.placements`` the latter:
one entry per mesh dim, ``Shard(tensor_dim)`` or ``Replicate()``. A tensor
dim bound to several mesh axes (``("pod", "data")``) becomes one
``Shard`` per axis, which must come in the mesh's order (major first).

``record_collectives`` lists, as sets of global ranks, the group of every
collective the calling process issues inside it (DTensor's redistributions
and the explicit bodies' functional collectives alike);
``validate_groups`` holds such a list to a tenant's slice of ranks by the
control plane's own rule (``core.router.MeshRouter.validate_isolation``).
"""
from __future__ import annotations

import contextlib
import contextvars
from typing import (Dict, FrozenSet, Iterator, List, Optional, Sequence,
                    Tuple, Union)

from torch.distributed.tensor import DTensor, Replicate, Shard
from torch.utils._python_dispatch import TorchDispatchMode

AxisBinding = Union[None, str, Tuple[str, ...]]
Spec = Tuple[AxisBinding, ...]

_current_rules: contextvars.ContextVar[Optional["ShardingRules"]] = \
    contextvars.ContextVar("sharding_rules", default=None)


class AbstractMesh:
    """A device-free mesh: axis names and sizes, nothing else (twin of
    ``repro.compat.abstract_mesh``). The planner and the specs need no
    process group."""

    def __init__(self, shape: Sequence[int], axis_names: Sequence[str]):
        if len(shape) != len(axis_names):
            raise ValueError(f"shape {tuple(shape)} and axes "
                             f"{tuple(axis_names)} must have equal length")
        self.axis_names: Tuple[str, ...] = tuple(axis_names)
        self.shape: Dict[str, int] = dict(zip(self.axis_names, shape))

    def __repr__(self) -> str:
        return f"AbstractMesh({self.shape})"


def abstract_mesh(shape: Sequence[int], axes: Sequence[str]) -> AbstractMesh:
    return AbstractMesh(tuple(shape), tuple(axes))


def axis_names(mesh) -> Tuple[str, ...]:
    """The axis names of an ``AbstractMesh`` or a ``DeviceMesh``."""
    if isinstance(mesh, AbstractMesh):
        return mesh.axis_names
    return tuple(mesh.mesh_dim_names)


def axis_sizes(mesh) -> Dict[str, int]:
    """{axis name: size}, in the mesh's order."""
    if isinstance(mesh, AbstractMesh):
        return dict(mesh.shape)
    return dict(zip(mesh.mesh_dim_names, mesh.shape))


class ShardingRules:
    """Binds logical axis names to mesh axis names for one (arch, mesh)."""

    def __init__(self, mesh, bindings: Dict[str, AxisBinding]):
        self.mesh = mesh
        self.bindings = dict(bindings)

    def spec(self, names: Sequence[Optional[str]]) -> Spec:
        """Logical names -> mesh axes per tensor dim: an axis may appear at
        most once (a later use is dropped), trailing ``None``s are trimmed."""
        parts: List[AxisBinding] = []
        used: set = set()
        for n in names:
            b = self.bindings.get(n) if n is not None else None
            if b is None:
                parts.append(None)
                continue
            axes = (b,) if isinstance(b, str) else tuple(b)
            axes = tuple(a for a in axes if a not in used)
            used.update(axes)
            if not axes:
                parts.append(None)
            elif len(axes) == 1:
                parts.append(axes[0])
            else:
                parts.append(axes)
        while parts and parts[-1] is None:
            parts.pop()
        return tuple(parts)

    def bound(self, name: str) -> AxisBinding:
        """The mesh axes one logical name is bound to (``spec``'s entry:
        an axis name, a tuple of them, or None)."""
        spec = self.spec((name,))
        return spec[0] if spec else None

    def axis(self, name: str) -> Optional[str]:
        """The one mesh axis ``name`` is bound to, else None."""
        b = self.bindings.get(name)
        return b if isinstance(b, str) else None

    def placements(self, names: Sequence[Optional[str]]
                   ) -> Tuple[Union[Shard, Replicate], ...]:
        """DTensor placements of ``spec(names)`` on this mesh."""
        order = axis_names(self.mesh)
        out: List[Union[Shard, Replicate]] = [Replicate()] * len(order)
        for dim, part in enumerate(self.spec(names)):
            if part is None:
                continue
            group = (part,) if isinstance(part, str) else part
            missing = [a for a in group if a not in order]
            if missing:
                raise ValueError(f"mesh axes {missing} are not in the mesh "
                                 f"{order}")
            idx = [order.index(a) for a in group]
            if idx != sorted(idx):
                raise ValueError(f"dim {dim} is bound to {group}, against the "
                                 f"mesh's order {order}")
            for i in idx:
                out[i] = Shard(dim)
        return tuple(out)


@contextlib.contextmanager
def use_rules(rules: Optional[ShardingRules]) -> Iterator[Optional[ShardingRules]]:
    token = _current_rules.set(rules)
    try:
        yield rules
    finally:
        _current_rules.reset(token)


def active_rules() -> Optional[ShardingRules]:
    return _current_rules.get()


def shard(x, *names: Optional[str]):
    """Redistribute ``x`` to the layout of its logical names (no-op without
    rules, or for a tensor that is not a DTensor)."""
    rules = _current_rules.get()
    if rules is None or not isinstance(x, DTensor):
        return x
    return x.redistribute(x.device_mesh, rules.placements(names))


def checkpoint(fn, *args, **kwargs):
    """``torch.utils.checkpoint`` (non-reentrant) whose recompute runs
    under the rules active now: the autograd engine may recompute on a
    device thread of its own, where the context variable is unset."""
    from torch.utils.checkpoint import checkpoint as torch_checkpoint
    rules = _current_rules.get()
    if rules is None:
        return torch_checkpoint(fn, *args, use_reentrant=False, **kwargs)
    return torch_checkpoint(
        fn, *args, use_reentrant=False,
        context_fn=lambda: (contextlib.nullcontext(), use_rules(rules)),
        **kwargs)


# --------------------------------------------------------- collective groups

_COLLECTIVE_NAMESPACES = ("_c10d_functional", "_c10d_functional_autograd",
                          "c10d")


def _group_ranks(args) -> Optional[FrozenSet[int]]:
    """Global ranks of the process group named or passed among ``args``."""
    import torch.distributed as dist
    from torch.distributed.distributed_c10d import _resolve_process_group
    for a in args:
        if isinstance(a, str):
            try:
                return frozenset(dist.get_process_group_ranks(
                    _resolve_process_group(a)))
            except (ValueError, RuntimeError):
                continue
        if isinstance(a, dist.ProcessGroup):
            return frozenset(dist.get_process_group_ranks(a))
    return None


class _Recorder(TorchDispatchMode):
    def __init__(self, groups: List[FrozenSet[int]]):
        super().__init__()
        self.groups = groups

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if func.namespace in _COLLECTIVE_NAMESPACES and \
                "wait" not in func.__name__:
            ranks = _group_ranks(list(args) + list(kwargs.values()))
            if ranks is not None:
                self.groups.append(ranks)
        return func(*args, **kwargs)


@contextlib.contextmanager
def record_collectives() -> Iterator[List[FrozenSet[int]]]:
    """Yields the list that every collective issued inside the block adds
    its group to, as a frozenset of global ranks."""
    groups: List[FrozenSet[int]] = []
    with _Recorder(groups):
        yield groups


def validate_groups(groups: Sequence[FrozenSet[int]],
                    slice_ranks: Sequence[int]) -> int:
    """Raise ``IsolationViolation`` if a group leaves ``slice_ranks``;
    return the number of groups. The groups are handed to the router's
    ``validate_isolation`` as the replica groups of collectives, so a
    torch program is held to the same rule as a compiled XLA program (the
    router itself stays the reference's copy).

    This ties the check to the text the router parses: each group is
    written as one HLO ``all-reduce replica_groups={{...}}`` line, the form
    ``MeshRouter._COLLECTIVE_RE`` reads. Should that parser stop reading
    a line, the count it returns falls short and this raises
    ``RuntimeError`` instead of passing groups unchecked
    (``tests/test_torch_sharding.py`` holds both outcomes of the rule)."""
    from ..core.router import MeshRouter
    groups = [g for g in groups if g]
    text = "\n".join("all-reduce replica_groups={{%s}}"
                     % ",".join(str(r) for r in sorted(g)) for g in groups)
    n = MeshRouter.validate_isolation(text, slice_ranks)
    if n != len(groups):
        raise RuntimeError(f"the router read {n} of {len(groups)} collective "
                           "groups: its HLO parser no longer reads the text "
                           "validate_groups writes")
    return n
