"""Cost of one traced call of a step (counterpart of
``repro.roofline.hlo_cost``).

The reference walks the optimized HLO text of a compiled step; the port has
no HLO, so this is a ``TorchDispatchMode`` that sees every aten op of one
call of the step, run on fake tensors (``FakeTensorMode``: shapes and
dtypes, no data, nothing allocated) over a fake process group, and counts
per device (this rank's local tensors):

- **FLOPs.** Matrix products, batched products and convolutions through
  ``torch.utils.flop_counter``'s registry (2 M N K for a product), kept
  apart as ``matmul_flops`` too; every other op that is not a view, a
  factory or a metadata query counts one FLOP per output element, the
  reference's rule for its elementwise ops (``hlo_cost.py:423-424``).
  Gathers and scatters (``embedding``, ``index``, ``index_put_``,
  ``scatter_add_``, ...) count no FLOPs, as the reference's do.
- **Bytes.** Operands plus results of every op that is not a view, a
  factory or a metadata query: the port's own unfused traffic, what its
  eager and graphed runs launch op by op, not XLA's fusion boundaries (the
  reference's interior of a fusion is free; here every op is its own
  round trip). In-place ops count the updated tensor as read and written.
  Gathers and scatters count the rows they touch, as the reference's do:
  a gather twice its output, a scatter twice its update plus the smaller
  of its output and that (a cache write moves the new row, not the
  cache). A collective counts its output, as the reference's does.
- **Regions.** Each op's bytes go to the region of the first frame on its
  Python stack whose function (any part of its qualified name) is in
  ``REGION_FUNCTIONS``: the port's kernel calls and their plain routes;
  else to "other". The dry-run replaces the regions' bytes by the
  kernels' boundary traffic (``analysis.kernel_region_traffic``).
- **Collectives.** The ``_c10d_functional`` ops (not ``wait_tensor``),
  each with its output bytes and its group's global ranks
  (``sharding.api._group_ranks``), charged by ``analysis.collective_stats``
  (ring send bytes at the group's slowest link); counts and bytes by op
  kind under the reference's names.
- **Peak live bytes.** The bytes of every storage alive at once, the
  step's inputs included, at their highest: the counterpart of the
  reference's ``memory_analysis``.

What differs from the reference besides: no trip counts. The reference
multiplies a ``while`` body by its trip count; the port's layers run
eagerly, so every call is counted as it runs (the checkpointed blocks'
recompute included), with nothing to multiply. An op on DTensors is
counted as the local ops it runs: the mode defers it to DTensor, whose
local ops and redistributions then come back through the mode; the ops
DTensor's sharding propagation runs on global-shape stand-ins (in the
step's own fake mode, told apart by that code on the stack) are not the
step's and are left out.
"""
from __future__ import annotations

import sys
import weakref
from dataclasses import dataclass, field
from types import CodeType
from typing import Any, Dict, List, Optional, Tuple

import torch
from torch.distributed.tensor import DTensor
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves
from torch.utils.flop_counter import flop_registry

from ..sharding.api import _group_ranks
from .analysis import collective_stats

# the port's kernel calls and their plain routes; any part of a frame's
# qualified name ("MhaFunction.backward") may match
REGION_FUNCTIONS = {
    "attention": {"mha", "_mha_fwd", "_mha_torch", "_mha_bwd_torch",
                  "MhaFunction", "decode_mha", "_decode_partials",
                  "_decode_mha_seq_sharded", "flash_decode"},
    "rwkv": {"rwkv6_scan", "_rwkv6_torch", "_rwkv6_chunks",
             "rwkv6_decode_step", "Rwkv6ScanFunction"},
    "mamba": {"mamba_scan", "_mamba_torch", "_mamba_chunks",
              "mamba_decode_step", "MambaScanFunction"},
}

# DTensor's sharding propagation (a file of torch), whose ops are not the step's
_PROPAGATION = "_sharding_prop.py"
_SKIP = "skip"

# the reference's rule for gathers and scatters (``hlo_cost.py:372-395``): no
# FLOPs, and the bytes of the rows touched, not of the whole table or buffer:
# a gather 2 x its output, a scatter 2 x its update + min(output, 2 x update)
_GATHERS = {"embedding", "index", "index_select", "gather", "take",
            "take_along_dim"}
_SCATTERS = {"index_put", "index_put_", "_index_put_impl_", "index_add",
             "index_add_", "index_copy", "index_copy_", "scatter",
             "scatter_", "scatter_add", "scatter_add_", "scatter_reduce",
             "scatter_reduce_", "embedding_dense_backward"}
# _c10d_functional op -> the reference's op kind
_COLLECTIVE_KINDS = {
    "all_reduce": "all-reduce", "all_reduce_": "all-reduce",
    "all_reduce_coalesced": "all-reduce", "all_reduce_coalesced_": "all-reduce",
    "all_gather_into_tensor": "all-gather",
    "all_gather_into_tensor_out": "all-gather",
    "all_gather_into_tensor_coalesced": "all-gather",
    "reduce_scatter_tensor": "reduce-scatter",
    "reduce_scatter_tensor_coalesced": "reduce-scatter",
    "all_to_all_single": "all-to-all",
}


@dataclass
class Cost:
    """Per-device cost of one traced call (``hlo_cost.Cost``'s fields, plus
    ``matmul_flops``, the peak of live bytes, the inputs' bytes and the
    raw collectives)."""
    flops: float = 0.0
    bytes: float = 0.0
    collective_bytes: float = 0.0
    coll_bytes_by_op: Dict[str, float] = field(default_factory=dict)
    coll_counts: Dict[str, float] = field(default_factory=dict)
    bytes_by_region: Dict[str, float] = field(default_factory=dict)
    matmul_flops: float = 0.0
    coll_bytes_by_link: Dict[str, float] = field(default_factory=dict)
    peak_bytes: float = 0.0
    arg_bytes: float = 0.0
    collectives: List[Tuple[str, float, Tuple[int, ...]]] = \
        field(default_factory=list)

    def add_bytes(self, nbytes: float, region: str) -> None:
        self.bytes += nbytes
        self.bytes_by_region[region] = \
            self.bytes_by_region.get(region, 0.) + nbytes

    def close(self) -> "Cost":
        """Charge the recorded collectives (``analysis.collective_stats``)."""
        stats = collective_stats(self.collectives)
        self.collective_bytes = stats.total_bytes
        self.coll_bytes_by_op = dict(stats.bytes_by_op)
        self.coll_counts = {k: float(v) for k, v in stats.counts.items()}
        self.coll_bytes_by_link = dict(stats.bytes_by_link)
        return self


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


class _Live:
    """Bytes of the storages alive now, and their highest sum. A storage
    joins once (a view adds nothing) and leaves when it is freed."""

    def __init__(self):
        self.ids: Dict[int, int] = {}
        self.now = 0
        self.peak = 0

    def add(self, t: torch.Tensor) -> None:
        st = t.untyped_storage()
        key = id(st)
        if key in self.ids:
            return
        n = st.nbytes()
        self.ids[key] = n
        self.now += n
        self.peak = max(self.peak, self.now)
        weakref.finalize(st, self._free, key)

    def _free(self, key: int) -> None:
        self.now -= self.ids.pop(key, 0)


class CostMode(TorchDispatchMode):
    """Counts one call's cost (see the module docstring). ``fake_mode``: the
    ``FakeTensorMode`` the step's tensors belong to; ops on other tensors
    are left out (without it every op counts: a real run). ``track`` adds
    the step's inputs to the live bytes before the call."""

    def __init__(self, fake_mode=None):
        super().__init__()
        self.fake_mode = fake_mode
        self.cost = Cost()
        self._live = _Live()
        self._region_of_code: Dict[CodeType, Optional[str]] = {}
        self._kinds: Dict[Any, str] = {}

    def track(self, *trees: Any) -> None:
        for t in tree_leaves(trees):
            if isinstance(t, DTensor):
                t = t._local_tensor
            if isinstance(t, torch.Tensor):
                self._live.add(t)
        self.cost.peak_bytes = self._live.peak
        self.cost.arg_bytes = float(self._live.now)

    # ------------------------------------------------------------- helpers

    def _ours(self, tensors: List[torch.Tensor]) -> bool:
        if self.fake_mode is None:
            return True
        return all(getattr(t, "fake_mode", None) is self.fake_mode
                   for t in tensors)

    def _kind(self, func) -> str:
        kind = self._kinds.get(func)
        if kind is None:
            name = func.__name__.split(".")[0]
            if func.namespace == "_c10d_functional":
                if name.startswith("wait_tensor"):
                    kind = "wait"
                elif name in _COLLECTIVE_KINDS:
                    kind = "collective"
                else:
                    raise NotImplementedError(
                        f"no charge for the collective {func}: add it to "
                        "_COLLECTIVE_KINDS")
            elif func.namespace in ("_c10d_functional_autograd", "c10d"):
                kind = "wait"       # their _c10d_functional op is counted
            elif name in _GATHERS:
                kind = "gather"
            elif name in _SCATTERS:
                kind = "scatter"
            elif any(r.alias_info is not None and r.alias_info.is_write
                     for r in func._schema.returns):
                kind = "inplace"
            elif any(r.alias_info is not None
                     for r in func._schema.returns):
                kind = "view"
            else:
                kind = "op"
            self._kinds[func] = kind
        return kind

    def _region(self) -> Optional[str]:
        """The region of the op being dispatched, or None for an op of
        DTensor's sharding propagation (not the step's)."""
        frame = sys._getframe(2)
        memo = self._region_of_code
        while frame is not None:
            code = frame.f_code
            region = memo.get(code, False)
            if region is False:
                parts = set(code.co_qualname.split("."))
                region = next((r for r, names in REGION_FUNCTIONS.items()
                               if parts & names), None)
                if code.co_filename.endswith(_PROPAGATION):
                    region = _SKIP
                memo[code] = region
            if region is not None:
                return None if region is _SKIP else region
            frame = frame.f_back
        return "other"

    # ------------------------------------------------------------ dispatch

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        leaves = tree_leaves((args, kwargs))
        if any(isinstance(a, DTensor) for a in leaves):
            return NotImplemented       # counted as DTensor's local ops
        out = func(*args, **kwargs)
        kind = self._kind(func)
        if kind == "wait":
            return out
        ins = [a for a in leaves if isinstance(a, torch.Tensor)]
        outs = [o for o in tree_leaves(out) if isinstance(o, torch.Tensor)]
        if not outs or not self._ours(ins + outs):
            return out                  # metadata, or not the step's
        region = self._region()
        if region is None:
            return out                  # DTensor's sharding propagation
        for o in outs:
            self._live.add(o)
        self.cost.peak_bytes = self._live.peak
        if not ins:
            return out                  # a factory: no work counted
        out_b = sum(_nbytes(o) for o in outs)
        if kind == "collective":
            name = func.__name__.split(".")[0]
            ranks = _group_ranks(list(args) + list(kwargs.values()))
            if ranks is None:
                raise RuntimeError(f"{func}: no process group among its "
                                   "arguments")
            self.cost.collectives.append(
                (_COLLECTIVE_KINDS[name], float(out_b), tuple(sorted(ranks))))
            self.cost.add_bytes(out_b, region)
            return out
        if kind == "gather":
            self.cost.add_bytes(2 * out_b, region)
            return out
        if kind == "scatter":   # the update: every floating input but the
            upd = sum(_nbytes(t) for t in ins[1:]   # destination, args[0]
                      if t.is_floating_point())
            if func.__name__.startswith("embedding_dense_backward"):
                upd = _nbytes(ins[0])               # the rows' gradients
            self.cost.add_bytes(2 * upd + min(out_b, 2 * upd), region)
            return out
        if kind == "op":    # an op whose output shares an input's storage
            stores = {id(t.untyped_storage()) for t in ins}
            if any(id(o.untyped_storage()) in stores for o in outs):
                kind = "view"           # is a view (``_unsafe_view``)
        if kind == "view":
            return out
        packet = func._overloadpacket
        if packet in flop_registry:
            f = float(flop_registry[packet](*args, **kwargs, out_val=out))
            self.cost.matmul_flops += f
        else:
            f = float(sum(o.numel() for o in outs))
        self.cost.flops += f
        self.cost.add_bytes(sum(_nbytes(t) for t in ins) + out_b, region)
        return out


def trace_cost(fn, *args, fake_mode=None, **kwargs) -> Tuple[Any, Cost]:
    """``fn(*args, **kwargs)`` under a ``CostMode``, its arguments counted
    in the live bytes from the start; returns (its result, the closed
    ``Cost``)."""
    mode = CostMode(fake_mode)
    mode.track(args, kwargs)
    with mode:
        out = fn(*args, **kwargs)
    return out, mode.cost.close()
