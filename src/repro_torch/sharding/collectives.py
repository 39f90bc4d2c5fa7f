"""Local regions and the collectives of the explicit bodies (the port's
``shard_map``).

A local region runs a function on the local shards of DTensors: each input
is redistributed to the placements the region asks for and handed over as
its local tensor, and each output is wrapped back with the placements the
region declares. ``local_call`` derives the placements of each input's
gradient: where an input is replicated over a mesh dim and some output is
sharded over it, every rank computes a different part, so the gradient is
a sum over that dim (``Partial``); otherwise it has the input's own
placements (an explicit body that all-gathers an input returns its
gradient reduce-scattered by the gather's backward).

The collectives are ``torch.distributed._functional_collectives`` over one
mesh dim; those used where a gradient flows are the autograd-aware ones
(the backward of an all-gather is a reduce-scatter, and of an all-to-all
the reverse all-to-all).
"""
from __future__ import annotations

from typing import Any, Callable, Dict, Optional, Sequence, Tuple, Union

import torch
import torch.distributed._functional_collectives as funcol
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
from torch.distributed.tensor._utils import \
    compute_local_shape_and_global_offset
from torch._subclasses.fake_tensor import unset_fake_temporarily

Placements = Tuple[Union[Shard, Replicate], ...]


def group(mesh, axis: str):
    """The (mesh, dim) group of mesh axis ``axis``."""
    return (mesh, mesh.mesh_dim_names.index(axis))


def layout(mesh, dims: Dict[Any, int]) -> Placements:
    """Placements from {mesh axis (or a tuple of axes): tensor dim}; every
    other mesh dim replicated. ``None`` keys are skipped."""
    names = tuple(mesh.mesh_dim_names)
    out = [Replicate()] * len(names)
    for axes, dim in dims.items():
        if axes is None:
            continue
        for a in ((axes,) if isinstance(axes, str) else axes):
            out[names.index(a)] = Shard(dim)
    return tuple(out)


def _shard_box(x: DTensor, placements: Placements):
    """(local shape, global offset) of this rank's shard. DTensor computes
    them from the mesh's coordinate tensor, a real tensor that a fake
    tensor mode (the dry-run's) would turn into a fake one whose values
    cannot be read; so the mode is set aside for the arithmetic."""
    with unset_fake_temporarily():
        return compute_local_shape_and_global_offset(
            x.shape, x.device_mesh, placements)


def local_shape(x: DTensor) -> Tuple[int, ...]:
    """The shape of this rank's shard."""
    return tuple(_shard_box(x, x.placements)[0])


def global_offset(x: DTensor, placements: Optional[Placements] = None
                  ) -> Tuple[int, ...]:
    """The global index of the first element of this rank's shard of x,
    laid out as it is or by ``placements`` (nothing moves)."""
    return tuple(_shard_box(x, placements or x.placements)[1])


# ------------------------------------------------------------- collectives

def gather(x: torch.Tensor, dim: int, mesh, axis: str) -> torch.Tensor:
    """All-gather ``x`` along ``dim`` over ``axis`` (tiled), with autograd."""
    return funcol.all_gather_tensor_autograd(x.contiguous(), dim,
                                             group(mesh, axis))


def scatter_sum(x: torch.Tensor, dim: int, mesh, axis: str) -> torch.Tensor:
    """Sum over ``axis`` and keep this rank's part of ``dim`` (tiled
    reduce-scatter, the reference's ``psum_scatter``), with autograd."""
    return funcol.reduce_scatter_tensor_autograd(x.contiguous(), "sum", dim,
                                                 group(mesh, axis))


def all_to_all(x: torch.Tensor, mesh, axis: str) -> torch.Tensor:
    """Equal parts of dim 0 to each rank of ``axis`` in order, the parts
    received stacked in rank order along dim 0, with autograd."""
    return funcol.all_to_all_single_autograd(x.contiguous(), None, None,
                                             group(mesh, axis))


def all_reduce(x: torch.Tensor, op: str, mesh, axis: str) -> torch.Tensor:
    """All-reduce (``"sum"`` or ``"max"``) over ``axis``; no gradient.
    ``wait_tensor`` rather than the result's ``.wait()``, which a fake
    tensor lacks."""
    return funcol.wait_tensor(funcol.all_reduce(x.contiguous(), op,
                                                group(mesh, axis)))


class _SumOfReplicated(torch.autograd.Function):
    """All-reduce sum whose result every rank goes on to use alike, so the
    gradient of each rank's part is the result's gradient (identity)."""

    @staticmethod
    def forward(ctx, x, mesh, axis):
        return all_reduce(x, "sum", mesh, axis)

    @staticmethod
    def backward(ctx, g):
        return g, None, None


def sum_replicated(x: torch.Tensor, mesh, axis: str) -> torch.Tensor:
    return _SumOfReplicated.apply(x, mesh, axis)


# ------------------------------------------------------------ local regions

def local_part(t: torch.Tensor, mesh, placements: Placements) -> torch.Tensor:
    """This rank's part of ``t`` laid out by ``placements``; a plain tensor
    is read as replicated. No gradient."""
    if not isinstance(t, DTensor):
        t = DTensor.from_local(t, mesh, [Replicate()] * mesh.ndim,
                               run_check=False)
    return t.redistribute(mesh, placements).to_local()


def local_call(fn: Callable, mesh, args: Sequence[Any],
               in_placements: Sequence[Optional[Placements]],
               out_placements: Union[Placements, Sequence[Optional[Placements]]],
               ) -> Any:
    """``fn`` on the local shards of ``args``. A DTensor argument is
    redistributed to its entry of ``in_placements``; a plain tensor is read
    as replicated (the same on every rank, as ``implicit_replication``
    reads it) and sliced to its entry; anything else (a number, None) is
    passed as it is. ``fn`` returns a
    tensor or a tuple; each tensor result becomes a DTensor with its entry
    of ``out_placements`` (a single placements tuple for a single result;
    a None result stays None)."""
    single = not (out_placements and isinstance(out_placements[0],
                                                (tuple, list, type(None))))
    outs = [out_placements] if single else list(out_placements)
    sharded = {d for pl in outs if pl is not None
               for d, p in enumerate(pl) if isinstance(p, Shard)}
    local = []
    for a, pl in zip(args, in_placements):
        if isinstance(a, torch.Tensor) and not isinstance(a, DTensor):
            local.append(local_part(a, mesh, pl))
        elif isinstance(a, DTensor):
            grad = [Partial() if isinstance(p, Replicate) and d in sharded
                    else p for d, p in enumerate(pl)]
            local.append(a.redistribute(mesh, pl).to_local(
                grad_placements=grad))
        else:
            local.append(a)
    res = fn(*local)
    res = [res] if single else list(res)
    wrapped = [None if r is None else
               DTensor.from_local(r, mesh, pl, run_check=False)
               for r, pl in zip(res, outs)]
    return wrapped[0] if single else tuple(wrapped)


def matmul(x: DTensor, w: torch.Tensor) -> DTensor:
    """``x [..., K] @ w [K, N]`` on the local shards, so that no sharded
    dim of x is flattened. Per mesh dim: where w's columns are sharded the
    result's columns are too (x whole there); where x's K and w's rows are
    sharded alike the result is a partial sum; where x's rows are sharded
    they stay so (w whole there); else both are whole."""
    mesh = x.device_mesh
    w_pl = w.placements if isinstance(w, DTensor) else (Replicate(),) * mesh.ndim
    last = x.ndim - 1
    xin, win, out = [], [], []
    for xp, wp in zip(x.placements, w_pl):
        if wp == Shard(1):
            xin.append(Replicate()); win.append(wp); out.append(Shard(last))
        elif xp == Shard(last) and wp == Shard(0):
            xin.append(xp); win.append(wp); out.append(Partial())
        elif isinstance(xp, Shard) and xp.dim != last:
            xin.append(xp); win.append(Replicate()); out.append(xp)
        else:
            xin.append(Replicate()); win.append(Replicate())
            out.append(Replicate())
    return local_call(lambda a, b: a @ b, mesh, (x, w),
                      (tuple(xin), tuple(win)), tuple(out))


def resolved(t: DTensor) -> DTensor:
    """``t`` with its partial sums reduced (replicated there)."""
    if not any(p.is_partial() for p in t.placements):
        return t
    return t.redistribute(t.device_mesh, [Replicate() if p.is_partial()
                                          else p for p in t.placements])
