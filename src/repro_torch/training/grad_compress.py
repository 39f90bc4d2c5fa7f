"""Cross-pod gradient compression, int8 with error feedback (twin of
``repro.training.grad_compress``).

Multi-pod data parallelism pays for a full fp32 gradient all-reduce over the
scarce cross-pod links. Each pod quantizes its gradient to int8 with one
scale per tensor, the scale the largest over the pods so that all agree,
sums the int8 values over the pods in int32, and keeps its quantization
error as a residual that the next step adds back (1-bit-Adam lineage).

The values here are pod-local: a tensor's local value on a rank is its
pod's (a DTensor is read shard by shard, its other mesh dims as they lie;
a plain tensor as it is), and only the "pod" mesh dim is reduced over.
The reference computes a first int32 sum with each pod's own scale and
overwrites it (``grad_compress.py:49``, ``:54``); that dead collective, and
``_quantize`` that only it uses, are not ported.
"""
from __future__ import annotations

from typing import Any, Tuple

import torch
from torch.distributed.tensor import DTensor, Shard

from ..sharding import collectives as col
from .optimizer import tree_map


def init_error_state(grads_like: Any) -> Any:
    """fp32 zeros shaped like each leaf (DTensors laid out as theirs)."""
    return tree_map(lambda g: torch.zeros_like(g, dtype=torch.float32),
                    grads_like)


def _sharded_max(x: torch.Tensor) -> torch.Tensor:
    """max |x| over the whole tensor, as a plain 0-d tensor: a DTensor's
    local max reduced over every mesh dim that shards it."""
    if not isinstance(x, DTensor):
        return x.abs().max()
    m = x.to_local().abs().amax()
    mesh = x.device_mesh
    for d, p in enumerate(x.placements):
        if isinstance(p, Shard):
            m = col.all_reduce(m, "max", mesh, mesh.mesh_dim_names[d])
    return m


def reduce_one(g: torch.Tensor, e: torch.Tensor, mesh, pod_axis: str = "pod"
               ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                          torch.Tensor]:
    """One leaf: (mean over pods, new error, q, int32 total), the first two
    laid out as ``g``. ``repro.training.step``'s ``reduce_one``: gf = g + e,
    smax = the pods' largest max|gf| / 127 + 1e-30, q = round(gf / smax)
    clipped to [-127, 127] in int8, total = the pods' int32 sum of q,
    mean = total * smax / npod, new error = gf - q * smax."""
    npod = mesh.size(mesh.mesh_dim_names.index(pod_axis))
    gf = g.float() + e
    local = gf.to_local() if isinstance(gf, DTensor) else gf
    scale = _sharded_max(gf) / 127.0 + 1e-30
    smax = col.all_reduce(scale, "max", mesh, pod_axis)
    q = torch.clamp(torch.round(local / smax), -127, 127).to(torch.int8)
    total = col.all_reduce(q.to(torch.int32), "sum", mesh, pod_axis)
    mean = total.float() * smax / npod
    new_e = local - q.float() * smax
    if isinstance(gf, DTensor):
        mean, new_e = (DTensor.from_local(t, gf.device_mesh, gf.placements,
                                          run_check=False)
                       for t in (mean, new_e))
    return mean, new_e, q, total


def compressed_pod_mean(grads: Any, error: Any, mesh,
                        pod_axis: str = "pod") -> Tuple[Any, Any]:
    """Mean-reduce pod-local gradients over the pod axis with int8
    compression and error feedback. Returns (the mean gradients, the new
    error state); without a pod axis, (grads, error) as they are."""
    if pod_axis not in mesh.mesh_dim_names:
        return grads, error
    if isinstance(grads, dict):
        pairs = {k: compressed_pod_mean(grads[k], error[k], mesh, pod_axis)
                 for k in grads}
        return ({k: v[0] for k, v in pairs.items()},
                {k: v[1] for k, v in pairs.items()})
    mean, new_e, _, _ = reduce_one(grads, error, mesh, pod_axis)
    return mean.to(grads.dtype), new_e
