"""Mixture-of-Experts FFN (twin of ``repro.models.moe``), single-device
path (the reference's ``_moe_local`` with ``ep_axis=None``).

Tokens are routed with an fp32 router and top-k (renormalised when
``router_renorm``), sort-dispatched with a stable sort into a static
[E, C, D] buffer (rank within the expert; tokens ranked at or past the
capacity C are dropped), run through one batched GLU per projection, and
combined back with a scatter-add weighted by their gates. The expert
products are plain ``torch.einsum``s, as the reference leaves them to XLA
outside any Pallas kernel. At ``capacity_factor = n_experts / top_k`` the
capacity is at least the call's token count, and a token's k experts are
distinct, so no pair is dropped.

``moe_apply``'s body runs inside a ``torch.profiler.record_function("moe")``
range. Inside ``count_pairs(sink)`` every call adds its routed pairs and
the pairs it kept to ``sink`` on the device (the serving engine's
``moe_pairs`` and ``moe_pairs_dropped`` counters).
"""
from __future__ import annotations

import contextlib
import contextvars
from typing import Any, Dict, Iterator, Optional, Tuple

import torch
import torch.nn.functional as F

from torch.distributed.tensor import DTensor
from torch.profiler import record_function

from ..sharding import collectives as col
from ..sharding.api import active_rules
from .config import ModelConfig
from .layers import Param


def init_moe(cfg: ModelConfig) -> Dict[str, Param]:
    """The reference's parameter tree (``repro.models.moe.init_moe``) as
    :class:`Param` specs; ``transformer.init_params`` creates them."""
    d, f, e = cfg.d_model, cfg.d_ff_expert, cfg.n_experts
    return {"router": Param((d, e), d ** -0.5),
            "w1": Param((e, d, f), d ** -0.5, compute=True),
            "wg": Param((e, d, f), d ** -0.5, compute=True),
            "w2": Param((e, f, d), f ** -0.5, compute=True)}


def moe_axes() -> Dict[str, Any]:
    return {"router": ("embed", None),
            "w1": ("expert", "embed", "mlp"),
            "wg": ("expert", "embed", "mlp"),
            "w2": ("expert", "mlp", "embed")}


_SINK: contextvars.ContextVar[Optional[torch.Tensor]] = \
    contextvars.ContextVar("moe_pairs_sink", default=None)


@contextlib.contextmanager
def count_pairs(sink: Optional[torch.Tensor]) -> Iterator[None]:
    """Within it, each ``_moe_local`` call of this thread adds its routed
    (token, expert) pairs to ``sink[0]`` and the pairs it kept to
    ``sink[1]`` (``sink``: int64 [2] on the call's device), with no host
    sync, so a CUDA graph captured inside it adds them at every replay.
    ``sink`` None counts nothing."""
    token = _SINK.set(sink)
    try:
        yield
    finally:
        _SINK.reset(token)


def _capacity(tokens: int, cfg: ModelConfig) -> int:
    c = int(tokens * cfg.top_k / cfg.n_experts * cfg.capacity_factor)
    return max(8, -(-c // 8) * 8)


def _gates(x: torch.Tensor, router: torch.Tensor, cfg: ModelConfig
           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """fp32 router, top-k, optional renormalisation: (gates, experts) [T, K]."""
    probs = F.softmax(x.float() @ router.float(), dim=-1)
    gates, eidx = torch.topk(probs, cfg.top_k, dim=-1)
    if cfg.router_renorm:
        gates = gates / (gates.sum(-1, keepdim=True) + 1e-9)
    return gates, eidx


def _route(x: torch.Tensor, router: torch.Tensor, cfg: ModelConfig):
    """Stable sort of the T*K (token, expert) pairs by expert. Returns
    (expert, token, gate, rank within the expert, kept) in sorted order,
    with ``kept = rank < capacity``.

    No op reads a value back to the host, so a decode step can be
    captured in a CUDA graph: the per-expert counts are a scatter-add into
    E zeros, the reference's ``jnp.bincount(e_flat, length=E)``
    (``torch.bincount`` on the card reads the largest index back to size
    its output)."""
    T = x.shape[0]
    gates, eidx = _gates(x, router, cfg)
    e_flat = eidx.reshape(-1)
    t_flat = torch.arange(T, device=x.device).repeat_interleave(cfg.top_k)
    order = torch.sort(e_flat, stable=True).indices
    e_s, t_s, g_s = e_flat[order], t_flat[order], gates.reshape(-1)[order]
    counts = torch.zeros(cfg.n_experts, dtype=e_flat.dtype, device=x.device)
    counts.scatter_add_(0, e_flat, torch.ones_like(e_flat))
    offsets = counts.cumsum(0) - counts
    rank = torch.arange(e_s.shape[0], device=x.device) - offsets[e_s]
    return e_s, t_s, g_s, rank, rank < _capacity(T, cfg)


def _moe_local(x: torch.Tensor, router, w1, wg, w2, cfg: ModelConfig,
               compute_dtype=torch.bfloat16, ep=None) -> torch.Tensor:
    """x: [B, S, D] -> [B, S, D] in the compute dtype. With ``ep`` = (mesh,
    axis) this is one shard's body: x holds the shard's own tokens (the
    capacity is its own), w1/wg/w2 its E/P experts, and the dispatch goes
    to the expert shards and back by two all-to-alls over ``axis``."""
    Bl, Sl, D = x.shape
    x = x.reshape(Bl * Sl, D)
    T = x.shape[0]
    E, C = cfg.n_experts, _capacity(T, cfg)
    e_s, t_s, g_s, rank, keep = _route(x, router, cfg)
    sink = _SINK.get()
    if sink is not None:
        sink[0].add_(keep.numel())
        sink[1].add_(keep.sum())
    rank_c = torch.where(keep, rank, 0)
    e_c = torch.where(keep, e_s, 0)

    # dispatch into [E, C, D]: dropped pairs add zero at (0, 0)
    xt = x.to(compute_dtype)
    dispatch = torch.zeros((E, C, D), dtype=compute_dtype, device=x.device)
    dispatch.index_put_((e_c, rank_c),
                        xt[t_s] * keep[:, None].to(compute_dtype),
                        accumulate=True)

    if ep is not None:  # to the expert shards: [E/P, P*C, D], rank-major
        P = ep[0].size(ep[0].mesh_dim_names.index(ep[1]))
        dispatch = col.all_to_all(dispatch, *ep).reshape(
            P, E // P, C, D).transpose(0, 1).reshape(E // P, P * C, D)

    # batched expert GLU: one batched product per projection
    h = torch.einsum("ecd,edf->ecf", dispatch, w1.to(compute_dtype))
    g = torch.einsum("ecd,edf->ecf", dispatch, wg.to(compute_dtype))
    h = F.silu(g.float()).to(compute_dtype) * h
    y = torch.einsum("ecf,efd->ecd", h, w2.to(compute_dtype))
    if ep is not None:  # back to the token shards: [E, C, D]
        y = col.all_to_all(y.reshape(E // P, P, C, D).transpose(0, 1),
                           *ep).reshape(E, C, D)

    # combine: scatter-add each kept pair's output times its gate
    vals = y[e_c, rank_c] * (g_s * keep)[:, None].to(compute_dtype)
    out = torch.zeros((T, D), dtype=compute_dtype, device=x.device)
    out.index_add_(0, t_s, vals)
    return out.reshape(Bl, Sl, D)


def moe_apply(p: Dict[str, Any], x: torch.Tensor, cfg: ModelConfig,
              compute_dtype=torch.bfloat16) -> torch.Tensor:
    """x: [B, S, D] -> [B, S, D] in x's dtype. Under sharding rules (a
    DTensor x) each shard of (batch, seq) routes its own tokens with its
    own capacity, and the experts are sharded over the "expert" axis
    (``repro.models.moe.moe_apply``)."""
    with record_function("moe"):
        return _moe_body(p, x, cfg, compute_dtype)


def _moe_body(p: Dict[str, Any], x: torch.Tensor, cfg: ModelConfig,
              compute_dtype) -> torch.Tensor:
    rules = active_rules()
    if rules is None or not isinstance(x, DTensor):
        out = _moe_local(x, p["router"], p["w1"], p["wg"], p["w2"], cfg,
                         compute_dtype)
        return out.to(x.dtype)
    mesh = x.device_mesh
    ep = rules.bindings.get("expert")
    if not (isinstance(ep, str) or ep is None):
        raise ValueError(f"expert axis {ep!r} must be one mesh axis")
    xl = col.layout(mesh, {rules.bound("batch"): 0, rules.bound("seq"): 1})
    wl = col.layout(mesh, {ep: 0})

    def body(xs, router, w1, wg, w2):
        return _moe_local(xs, router, w1, wg, w2, cfg, compute_dtype,
                          ep=None if ep is None else (mesh, ep))

    out = col.local_call(body, mesh, (x, p["router"], p["w1"], p["wg"],
                                      p["w2"]),
                         (xl, col.layout(mesh, {}), wl, wl, wl), xl)
    return out.to(x.dtype)


def moe_ref(p: Dict[str, Any], x: torch.Tensor, cfg: ModelConfig
            ) -> torch.Tensor:
    """Dense oracle: every expert for every token in fp32, masked combine
    (no capacity, so no drops). O(T*E*F): small shapes only."""
    B, S, D = x.shape
    xt = x.reshape(B * S, D).float()
    gates, eidx = _gates(xt, p["router"], cfg)
    h = torch.einsum("td,edf->tef", xt, p["w1"].float())
    g = torch.einsum("td,edf->tef", xt, p["wg"].float())
    y = torch.einsum("tef,efd->ted", F.silu(g) * h, p["w2"].float())
    mask = torch.zeros((xt.shape[0], cfg.n_experts), device=x.device)
    mask.scatter_add_(1, eidx, gates)
    out = torch.einsum("ted,te->td", y, mask)
    return out.reshape(B, S, D).to(x.dtype)
