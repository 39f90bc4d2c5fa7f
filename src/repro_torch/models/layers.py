"""Shared model primitives: norms, rotary embeddings, dense/GLU blocks and
embedding (PyTorch twin of ``repro.models.layers``).

Parameters are plain nested dicts of tensors with the JAX package's tree
layout (dense ``w`` is ``[in, out]`` with an optional ``b``), so weights
convert leaf by leaf (see ``convert.py``). Every function casts its
parameters to the compute dtype before use, exactly as the reference does.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Callable, Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

from ..sharding import collectives as col
from ..sharding.api import active_rules, checkpoint, shard


@dataclass(frozen=True)
class Param:
    """One parameter for ``init_params`` to create: its shape and its
    initial values, a truncated normal of ``stddev`` when that is positive,
    else the values of ``fill()`` when given, else the constant ``value``.
    ``compute`` marks a leaf the reference casts to the compute dtype at
    every use: it is stored in the compute dtype, every other leaf in fp32
    (``init_params`` and ``params_from_jax`` both read it)."""
    shape: Tuple[int, ...]
    stddev: float = 0.0
    value: float = 0.0
    fill: Optional[Callable[[], torch.Tensor]] = None
    compute: bool = False

    def dtype(self, compute_dtype: torch.dtype) -> torch.dtype:
        return compute_dtype if self.compute else torch.float32


def dense_spec(d_in: int, d_out: int, *, bias: bool = False,
               stddev: Optional[float] = None,
               compute: bool = True) -> Dict[str, Param]:
    """``init_dense``'s tree: ``w`` [in, out] with stddev ``d_in ** -0.5``
    unless given, stored in the compute dtype unless ``compute`` is False,
    and a zero fp32 bias ``b`` [out] when asked for."""
    p = {"w": Param((d_in, d_out),
                    stddev if stddev is not None else d_in ** -0.5,
                    compute=compute)}
    if bias:
        p["b"] = Param((d_out,))
    return p


def glu_spec(d_model: int, d_ff: int) -> Dict[str, Any]:
    return {"wi": dense_spec(d_model, d_ff), "wg": dense_spec(d_model, d_ff),
            "wo": dense_spec(d_ff, d_model, stddev=d_ff ** -0.5)}


def dense_axes(ax_in: Optional[str], ax_out: Optional[str],
               bias: bool = False) -> Dict[str, Any]:
    """Logical axes of ``dense_spec``'s tree."""
    p: Dict[str, Any] = {"w": (ax_in, ax_out)}
    if bias:
        p["b"] = (ax_out,)
    return p


def glu_axes() -> Dict[str, Any]:
    return {"wi": dense_axes("embed", "mlp"),
            "wg": dense_axes("embed", "mlp"),
            "wo": dense_axes("mlp", "embed")}


def embed_axes() -> Dict[str, Any]:
    return {"table": ("vocab", "embed")}


def truncated_normal_(t: torch.Tensor, stddev: float,
                      generator: torch.Generator) -> torch.Tensor:
    """Fill ``t`` in place with N(0, 1) truncated to [-2, 2], times stddev
    (the distribution of ``repro.models.layers.truncated_normal``), drawn
    in fp32 and cast to ``t``'s dtype."""
    buf = torch.empty(t.shape, dtype=torch.float32, device=t.device)
    lo, hi = (1.0 + math.erf(-2.0 / math.sqrt(2.0))) / 2.0, \
        (1.0 + math.erf(2.0 / math.sqrt(2.0))) / 2.0
    buf.uniform_(2.0 * lo - 1.0, 2.0 * hi - 1.0, generator=generator)
    buf.erfinv_().mul_(math.sqrt(2.0) * stddev)
    buf.clamp_(-2.0 * stddev, 2.0 * stddev)
    return t.copy_(buf)


# ----------------------------------------------------------------- norms

def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-6,
             zero_centered: bool = False) -> torch.Tensor:
    """RMSNorm in fp32, cast back to x.dtype. gemma2 uses (1 + scale)."""
    xf = x.float()
    var = (xf * xf).mean(dim=-1, keepdim=True)
    xn = xf * torch.rsqrt(var + eps)
    s = scale.float()
    if zero_centered:
        s = 1.0 + s
    return (xn * s).to(x.dtype)


def group_norm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
               num_groups: int, eps: float = 64e-5) -> torch.Tensor:
    """GroupNorm over the last dim with fp32 statistics (the RWKV wkv
    output norm), cast back to x.dtype."""
    *lead, d = x.shape
    xf = x.float().reshape(*lead, num_groups, d // num_groups)
    mu = xf.mean(dim=-1, keepdim=True)
    var = xf.var(dim=-1, keepdim=True, unbiased=False)
    xn = ((xf - mu) * torch.rsqrt(var + eps)).reshape(*lead, d)
    return (xn * scale.float() + bias.float()).to(x.dtype)


# ----------------------------------------------------------------- rotary

def rope(x: torch.Tensor, positions: torch.Tensor,
         theta: float = 1e4) -> torch.Tensor:
    """Half-split rotary embedding in fp32. x [B, S, H, D]; positions [S]
    or [B, S]."""
    d = x.shape[-1]
    half = d // 2
    freqs = theta ** (-torch.arange(0, half, dtype=torch.float32,
                                    device=x.device) / half)
    ang = positions.float()[..., None] * freqs
    ang = ang[None, :, None, :] if positions.dim() == 1 else ang[:, :, None, :]
    cos, sin = torch.cos(ang), torch.sin(ang)
    x1, x2 = x[..., :half].float(), x[..., half:].float()
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin],
                     dim=-1).to(x.dtype)


# ----------------------------------------------------------------- dense / GLU

def matmul(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``x @ w``; for a DTensor x, on the local shards
    (``collectives.matmul``: no sharded dim of x is flattened)."""
    return col.matmul(x, w) if isinstance(x, DTensor) else x @ w


def dense(x: torch.Tensor, p: Dict[str, Any],
          compute_dtype=torch.bfloat16) -> torch.Tensor:
    out = matmul(x.to(compute_dtype), p["w"].to(compute_dtype))
    if "b" in p:
        if isinstance(out, DTensor):   # the bias once, on the whole sum
            out = col.resolved(out)
        out = out + p["b"].to(compute_dtype)
    return out


_ACTS = {"silu": F.silu,
         "gelu": lambda t: F.gelu(t, approximate="tanh"),
         "relu": F.relu}


def glu(x: torch.Tensor, p: Dict[str, Any], act: str = "silu",
        compute_dtype=torch.bfloat16) -> torch.Tensor:
    """SwiGLU / GeGLU feed-forward: the activation runs in fp32 and is cast
    to the compute dtype before the gate product.

    With active sharding rules binding seq and mlp to the same mesh axis,
    runs as the reference's explicit Megatron sequence parallelism
    (``_glu_seqpar``): all-gather the seq-sharded residual on entry,
    reduce-scatter the output back."""
    rules = active_rules()
    seq_ax = rules.bindings.get("seq") if rules is not None else None
    if (rules is not None and isinstance(seq_ax, str)
            and seq_ax == rules.bindings.get("mlp")
            and "b" not in p["wi"] and x.shape[1] > 1):
        return _glu_seqpar(x, p, act, compute_dtype, rules, seq_ax)
    h = dense(x, p["wi"], compute_dtype)
    g = dense(x, p["wg"], compute_dtype)
    h = _ACTS[act](g.float()).to(compute_dtype) * h
    h = shard(h, "batch", "act_seq", "mlp")
    return shard(dense(h, p["wo"], compute_dtype), "batch", "seq", "embed")


def _glu_seqpar(x, p, act, compute_dtype, rules, axis):
    """Explicit sequence parallelism plus FSDP (``repro.models.layers.
    _glu_seqpar``): gather seq on entry, gather the weights over the FSDP
    axis, reduce-scatter the output to seq shards."""
    mesh = x.device_mesh
    bd = rules.bound("batch")                        # batch mesh axes
    fa = rules.axis("embed")                         # FSDP axis (or None)
    lay = {a: d for a, d in ((bd, 0), (axis, 1))}

    def body(x_loc, wi, wg, wo):
        xf = col.gather(x_loc, 1, mesh, axis).to(compute_dtype)
        if fa is not None:
            wi = col.gather(wi, 0, mesh, fa)
            wg = col.gather(wg, 0, mesh, fa)
            wo = col.gather(wo, 1, mesh, fa)
        h = xf @ wi.to(compute_dtype)
        g = xf @ wg.to(compute_dtype)
        h = _ACTS[act](g.float()).to(compute_dtype) * h
        return col.scatter_sum(h @ wo.to(compute_dtype), 1, mesh, axis)

    w_in = col.layout(mesh, {fa: 0, axis: 1})
    return col.local_call(
        body, mesh, (x, p["wi"]["w"], p["wg"]["w"], p["wo"]["w"]),
        (col.layout(mesh, lay), w_in, w_in, col.layout(mesh, {axis: 0, fa: 1})),
        col.layout(mesh, lay))


# ----------------------------------------------------------------- embedding

def embed(tokens: torch.Tensor, p: Dict[str, Any], *,
          scale_by_dim: bool = False,
          compute_dtype=torch.bfloat16) -> torch.Tensor:
    tbl = p["table"].to(compute_dtype)
    if isinstance(tbl, DTensor) and active_rules() is not None:
        x = _embed_sharded(tokens, tbl)
    else:
        x = F.embedding(tokens.long(), tbl)
    if scale_by_dim:  # gemma embedding scaling, the factor rounded first
        x = x * _rounded(tbl.shape[-1] ** 0.5, compute_dtype)
    return shard(x, "batch", "seq", "embed")


def _embed_sharded(tokens: torch.Tensor, tbl: DTensor) -> DTensor:
    """Vocab-parallel lookup: each rank looks up its rows' tokens in its
    slice of the vocab (zeros for tokens outside it), and the slices sum
    over the vocab axis. The result is laid out by the batch binding."""
    rules = active_rules()
    mesh = tbl.device_mesh
    b = rules.bound("batch")
    vax = rules.axis("vocab")
    tpl = col.layout(mesh, {vax: 0})
    v0 = col.global_offset(tbl, tpl)[0]

    def body(tok, t):
        idx = tok.long() - v0
        own = (idx >= 0) & (idx < t.shape[0])
        x = F.embedding(idx.clamp(0, t.shape[0] - 1), t) * own[..., None]
        return x if vax is None else col.sum_replicated(x, mesh, vax)

    rows = col.layout(mesh, {b: 0})
    return col.local_call(body, mesh, (tokens, tbl), (rows, tpl), rows)


def _rounded(value: float, dtype: Optional[torch.dtype]) -> float:
    """``value`` rounded to ``dtype`` (as ``jnp.asarray(value, dtype)``)."""
    return float(torch.tensor(value, dtype=dtype))


# ----------------------------------------------------------------- chunked loss

def _xent_chunk(hc: torch.Tensor, wv: torch.Tensor, lc: torch.Tensor,
                mc: torch.Tensor, final_softcap: float, valid_vocab: int,
                compute_dtype) -> torch.Tensor:
    """Masked cross-entropy sum of one chunk: logits [B, c, V] in fp32,
    softcapped, padded vocab rows at -1e30, then lse minus the label's."""
    V = wv.shape[-1]
    logits = matmul(hc.to(compute_dtype), wv).float()
    if final_softcap > 0.0:
        logits = torch.tanh(logits / final_softcap) * final_softcap
    if 0 < valid_vocab < V:     # padded vocab rows stay out of the lse
        pad = torch.arange(V, device=logits.device) >= valid_vocab
        logits = logits.masked_fill(pad, -1e30)
    logits = shard(logits, "batch", "act_seq", "vocab")
    if isinstance(logits, DTensor):
        return _xent_sharded(logits, lc, mc)
    lse = torch.logsumexp(logits, dim=-1)
    lab = logits.gather(-1, lc.long()[..., None])[..., 0]
    return ((lse - lab) * mc).sum()


def _xent_sharded(logits: DTensor, lc: torch.Tensor,
                  mc: torch.Tensor) -> DTensor:
    """``_xent_chunk``'s tail on vocab-sharded logits [B, c, V] (batch and
    vocab sharded as the rules lay them out): each rank's log-sum-exp and
    label logit over its vocab slice, summed over the vocab axis (the max
    first, as the shift). The result is each rank's sum over its rows,
    partial over the batch axes."""
    rules = active_rules()
    mesh = logits.device_mesh
    b = rules.bound("batch")
    vax = rules.axis("vocab")
    lay = col.layout(mesh, {b: 0, vax: 2})
    v0 = col.global_offset(logits, lay)[2]

    def body(lg, lab_ids, m):
        mx = lg.detach().amax(dim=-1)
        if vax is not None:
            mx = col.all_reduce(mx, "max", mesh, vax)
        se = torch.exp(lg - mx[..., None]).sum(dim=-1)
        idx = lab_ids.long() - v0
        own = (idx >= 0) & (idx < lg.shape[-1])
        lab = lg.gather(-1, idx.clamp(0, lg.shape[-1] - 1)[..., None])[..., 0]
        lab = lab * own
        if vax is not None:
            se = col.sum_replicated(se, mesh, vax)
            lab = col.sum_replicated(lab, mesh, vax)
        return ((mx + torch.log(se) - lab) * m).sum()

    rows = col.layout(mesh, {b: 0})
    out = tuple(Partial() if p == Shard(0) else Replicate() for p in rows)
    return col.local_call(body, mesh, (logits, lc, mc), (lay, rows, rows), out)


def chunked_softmax_xent(h: torch.Tensor, vocab_w: torch.Tensor,
                         labels: torch.Tensor, *,
                         mask: Optional[torch.Tensor], chunk: int = 512,
                         final_softcap: float = 0.0, valid_vocab: int = 0,
                         compute_dtype=torch.bfloat16
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Cross-entropy without holding [B, S, V] logits (twin of
    ``repro.models.layers.chunked_softmax_xent``).

    Walks sequence chunks of ``chunk`` positions; per chunk computes the
    fp32 logits [B, c, V], the log-sum-exp and the label's logit. Each
    chunk's body is recomputed in the backward pass
    (``torch.utils.checkpoint``, the reference's ``jax.checkpoint``), so at
    most one chunk's logits are alive. A ragged last chunk is sliced where
    the reference pads it with mask 0, which adds exactly zero.
    h: [B, S, D]; vocab_w: [D, V]; labels: [B, S]; mask: [B, S] or None.
    Returns (total loss sum, total weight), fp32 scalars."""
    B, S, _ = h.shape
    c = min(chunk, S)
    if mask is None:
        mask = torch.ones((B, S), dtype=torch.float32, device=h.device)
    mask = mask.float()
    wv = vocab_w.to(compute_dtype)
    loss_sum = torch.zeros((), dtype=torch.float32, device=h.device)
    w_sum = torch.zeros((), dtype=torch.float32, device=h.device)
    for s0 in range(0, S, c):
        sl = slice(s0, s0 + c)
        loss_sum = loss_sum + checkpoint(
            _xent_chunk, h[:, sl], wv, labels[:, sl], mask[:, sl],
            final_softcap, valid_vocab, compute_dtype)
        w_sum = w_sum + mask[:, sl].sum()
    return loss_sum, w_sum
