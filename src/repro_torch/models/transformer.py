"""Decoder LM (twin of ``repro.models.transformer``) for the layer kinds
"g" (global attention), "l" (local sliding-window attention), "m" (Mamba)
and "r" (RWKV6), with dense GLU or MoE feed-forward layers, plus the
encoder-decoder stack (seamless: a bidirectional encoder over
``speech_stub`` frames, cross-attention in every decoder "g"/"l"
sub-layer) and the ``vit_stub`` patches of the VLM.

A model is a tiled stack of blocks, each instantiating
``cfg.layer_pattern`` (e.g. "mmmmgmmm" for jamba, "r" for rwkv6).
Parameters keep the reference's tree: blocks are stacked on a leading
``n_blocks`` axis (encoder blocks on ``n_enc_layers``) and sub-layers are
named ``sub{i}``; the forward pass loops over blocks in Python where the
reference scans. The frontends are stubs, as in the reference: precomputed
frame or patch embeddings enter through ``frontend_proj``.

A parameter is stored in the compute dtype only where the reference casts
it to the compute dtype at every use (``Param.compute``), and in fp32
elsewhere, so the numerics are the reference's. The decode cache, the
recurrent states included, is updated in place.

Training: ``forward(remat=True)`` recomputes each block in the backward
pass (``torch.utils.checkpoint``, the reference's ``nothing_saveable`` scan
body), each encoder block is recomputed whether or not ``remat`` is set
(the reference's ``jax.checkpoint`` of the encoder body), and ``loss_fn``
is the reference's next-token loss through ``layers.chunked_softmax_xent``.

The cross K/V of an encoder-decoder cache are preallocated with the cache
(``init_cache(enc_len=...)``) and filled in place by a prefill with
frames, so a frame count other than the cache's ``enc_len`` raises where
the reference returns a cross cache of the frames' length; so does a
cross-attention against a cache of ``enc_len`` 0 (the reference divides
by zero there).
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch
from torch.distributed.tensor import DTensor, Replicate, Shard

from ..device import DeviceLike, resolve_device
from ..sharding import collectives as col
from ..sharding.api import checkpoint, shard
from .attention import attn_apply, attn_axes, init_cross_kv_cache
from .config import ModelConfig
from .layers import (Param, chunked_softmax_xent, dense_axes, dense_spec,
                     embed, embed_axes, glu, glu_axes, glu_spec, matmul,
                     rms_norm, truncated_normal_)
from .mamba import init_mamba_block, mamba_apply, mamba_block_axes
from .moe import init_moe, moe_apply, moe_axes
from .rwkv6 import channel_mix, init_rwkv_block, rwkv_block_axes, time_mix

KINDS = ("g", "l", "m", "r")


def check_supported(cfg: ModelConfig) -> None:
    """Raise ``NotImplementedError`` for layer kinds the port lacks."""
    kinds = sorted(set(cfg.layer_pattern) - set(KINDS))
    if kinds:
        raise NotImplementedError(f"{cfg.name}: layer kinds {kinds} are not "
                                  "ported yet")


def _moe_static(cfg: ModelConfig, i: int) -> bool:
    """MoE-ness of sub-layer i must not depend on the block index."""
    if not cfg.is_moe:
        return False
    if cfg.block_period % cfg.moe_every and cfg.moe_every != 1:
        raise ValueError(f"{cfg.name}: moe_every must divide the block period")
    return i % cfg.moe_every == cfg.moe_offset


# ---------------------------------------------------------------- init

def _attn_spec(cfg: ModelConfig) -> Dict[str, Any]:
    """``repro.models.attention.init_attn``'s tree (self or cross)."""
    d, hd = cfg.d_model, cfg.head_dim
    return {"wq": dense_spec(d, cfg.n_heads * hd, bias=cfg.qkv_bias),
            "wk": dense_spec(d, cfg.n_kv_heads * hd, bias=cfg.qkv_bias),
            "wv": dense_spec(d, cfg.n_kv_heads * hd, bias=cfg.qkv_bias),
            "wo": dense_spec(cfg.n_heads * hd, d,
                             stddev=(cfg.n_heads * hd) ** -0.5)}


def _block_spec(cfg: ModelConfig) -> Dict[str, Any]:
    """One decoder block's tree (``repro.models.transformer.init_block``)."""
    d = cfg.d_model

    def norm():
        return Param((d,), value=0.0 if cfg.zero_centered_norm else 1.0)

    subs: Dict[str, Any] = {}
    for i, kind in enumerate(cfg.layer_pattern):
        sub: Dict[str, Any] = {"ln1": norm()}
        if kind in ("g", "l"):
            sub["attn"] = _attn_spec(cfg)
            if cfg.is_encdec:
                sub["ln_cross"] = norm()
                sub["cross"] = _attn_spec(cfg)
        elif kind == "m":
            sub["mamba"] = init_mamba_block(cfg)
        else:
            sub["rwkv"] = init_rwkv_block(cfg)
        sub["ln2"] = norm()
        if kind != "r":
            sub["ffn"] = (init_moe(cfg) if _moe_static(cfg, i)
                          else glu_spec(d, cfg.d_ff))
        if cfg.post_norms:
            sub["post_ln1"] = norm()
            sub["post_ln2"] = norm()
        subs[f"sub{i}"] = sub
    return subs


def param_specs(cfg: ModelConfig) -> Dict[str, Any]:
    """The parameter tree of ``repro.models.transformer.init_params`` as
    :class:`Param` specs (block leaves without their leading n_blocks or
    n_enc_layers axis)."""
    check_supported(cfg)
    d = cfg.d_model
    spec: Dict[str, Any] = {
        "embed": {"table": Param((cfg.padded_vocab, d), 1.0, compute=True)},
        "final_norm": Param((d,), value=0.0 if cfg.zero_centered_norm
                            else 1.0),
        "blocks": _block_spec(cfg),
    }
    if not cfg.tie_embeddings:
        spec["lm_head"] = dense_spec(d, cfg.padded_vocab)
    if cfg.is_encdec:   # _init_enc_block: norms of ones whatever zc says
        spec["enc_blocks"] = {"ln1": Param((d,), value=1.0),
                              "attn": _attn_spec(cfg),
                              "ln2": Param((d,), value=1.0),
                              "ffn": glu_spec(d, cfg.d_ff)}
        spec["enc_final_norm"] = Param((d,), value=1.0)
    if cfg.frontend:
        spec["frontend_proj"] = dense_spec(cfg.frontend_dim, d)
    return spec


def block_axes(cfg: ModelConfig, decoder: bool = True) -> Dict[str, Any]:
    """Logical axes of one block's tree (``_block_spec``)."""
    out: Dict[str, Any] = {}
    for i, kind in enumerate(cfg.layer_pattern):
        sub: Dict[str, Any] = {"ln1": (None,)}
        if kind in ("g", "l"):
            sub["attn"] = attn_axes(cfg)
        elif kind == "m":
            sub["mamba"] = mamba_block_axes(cfg)
        elif kind == "r":
            sub["rwkv"] = rwkv_block_axes(cfg)
        if cfg.is_encdec and decoder and kind in ("g", "l"):
            sub["ln_cross"] = (None,)
            sub["cross"] = attn_axes(cfg)
        sub["ln2"] = (None,)
        if kind != "r":
            sub["ffn"] = moe_axes() if _moe_static(cfg, i) else glu_axes()
        if cfg.post_norms:
            sub["post_ln1"] = (None,)
            sub["post_ln2"] = (None,)
        out[f"sub{i}"] = sub
    return out


def _stacked(tree: Any) -> Any:
    """``tree``'s axes with the leading stacked "layers" axis."""
    if isinstance(tree, dict):
        return {k: _stacked(v) for k, v in tree.items()}
    return ("layers",) + tuple(tree)


def param_axes(cfg: ModelConfig) -> Dict[str, Any]:
    """Logical axes of ``init_params``'s tree (same structure)."""
    axes: Dict[str, Any] = {"embed": embed_axes(), "final_norm": (None,),
                            "blocks": _stacked(block_axes(cfg))}
    if not cfg.tie_embeddings:
        axes["lm_head"] = dense_axes("embed", "vocab")
    if cfg.is_encdec:
        axes["enc_blocks"] = _stacked({"ln1": (None,),
                                       "attn": attn_axes(cfg),
                                       "ln2": (None,), "ffn": glu_axes()})
        axes["enc_final_norm"] = (None,)
    if cfg.frontend:
        axes["frontend_proj"] = dense_axes(None, "embed")
    return axes


def init_params(cfg: ModelConfig, *, generator: torch.Generator,
                device: DeviceLike = None,
                dtype: torch.dtype = torch.bfloat16) -> Dict[str, Any]:
    """Random parameters with the reference's tree and distributions
    (truncated normals of the reference's scales, its constants), each leaf
    stored as its ``Param.dtype`` says with ``dtype`` as the compute dtype.
    ``generator`` must live on ``device``."""
    spec = param_specs(cfg)
    device = resolve_device(device)
    stacks = {"blocks": cfg.n_blocks, "enc_blocks": cfg.n_enc_layers}

    def make(p: Any, path: Tuple[str, ...]) -> Any:
        if isinstance(p, dict):
            return {k: make(v, path + (k,)) for k, v in p.items()}
        n = stacks.get(path[0], 0)          # the leading stacked axis, if any
        shape = ((n,) if n else ()) + p.shape
        t = torch.empty(shape, dtype=p.dtype(dtype), device=device)
        if p.stddev > 0:
            for part in (t if n else [t]):   # per block: bounded temp
                truncated_normal_(part, p.stddev, generator)
        elif p.fill is not None:
            t.copy_(p.fill())
        else:
            t.fill_(p.value)
        return t

    return make(spec, ())


# ---------------------------------------------------------------- cache

def init_cache(cfg: ModelConfig, batch: int, max_len: int, *,
               enc_len: int = 0, dtype: torch.dtype = torch.bfloat16,
               device: DeviceLike = None) -> Dict[str, Any]:
    """Stacked decode cache, one entry per sub-layer, each leaf
    [n_blocks, batch, ...]: attention "k"/"v" [max_len, n_kv_heads,
    head_dim] in ``dtype``, and for an encoder-decoder "cross_k"/"cross_v"
    [enc_len, n_kv_heads, head_dim] in ``dtype``; Mamba "conv"
    [d_conv-1, d_inner] and "ssm" [d_inner, d_state], RWKV
    "shift_tm"/"shift_cm" [1, d_model] and "wkv" [heads, head_size,
    head_size], all fp32 whatever ``dtype`` is."""
    check_supported(cfg)
    device = resolve_device(device)

    def zeros(*shape, dt=torch.float32):
        return torch.zeros((cfg.n_blocks, batch) + shape, dtype=dt,
                           device=device)

    cache: Dict[str, Any] = {}
    for i, kind in enumerate(cfg.layer_pattern):
        if kind in ("g", "l"):
            kv = (max_len, cfg.n_kv_heads, cfg.head_dim)
            sub = {"k": zeros(*kv, dt=dtype), "v": zeros(*kv, dt=dtype)}
            if cfg.is_encdec:
                ckv = (enc_len, cfg.n_kv_heads, cfg.head_dim)
                sub["cross_k"] = zeros(*ckv, dt=dtype)
                sub["cross_v"] = zeros(*ckv, dt=dtype)
            cache[f"sub{i}"] = sub
        elif kind == "m":
            di = cfg.mamba_d_inner
            cache[f"sub{i}"] = {"conv": zeros(cfg.mamba_d_conv - 1, di),
                                "ssm": zeros(di, cfg.mamba_d_state)}
        else:
            hs = cfg.rwkv_head_size
            cache[f"sub{i}"] = {"shift_tm": zeros(1, cfg.d_model),
                                "shift_cm": zeros(1, cfg.d_model),
                                "wkv": zeros(cfg.d_model // hs, hs, hs)}
    return cache


def cache_axes(cfg: ModelConfig) -> Dict[str, Any]:
    """Logical axes for the cache tree (same structure as init_cache)."""
    axes: Dict[str, Any] = {}
    for i, kind in enumerate(cfg.layer_pattern):
        if kind in ("g", "l"):
            kv = ("layers", "batch", "cache_seq", "kv_heads", None)
            axes[f"sub{i}"] = {"k": kv, "v": kv}
            if cfg.is_encdec:
                axes[f"sub{i}"].update(cross_k=kv, cross_v=kv)
        elif kind == "m":
            axes[f"sub{i}"] = {"conv": ("layers", "batch", None, "inner"),
                               "ssm": ("layers", "batch", "inner", None)}
        else:
            axes[f"sub{i}"] = {
                "shift_tm": ("layers", "batch", None, None),
                "shift_cm": ("layers", "batch", None, None),
                "wkv": ("layers", "batch", "heads", None, None)}
    return axes


# ---------------------------------------------------------------- forward

def _block(tree: Any, i: int) -> Any:
    """Views of block ``i`` of a tree stacked on the leading axis."""
    if isinstance(tree, dict):
        return {k: _block(v, i) for k, v in tree.items()}
    return tree[i]


def _unbind(tree: Any, n: int) -> list:
    """The ``n`` blocks of a tree stacked on the leading axis, as views.
    One ``unbind`` per leaf: its backward stacks the blocks' gradients
    once, where indexing block by block would give each block's gradient
    a zero-filled tensor of the whole stack."""
    if isinstance(tree, dict):
        parts = {k: _unbind(v, n) for k, v in tree.items()}
        return [{k: parts[k][i] for k in tree} for i in range(n)]
    return list(tree.unbind(0))


def _encode(params, frames: torch.Tensor, cfg: ModelConfig, impl,
            compute_dtype) -> torch.Tensor:
    """Audio encoder: frames [B, S, frontend_dim] -> [B, S, D], through
    ``frontend_proj``, bidirectional blocks with RoPE over the frame
    positions and ``enc_final_norm`` (no zero-centring). Under grad mode
    each block keeps only its input and runs again in the backward pass,
    whatever ``remat`` says (the reference checkpoints its encoder body)."""
    x = matmul(frames.to(compute_dtype),
               params["frontend_proj"]["w"].to(compute_dtype))
    x = shard(x, "batch", "seq", "embed")
    positions = torch.arange(frames.shape[1], device=x.device)
    eps = cfg.norm_eps

    def body(h, p):
        out, _ = attn_apply(p["attn"], rms_norm(h, p["ln1"], eps), cfg=cfg,
                            causal=False, positions=positions, impl=impl,
                            compute_dtype=compute_dtype)
        h = h + out
        h = h + glu(rms_norm(h, p["ln2"], eps), p["ffn"], cfg.act,
                    compute_dtype)
        return shard(h, "batch", "seq", "embed")

    for p in _unbind(params["enc_blocks"], cfg.n_enc_layers):
        x = (checkpoint(body, x, p)
             if torch.is_grad_enabled() else body(x, p))
    return rms_norm(x, params["enc_final_norm"], eps)


def _rows_like(t: torch.Tensor, like: DTensor) -> DTensor:
    """A plain tensor, the same on every rank, as a DTensor whose dims 0 and
    1 are sharded as ``like``'s (batch and sequence; its other dims
    whole), where they divide: each rank projects only its own patches,
    as the reference's sharded step does."""
    mesh = like.device_mesh
    pl = tuple(p if isinstance(p, Shard) and p.dim in (0, 1)
               and t.shape[p.dim] % mesh.size(i) == 0 else Replicate()
               for i, p in enumerate(like.placements))
    return DTensor.from_local(col.local_part(t, mesh, pl), mesh, pl,
                              run_check=False)


def forward(params, cfg: ModelConfig, *, tokens: torch.Tensor,
            positions: Optional[torch.Tensor] = None, cache=None,
            lengths: Optional[torch.Tensor] = None,
            frames: Optional[torch.Tensor] = None,
            patches: Optional[torch.Tensor] = None, remat: bool = False,
            impl: Optional[str] = None, compute_dtype=torch.bfloat16,
            prompt_lengths: Optional[torch.Tensor] = None
            ) -> Tuple[torch.Tensor, Any]:
    """Run the decoder stack. Returns (hidden [B,S,D], the cache|None);
    the cache's tensors are updated in place. With ``remat`` each block
    keeps only its input for the backward pass and runs again there.
    ``patches`` [B, P, frontend_dim] (``vit_stub``) replace the first P
    positions' embeddings as the reference concatenates them, so with
    fewer than P tokens the hidden state has P rows. ``frames`` [B, F,
    frontend_dim] (encoder-decoder) go through the encoder, and every
    cross-attention attends to its output and fills the cache's cross
    K/V, which must hold F rows; without frames, a decoder with a cache
    attends to the cross K/V that the cache holds. ``prompt_lengths`` [B]:
    the true lengths of right-padded prompt rows, which the Mamba layers
    need to keep pad steps out of their states (``mamba_apply``)."""
    check_supported(cfg)
    x = embed(tokens, params["embed"], scale_by_dim=cfg.embed_scale,
              compute_dtype=compute_dtype)
    if cfg.frontend == "vit_stub" and patches is not None:
        pt = patches.to(compute_dtype)
        if isinstance(x, DTensor):  # each rank projects its own rows only
            pt = _rows_like(pt, x)
        pe = matmul(pt, params["frontend_proj"]["w"].to(compute_dtype))
        x = torch.cat([pe, x[:, patches.shape[1]:]], dim=1)
        x = shard(x, "batch", "seq", "embed")
    enc_out = None
    if cfg.is_encdec and frames is not None:
        enc_out = _encode(params, frames, cfg, impl, compute_dtype)
    S = x.shape[1]
    if positions is None:
        positions = (torch.arange(S, device=x.device)
                     if lengths is None or S > 1 else (lengths - 1)[:, None])
    kw = dict(cfg=cfg, positions=positions, lengths=lengths, enc_out=enc_out,
              impl=impl, compute_dtype=compute_dtype,
              prompt_lengths=prompt_lengths)
    blocks = _unbind(params["blocks"], cfg.n_blocks)
    for blk in range(cfg.n_blocks):
        c = None if cache is None else _block(cache, blk)
        if remat:
            x = checkpoint(_block_body, x, blocks[blk], c, **kw)
        else:
            x = _block_body(x, blocks[blk], c, **kw)
    x = rms_norm(x, params["final_norm"], cfg.norm_eps,
                 cfg.zero_centered_norm)
    return x, cache


def _cross(sub, h: torch.Tensor, c, enc_out, cfg: ModelConfig,
           kw) -> torch.Tensor:
    """A decoder sub-layer's cross-attention: against ``enc_out``, whose
    K/V also fill the cache's cross K/V where there is a cache; with a
    cache and no ``enc_out``, against the cross K/V the cache holds. With
    neither, the reference's ``attn_apply(kv_x=None)`` runs a causal
    self-attention through the cross weights, and so does the port."""
    if c is None:
        return attn_apply(sub["cross"], h, cfg=cfg, kv_x=enc_out, **kw)[0]
    if enc_out is None:
        kv = {"k": c["cross_k"], "v": c["cross_v"]}
    else:
        if enc_out.shape[1] != c["cross_k"].shape[1]:
            raise ValueError(
                f"{cfg.name}: {enc_out.shape[1]} frames into a cache of "
                f"enc_len {c['cross_k'].shape[1]}: the cross K/V are filled "
                "in place, so enc_len must be the frame count")
        # attend to the fresh K/V in the compute dtype, as the reference
        # does, and keep them in the cache's dtype
        kv = init_cross_kv_cache(sub["cross"], enc_out, cfg,
                                 kw["compute_dtype"])
        c["cross_k"].copy_(kv["k"])
        c["cross_v"].copy_(kv["v"])
    return attn_apply(sub["cross"], h, cfg=cfg, kv_x=h, cache=kv, **kw)[0]


def _block_body(x: torch.Tensor, p_block, c_block, *, cfg: ModelConfig,
                positions, lengths, enc_out, impl,
                compute_dtype, prompt_lengths=None) -> torch.Tensor:
    """One block: every sub-layer of ``cfg.layer_pattern`` in turn."""
    zc, eps = cfg.zero_centered_norm, cfg.norm_eps
    kw = dict(impl=impl, compute_dtype=compute_dtype)
    for i, kind in enumerate(cfg.layer_pattern):
        sub = p_block[f"sub{i}"]
        c = None if c_block is None else c_block[f"sub{i}"]
        h = rms_norm(x, sub["ln1"], eps, zc)
        if kind in ("g", "l"):
            out, _ = attn_apply(sub["attn"], h, cfg=cfg, kind=kind,
                                positions=positions, cache=c,
                                lengths=lengths, **kw)
            if cfg.post_norms:
                out = rms_norm(out, sub["post_ln1"], eps, zc)
            x = x + out
            if cfg.is_encdec:
                h = rms_norm(x, sub["ln_cross"], eps, zc)
                x = x + _cross(sub, h, c, enc_out, cfg, kw)
        elif kind == "m":
            out, conv, ssm = mamba_apply(
                sub["mamba"], h, cfg,
                conv_state=None if c is None else c["conv"],
                ssm_state=None if c is None else c["ssm"],
                lengths=prompt_lengths, **kw)
            x = x + out
            if c is not None:
                _assign(c["conv"], conv)
                _assign(c["ssm"], ssm)
        else:
            out, shift_tm, wkv = time_mix(
                sub["rwkv"], h, cfg,
                shift_state=None if c is None else c["shift_tm"],
                wkv_state=None if c is None else c["wkv"], **kw)
            x = x + out
            h = rms_norm(x, sub["ln2"], eps, zc)
            out, shift_cm = channel_mix(
                sub["rwkv"], h, cfg,
                shift_state=None if c is None else c["shift_cm"],
                compute_dtype=compute_dtype)
            x = shard(x + out, "batch", "seq", "embed")
            if c is not None:
                _assign(c["shift_tm"], shift_tm)
                _assign(c["shift_cm"], shift_cm)
                _assign(c["wkv"], wkv)
            continue
        h = rms_norm(x, sub["ln2"], eps, zc)
        if _moe_static(cfg, i):
            out = moe_apply(sub["ffn"], h, cfg, compute_dtype)
        else:
            out = glu(h, sub["ffn"], cfg.act, compute_dtype)
        if cfg.post_norms and kind in ("g", "l"):
            out = rms_norm(out, sub["post_ln2"], eps, zc)
        x = shard(x + out, "batch", "seq", "embed")
    return x


def _assign(dst: torch.Tensor, src: torch.Tensor) -> None:
    """``dst.copy_(src)``; a DTensor ``src`` is first laid out as ``dst``."""
    if isinstance(dst, DTensor):
        src = src.redistribute(dst.device_mesh, dst.placements)
    dst.copy_(src)


def logits_head(params, cfg: ModelConfig, h: torch.Tensor,
                compute_dtype=torch.bfloat16) -> torch.Tensor:
    """fp32 logits with the final softcap; padded vocab rows are -1e30."""
    w = (params["embed"]["table"].T if cfg.tie_embeddings
         else params["lm_head"]["w"])
    logits = matmul(h.to(compute_dtype), w.to(compute_dtype)).float()
    if cfg.final_softcap > 0:
        logits = torch.tanh(logits / cfg.final_softcap) * cfg.final_softcap
    if cfg.padded_vocab != cfg.vocab:   # mask padding rows out of the softmax
        if isinstance(logits, DTensor):
            pad = torch.arange(cfg.padded_vocab, device=logits.device)
            logits = logits.masked_fill(pad >= cfg.vocab, -1e30)
        else:
            logits[..., cfg.vocab:] = -1e30
    return shard(logits, "batch", "act_seq", "vocab")


def loss_fn(params, batch: Dict[str, torch.Tensor], cfg: ModelConfig, *,
            remat: bool = True, impl: Optional[str] = None,
            compute_dtype=torch.bfloat16
            ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Next-token cross entropy, chunked ([B, S, V] never held). ``batch``:
    "tokens" [B, S], an optional "mask" [B, S] and the frontends' optional
    "frames" or "patches", tensors on the parameters' device. The labels
    are the tokens shifted left by one with a 0 at the end, whose position
    the mask drops. Returns (loss, {"loss_sum", "weight"})."""
    tokens = batch["tokens"]
    h, _ = forward(params, cfg, tokens=tokens, frames=batch.get("frames"),
                   patches=batch.get("patches"), remat=remat, impl=impl,
                   compute_dtype=compute_dtype)
    labels = torch.nn.functional.pad(tokens[:, 1:], (0, 1))
    mask = batch.get("mask")
    if mask is None:
        mask = torch.ones(tokens.shape, dtype=torch.float32,
                          device=tokens.device)
    mask = mask.float().clone()
    mask[:, -1] = 0.0
    w = (params["embed"]["table"].T if cfg.tie_embeddings
         else params["lm_head"]["w"])
    loss_sum, w_sum = chunked_softmax_xent(
        h, w, labels, mask=mask, final_softcap=cfg.final_softcap,
        valid_vocab=cfg.vocab, compute_dtype=compute_dtype)
    loss = loss_sum / torch.clamp(w_sum, min=1.0)
    return loss, {"loss_sum": loss_sum, "weight": w_sum}


def prefill(params, cfg: ModelConfig, tokens: torch.Tensor, cache, *,
            lengths: Optional[torch.Tensor] = None,
            frames: Optional[torch.Tensor] = None,
            patches: Optional[torch.Tensor] = None,
            impl: Optional[str] = None, compute_dtype=torch.bfloat16,
            exact_states: bool = False):
    """Fill the cache with S tokens; return (last-token logits, cache,
    lengths). ``lengths`` ([B] int32, optional) marks per-row true prompt
    lengths of right-padded rows: logits are gathered at each row's last
    valid position. With ``exact_states`` the Mamba layers' states are
    each row's at its length too (pad steps kept out: the serving
    engine's padded admission); without, they run over the whole padded
    row, as the JAX package's prefill does. ``frames`` and ``patches`` as
    in ``forward``."""
    B, S = tokens.shape
    h, cache = forward(params, cfg, tokens=tokens, cache=cache, frames=frames,
                       patches=patches, impl=impl,
                       compute_dtype=compute_dtype,
                       prompt_lengths=lengths if exact_states else None)
    if lengths is None:
        lengths = torch.full((B,), S, dtype=torch.int32, device=h.device)
        last = None
    else:
        lengths = lengths.to(device=h.device, dtype=torch.int32)
        last = (lengths - 1).clamp(0, S - 1).long()
    if isinstance(h, DTensor):   # each row's last position, on its rows
        h_last = _gather_rows(h, lengths.long() - 1 if last is None else last)
    elif last is None:
        h_last = h[:, -1:]
    else:
        h_last = h.gather(1, last[:, None, None].expand(B, 1, h.shape[-1]))
    return logits_head(params, cfg, h_last, compute_dtype), cache, lengths


def _gather_rows(h: DTensor, last: torch.Tensor) -> DTensor:
    """h [B, S, D] at each row's position ``last`` [B], on each rank's rows
    of h with its sequence whole."""
    mesh = h.device_mesh
    rows = tuple(p if p == Shard(0) else Replicate() for p in h.placements)
    idx = last[:, None, None].expand(h.shape[0], 1, h.shape[-1])
    return col.local_call(lambda a, i: a.gather(1, i), mesh, (h, idx),
                          (rows, rows), rows)


def decode_step(params, cfg: ModelConfig, tokens: torch.Tensor, cache,
                lengths: torch.Tensor, *, impl: Optional[str] = None,
                compute_dtype=torch.bfloat16):
    """One decode step. tokens [B,1]; lengths [B] = position+1 of the new
    token. Returns (logits [B,1,V], cache, lengths + 1)."""
    h, cache = forward(params, cfg, tokens=tokens, cache=cache,
                       lengths=lengths, impl=impl,
                       compute_dtype=compute_dtype)
    return logits_head(params, cfg, h, compute_dtype), cache, lengths + 1
