"""The benchmark's own count of operations and bytes, and the chip's peaks.

Frozen here so that a later change to the program cannot move the
yardstick. ``num_params`` and ``model_flops_for`` are copies of
``src/repro_torch/models/config.py:ModelConfig.num_params`` /
``num_active_params`` and ``src/repro_torch/roofline/analysis.py:
model_flops_for``, reading the configuration's ``model`` block (a
dict) instead of a ``ModelConfig``; the peaks are those of
``roofline/analysis.py`` (NVIDIA's H100 SXM data sheet, dense rates).

The per-call counts (``prefill_flops``, ``decode_flops``, the kernels'
bounds) count live tokens only: no padding of a prompt to its bucket and
no inactive slot. Each input byte is read once and each output byte
written once.
"""
from __future__ import annotations

from typing import Any, Dict, Sequence

PEAK_BF16 = 989e12          # FLOP/s, dense
HBM_BW = 3.35e12            # bytes/s
BF16 = 2                    # bytes


def _kind(m: Dict[str, Any], i: int) -> str:
    pat = m.get("layer_pattern", "g")
    return pat[i % len(pat)]


def num_params(m: Dict[str, Any]) -> int:
    """Copy of ``ModelConfig.num_params`` (dense and attention layers; the
    frontend projection is not counted, as there)."""
    d, dff, v, hd = m["d_model"], m["d_ff"], m["vocab"], m["head_dim"]
    H, KV = m["n_heads"], m["n_kv_heads"]
    n = v * d * (1 if m.get("tie_embeddings", False) else 2)
    for i in range(m["n_layers"]):
        if _kind(m, i) not in ("g", "l"):
            raise NotImplementedError("attention layers only")
        n += d * hd * (H + 2 * KV) + H * hd * d + 3 * d * dff
    return int(n)


def model_flops_for(m: Dict[str, Any], seq_len: int, global_batch: int,
                    mode: str) -> float:
    """Copy of ``roofline/analysis.py:model_flops_for`` for a dense
    decoder: 6 N D (+3x attention) for training, 2 N D (+1x) otherwise."""
    n_active = num_params(m)
    B, S = global_batch, seq_len
    H, hd = m["n_heads"], m["head_dim"]
    attn = 0.0
    for i in range(m["n_layers"]):
        kind = _kind(m, i)
        if mode == "decode":
            ctx = S if kind == "g" else min(S, m.get("sliding_window", 4096))
            attn += 2.0 * 2.0 * B * ctx * H * hd
        else:
            ctx = S / 2 if kind == "g" else min(S, m.get("sliding_window",
                                                         4096))
            attn += 2.0 * 2.0 * B * S * ctx * H * hd
    tokens = B * S
    if mode == "train":
        return 6.0 * n_active * tokens + 3.0 * attn
    if mode == "prefill":
        return 2.0 * n_active * tokens + attn
    return 2.0 * n_active * global_batch + attn


def matmul_params(m: Dict[str, Any]) -> int:
    """Parameters a token multiplies by outside the embedding and head."""
    d, dff, hd = m["d_model"], m["d_ff"], m["head_dim"]
    H, KV = m["n_heads"], m["n_kv_heads"]
    return m["n_layers"] * (d * hd * (H + 2 * KV) + H * hd * d + 3 * d * dff)


def _causal_pairs(n: int) -> int:
    return n * (n + 1) // 2


def prefill_flops(m: Dict[str, Any], lengths: Sequence[int]) -> float:
    """One admit call over prompts of these true lengths: the products of
    every prompt token, causal attention, and the head at each prompt's
    last position (the only logits a prefill computes)."""
    H, hd, L = m["n_heads"], m["head_dim"], m["n_layers"]
    toks = sum(lengths)
    pairs = sum(_causal_pairs(n) for n in lengths)
    return (2.0 * matmul_params(m) * toks + 4.0 * H * hd * pairs * L
            + 2.0 * m["d_model"] * m["vocab"] * len(lengths))


def decode_flops(m: Dict[str, Any], n_active: int, ctx_sum: int) -> float:
    """One decode step of ``n_active`` live slots whose contexts (the new
    token included) sum to ``ctx_sum``."""
    H, hd, L = m["n_heads"], m["head_dim"], m["n_layers"]
    return ((2.0 * matmul_params(m) + 2.0 * m["d_model"] * m["vocab"])
            * n_active + 4.0 * H * hd * ctx_sum * L)


def _bound(flops: float, nbytes: float) -> float:
    return max(flops / PEAK_BF16, nbytes / HBM_BW)


def attention_bound_s(m: Dict[str, Any], lengths: Sequence[int]) -> float:
    """Least time of the ``flash_attention`` launches of one admit call
    (one a layer), bf16: causal pairs at the peak, or q, k, v and the
    output of the live tokens at the bandwidth, whichever is longer."""
    H, KV, hd, L = m["n_heads"], m["n_kv_heads"], m["head_dim"], \
        m["n_layers"]
    pairs = sum(_causal_pairs(n) for n in lengths)
    return L * _bound(4.0 * H * hd * pairs,
                      sum(lengths) * (2 * H + 2 * KV) * hd * BF16)


def decode_attention_bound_s(m: Dict[str, Any], n_active: int,
                             ctx_sum: int) -> float:
    """Least time of one step's ``flash_decode`` launches (one a layer):
    the live slots' K and V read once, q read and the output written."""
    H, KV, hd, L = m["n_heads"], m["n_kv_heads"], m["head_dim"], \
        m["n_layers"]
    nbytes = ctx_sum * 2 * KV * hd * BF16 + n_active * 2 * H * hd * BF16
    return L * _bound(4.0 * H * hd * ctx_sum, nbytes)
