"""Plain reference of the dense GQA decoder that the benchmark's
configurations run (Qwen2, and InternLM2 under InternVL2's image tokens):
RMSNorm, rotary embeddings (half split), grouped-query attention with
optional q/k/v biases, a SwiGLU feed-forward, an untied head; the
``vit_stub`` frontend as one linear projection of precomputed image
tokens that replace the first positions' embeddings; the next-token loss.
With the weights' layout, the training inputs, the counts of operations
and bytes, and the engine's admission rule for the same configurations.

It follows the equations as the configurations state them, in float32
with TF32 off, one sequence (serving) or one row (training) at a time,
layer by layer, so that it fits beside the program's weights. Two
departures are the program's conventions, kept on purpose: weight decay
falls on every leaf of two or more dimensions, which with the layers
stacked on a leading axis takes in the norm scales and biases (the JAX
package's rule); and the logits of the padded vocabulary rows are left
out of every softmax.

``precision="fp8"`` is the control: every product's operands are rounded
to float8 e4m3 (a scale per tensor), gradients passed straight through.
It stands where a later change might put an fp8 path, and it has to fail
the comparison.

**A configuration's reference module.** A configuration file names its
module with ``"reference": "<path from the checkout>"``; without the key
it is this file. The harness loads it by its path
(``harness/manifest.py:reference``) and reaches the architecture only
through it. A module supplies:

- ``unsupported(model)``: None where it covers the configuration's
  ``model`` block, else what it lacks; the harness then stops at set-up
  with an error that names the configuration and its ``reference``.
- ``leaves(model)``: (path, shape, kind, stddev) of every weight in the
  program's layout (nested dicts, dense ``w`` as [in, out], the layers
  stacked on a leading axis under ``"blocks"``), in a fixed order. Kinds:
  "matrix" (the compute dtype), "bias" and "norm" (float32). The harness
  makes leaf ``i`` from (seed, ``i``), so the order is part of the
  weights.
- ``inputs(model, rows, gen, device)``: a training batch's inputs besides
  its token ids, under the program's keys, each with a leading row axis,
  drawn from ``gen`` after the tokens (``{}`` for text alone).
- ``Ref(model, precision)``, ``precision`` "fp32" or "fp8" (the control),
  with ``hidden(weights, seqs)`` (the final hidden states of each token
  sequence), ``head_w(weights)`` (the head over the valid vocabulary),
  ``logits(hw, h)`` (float32 logits, in chunks of rows) and
  ``row_loss_sum(weights, tokens, **row_inputs)`` (one row's summed
  next-token loss, differentiable; ``row_inputs``: that row of each of
  ``inputs``).
- The counts that the per-layer metrics read through ``RunData.flops``:
  ``num_params``, ``matmul_params``, ``model_flops_for``,
  ``prefill_flops``, ``decode_flops``, ``attention_bound_s`` and
  ``decode_attention_bound_s``. The two bounds take ``bound(ops,
  nbytes)``, the least time on the chip, which the harness supplies
  (``harness/flops.py``, with the chip's peaks) and binds.
- ``exact_admission(model)``: whether the engine admits every prompt at
  its exact length and eagerly (recurrent state folds pad tokens in), not
  padded to a power-of-two bucket whose calls are graphed once met.

What every architecture shares (``precise``, ``fp8``, ``padded_vocab``,
``flat``, ``AdamW``, ``lr_at``) is in ``reference/common.py``, re-exported
here. A new architecture adds files alone: its configuration (with
``"reference"``), its module, a mix and a limits file per cell, and
their entries in ``BENCHMARK.json``.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, Iterable, List, Optional, Sequence, \
    Tuple

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from reference.common import (AdamW, flat, fp8, lr_at,  # noqa: F401
                              padded_vocab, precise)

Leaf = Tuple[Tuple[str, ...], Tuple[int, ...], str, float]
BF16 = 2                    # bytes of a served weight, activation or cache


def unsupported(model: Dict[str, Any]) -> Optional[str]:
    """What of ``model`` this module does not cover, or None."""
    pattern = model.get("layer_pattern", "g")
    if pattern != "g":
        return f"layer_pattern {pattern!r} (dense 'g' decoders only)"
    if model.get("n_experts", 0):
        return f"n_experts {model['n_experts']} (no mixture of experts)"
    if model.get("frontend") not in (None, "vit_stub"):
        return f"frontend {model['frontend']!r}"
    return None


def exact_admission(model: Dict[str, Any]) -> bool:
    """False: attention layers keep no recurrent state, so the engine pads
    each prompt to its bucket and graphs a bucket's calls once met."""
    return False


# ---------------------------------------------------------------- weights

def leaves(model: Dict[str, Any]) -> List[Leaf]:
    """(path, shape, kind, stddev) of every leaf, in a fixed order. Kinds:
    "matrix" (the compute dtype), "bias" and "norm" (float32)."""
    d, L = model["d_model"], model["n_layers"]
    H, KV, hd = model["n_heads"], model["n_kv_heads"], model["head_dim"]
    dff, V = model["d_ff"], padded_vocab(model["vocab"])
    if model.get("layer_pattern", "g") != "g" or model.get("n_experts", 0):
        raise NotImplementedError("the benchmark's weights cover dense 'g' "
                                  "decoders only")
    out: List[Leaf] = [(("embed", "table"), (V, d), "matrix", 1.0),
                       (("final_norm",), (d,), "norm", 0.1)]
    if not model.get("tie_embeddings", False):
        out.append((("lm_head", "w"), (d, V), "matrix", d ** -0.5))
    sub = ("blocks", "sub0")
    out.append((sub + ("ln1",), (L, d), "norm", 0.1))
    for name, width in (("wq", H * hd), ("wk", KV * hd), ("wv", KV * hd)):
        out.append((sub + ("attn", name, "w"), (L, d, width), "matrix",
                    d ** -0.5))
        if model.get("qkv_bias", False):
            out.append((sub + ("attn", name, "b"), (L, width), "bias", 0.05))
    out.append((sub + ("attn", "wo", "w"), (L, H * hd, d), "matrix",
                (H * hd) ** -0.5))
    out.append((sub + ("ln2",), (L, d), "norm", 0.1))
    for name in ("wi", "wg"):
        out.append((sub + ("ffn", name, "w"), (L, d, dff), "matrix",
                    d ** -0.5))
    out.append((sub + ("ffn", "wo", "w"), (L, dff, d), "matrix",
                dff ** -0.5))
    if model.get("frontend") == "vit_stub":
        fd = model["frontend_dim"]
        out.append((("frontend_proj", "w"), (fd, d), "matrix", fd ** -0.5))
    return out


def inputs(model: Dict[str, Any], rows: int, gen: torch.Generator,
           device: torch.device) -> Dict[str, torch.Tensor]:
    """``vit_stub``: standard-normal image tokens, ``patches`` [rows,
    frontend_tokens, frontend_dim]; a text model takes none."""
    if model.get("frontend") != "vit_stub":
        return {}
    return {"patches": torch.randn(
        (rows, model["frontend_tokens"], model["frontend_dim"]),
        generator=gen, device=device, dtype=torch.float32)}


# ---------------------------------------------------------------- counts
#
# Copies of ``src/repro_torch/models/config.py:ModelConfig.num_params`` /
# ``num_active_params`` and ``src/repro_torch/roofline/analysis.py:
# model_flops_for``, reading the configuration's ``model`` block (a dict)
# instead of a ``ModelConfig``, frozen so that a change to the program
# cannot move the yardstick. The per-call counts (``prefill_flops``,
# ``decode_flops``, the kernels' bounds) count live tokens only: no
# padding of a prompt to its bucket and no inactive slot. Each input byte
# is read once and each output byte written once.

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


def attention_bound_s(m: Dict[str, Any], lengths: Sequence[int],
                      bound: Callable[[float, float], float]) -> float:
    """Least time of the ``flash_attention`` launches of one admit call
    (one a layer), bf16: causal pairs at the peak, or q, k, v and the
    output of the live tokens at the bandwidth, whichever is longer."""
    H, KV, hd, L = m["n_heads"], m["n_kv_heads"], m["head_dim"], \
        m["n_layers"]
    pairs = sum(_causal_pairs(n) for n in lengths)
    return L * bound(4.0 * H * hd * pairs,
                     sum(lengths) * (2 * H + 2 * KV) * hd * BF16)


def decode_attention_bound_s(m: Dict[str, Any], n_active: int, ctx_sum: int,
                             bound: Callable[[float, float], float]) -> float:
    """Least time of one step's ``flash_decode`` launches (one a layer):
    the live slots' K and V read once, q read and the output written."""
    H, KV, hd, L = m["n_heads"], m["n_kv_heads"], m["head_dim"], \
        m["n_layers"]
    nbytes = ctx_sum * 2 * KV * hd * BF16 + n_active * 2 * H * hd * BF16
    return L * bound(4.0 * H * hd * ctx_sum, nbytes)


# ---------------------------------------------------------------- reference

class Ref:
    """The reference for one configuration's ``model`` block."""

    def __init__(self, model: Dict[str, Any], precision: str = "fp32"):
        if precision not in ("fp32", "fp8"):
            raise ValueError(precision)
        self.m = model
        self.fp8 = precision == "fp8"
        self.d = model["d_model"]
        self.H, self.KV = model["n_heads"], model["n_kv_heads"]
        self.hd = model["head_dim"]
        self.V = model["vocab"]
        self.eps = float(model["norm_eps"])
        self.theta = float(model.get("rope_theta", 1e4))

    # -- pieces -------------------------------------------------------------

    def mm(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        if self.fp8:
            a, b = fp8(a), fp8(b)
        return a @ b

    def norm(self, x: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
        return x * torch.rsqrt((x * x).mean(-1, keepdim=True) + self.eps) \
            * scale

    def rope(self, x: torch.Tensor, pos: torch.Tensor) -> torch.Tensor:
        """x [..., T, heads, hd] at positions pos [T]."""
        half = self.hd // 2
        freqs = self.theta ** (-torch.arange(half, dtype=torch.float32,
                                             device=x.device) / half)
        ang = pos.float()[:, None] * freqs              # [T, half]
        cos, sin = torch.cos(ang)[:, None], torch.sin(ang)[:, None]
        x1, x2 = x[..., :half], x[..., half:]
        return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], -1)

    def attention(self, x: torch.Tensor, w: Dict[str, Any]) -> torch.Tensor:
        """Causal GQA self-attention of x [T, d] (one sequence)."""
        T = x.shape[0]
        pos = torch.arange(T, device=x.device)

        def proj(name, heads):
            y = self.mm(x, w[name]["w"])
            if "b" in w[name]:
                y = y + w[name]["b"]
            return y.view(T, heads, self.hd)

        q = self.rope(proj("wq", self.H), pos)
        k = self.rope(proj("wk", self.KV), pos)
        v = proj("wv", self.KV)
        g = self.H // self.KV
        q = q.view(T, self.KV, g, self.hd).permute(1, 2, 0, 3)  # [KV,g,T,hd]
        k = k.permute(1, 0, 2)[:, None]                         # [KV,1,T,hd]
        v = v.permute(1, 0, 2)[:, None]
        if self.fp8:
            q, k, v = fp8(q), fp8(k), fp8(v)
        s = (q @ k.transpose(-1, -2)) * self.hd ** -0.5
        mask = torch.ones(T, T, dtype=torch.bool, device=x.device).tril()
        p = torch.softmax(s.masked_fill(~mask, float("-inf")), -1)
        if self.fp8:
            p = fp8(p)
        o = (p @ v).permute(2, 0, 1, 3).reshape(T, self.H * self.hd)
        return self.mm(o, w["wo"]["w"])

    def block(self, x: torch.Tensor, w: Dict[str, Any]) -> torch.Tensor:
        x = x + self.attention(self.norm(x, w["ln1"]), w["attn"])
        h = self.norm(x, w["ln2"])
        f = w["ffn"]
        a = F.silu(self.mm(h, f["wg"]["w"])) * self.mm(h, f["wi"]["w"])
        return x + self.mm(a, f["wo"]["w"])

    def embed(self, w: Dict[str, Any], tokens: torch.Tensor,
              patches: Optional[torch.Tensor] = None) -> torch.Tensor:
        x = w["embed"]["table"][tokens.long()].float()
        if patches is not None:
            pe = self.mm(patches.float(), w["frontend_proj"]["w"].float())
            x = torch.cat([pe, x[patches.shape[0]:]], 0)
        return x

    def head_w(self, w: Dict[str, Any]) -> torch.Tensor:
        if self.m.get("tie_embeddings", False):
            return w["embed"]["table"][:self.V].float().T
        return w["lm_head"]["w"][:, :self.V].float()

    # -- serving: teacher-forced logits -------------------------------------

    @torch.no_grad()
    def hidden(self, weights: Dict[str, Any],
               seqs: Sequence[torch.Tensor]) -> List[torch.Tensor]:
        """The final hidden states [T_i, d] of each token sequence, layer by
        layer: one layer's weights in float32 at a time."""
        hs = [self.embed(weights, s) for s in seqs]
        blocks = weights["blocks"]["sub0"]
        for layer in range(self.m["n_layers"]):
            w = _layer(blocks, layer)
            hs = [self.block(h, w) for h in hs]
            del w
        fn = weights["final_norm"].float()
        return [self.norm(h, fn) for h in hs]

    @torch.no_grad()
    def logits(self, hw: torch.Tensor, h: torch.Tensor,
               chunk: int = 512) -> Iterable[torch.Tensor]:
        """float32 logits over the valid vocabulary (``hw``: ``head_w``),
        ``chunk`` rows at a time."""
        for r0 in range(0, h.shape[0], chunk):
            yield self.mm(h[r0:r0 + chunk], hw)

    # -- training ----------------------------------------------------------

    def row_loss_sum(self, w: Dict[str, Any], tokens: torch.Tensor,
                     patches: Optional[torch.Tensor] = None
                     ) -> torch.Tensor:
        """Sum over positions of one row's next-token loss (the last
        position has no label); each layer and each logits chunk is
        recomputed in the backward pass."""
        x = self.embed(w, tokens, patches)
        blocks = w["blocks"]["sub0"]
        for layer in range(self.m["n_layers"]):
            x = checkpoint(self._layer_call, x, blocks, layer,
                           use_reentrant=False)
        x = self.norm(x, w["final_norm"])
        labels = tokens[1:].long()
        hw = self.head_w(w)
        total = x.new_zeros(())
        for r0 in range(0, labels.shape[0], 1024):
            total = total + checkpoint(self._xent, x[r0:r0 + 1024][
                :labels[r0:r0 + 1024].shape[0]], hw, labels[r0:r0 + 1024],
                use_reentrant=False)
        return total

    def _layer_call(self, x, blocks, layer):
        return self.block(x, _layer(blocks, layer))

    def _xent(self, h, hw, labels):
        logits = self.mm(h, hw)
        return (torch.logsumexp(logits, -1)
                - logits.gather(-1, labels[:, None])[:, 0]).sum()


def _layer(blocks: Dict[str, Any], layer: int) -> Dict[str, Any]:
    """Layer ``layer`` of the stacked block tree, in float32."""
    if isinstance(blocks, dict):
        return {k: _layer(v, layer) for k, v in blocks.items()}
    return blocks[layer].float()


