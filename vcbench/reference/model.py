"""Plain reference of the dense GQA decoder that the benchmark's
configurations run (Qwen2, and InternLM2 under InternVL2's image tokens):
RMSNorm, rotary embeddings (half split), grouped-query attention with
optional q/k/v biases, a SwiGLU feed-forward, an untied head; the
``vit_stub`` frontend as one linear projection of precomputed image
tokens that replace the first positions' embeddings; the next-token loss;
AdamW with decoupled weight decay, global-norm clipping and a linear
warm-up into a cosine schedule.

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
"""
from __future__ import annotations

import math
from typing import Any, Dict, Iterable, List, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

FP8_MAX = 448.0


def precise() -> None:
    """float32 products in float32: TF32 off."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")


def _fp8(x: torch.Tensor) -> torch.Tensor:
    s = x.detach().abs().amax().clamp(min=1e-30) / FP8_MAX
    q = (x.detach() / s).to(torch.float8_e4m3fn).to(torch.float32) * s
    return x + (q - x).detach()


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
            a, b = _fp8(a), _fp8(b)
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
            q, k, v = _fp8(q), _fp8(k), _fp8(v)
        s = (q @ k.transpose(-1, -2)) * self.hd ** -0.5
        mask = torch.ones(T, T, dtype=torch.bool, device=x.device).tril()
        p = torch.softmax(s.masked_fill(~mask, float("-inf")), -1)
        if self.fp8:
            p = _fp8(p)
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
                     patches: Optional[torch.Tensor]) -> torch.Tensor:
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


# ---------------------------------------------------------------- AdamW

def lr_at(opt: Dict[str, float], step: int) -> float:
    """Linear warm-up to ``peak_lr`` over ``warmup_steps``, then cosine
    decay to ``min_lr_ratio`` of it at ``total_steps``."""
    peak, warm = opt["peak_lr"], opt["warmup_steps"]
    if step < warm:
        return peak * step / max(1.0, warm)
    prog = min(max((step - warm) / max(1.0, opt["total_steps"] - warm), 0.0),
               1.0)
    r = opt["min_lr_ratio"]
    return peak * (r + (1 - r) * 0.5 * (1 + math.cos(math.pi * prog)))


def flat(tree: Dict[str, Any], prefix: Tuple[str, ...] = ()
         ) -> List[Tuple[Tuple[str, ...], torch.Tensor]]:
    out = []
    for k in sorted(tree):
        v = tree[k]
        if isinstance(v, dict):
            out += flat(v, prefix + (k,))
        else:
            out.append((prefix + (k,), v))
    return out


class AdamW:
    """The optimizer's state and update, float32 throughout."""

    def __init__(self, opt: Dict[str, float], params: Dict[str, Any]):
        self.o = opt
        self.leaves = flat(params)
        self.m = [torch.zeros_like(p) for _, p in self.leaves]
        self.v = [torch.zeros_like(p) for _, p in self.leaves]
        self.t = 0

    @torch.no_grad()
    def step(self, grads: List[torch.Tensor]) -> Tuple[float, float]:
        """Update the parameters in place; returns (the gradients' global
        norm before clipping, the clip scale)."""
        o = self.o
        self.t += 1
        norm = math.sqrt(sum(float((g.double() ** 2).sum()) for g in grads))
        scale = min(1.0, o["clip_norm"] / (norm + 1e-9))
        lr = lr_at(o, self.t)
        b1c, b2c = 1 - o["b1"] ** self.t, 1 - o["b2"] ** self.t
        for (_, p), g, m, v in zip(self.leaves, grads, self.m, self.v):
            g = g * scale
            m.mul_(o["b1"]).add_((1 - o["b1"]) * g)
            v.mul_(o["b2"]).add_((1 - o["b2"]) * g * g)
            delta = (m / b1c) / (torch.sqrt(v / b2c) + o["eps"])
            if p.ndim >= 2:
                delta = delta + o["weight_decay"] * p
            p.sub_(lr * delta)
        return norm, scale
