"""Plain reference of AI21-Jamba2-Mini's published block (HF
``transformers/models/jamba/modeling_jamba.py``, ``model_type`` "jamba"),
for configurations of Mamba ("m") and attention ("g") layers with a
SwiGLU feed-forward or a sparse expert layer after each:

- every layer: pre-norm residual, RMSNorm (``JambaRMSNorm``) before the
  mixer and before the feed-forward;
- Mamba-1 mixer (``JambaMambaMixer``): ``in_proj`` to (x, z); a causal
  depthwise convolution with bias, silu; ``x_proj`` to (dt, B, C), each
  RMS-normalised with its learned scale (``dt_layernorm``, ``b_layernorm``,
  ``c_layernorm``); dt = softplus(``dt_proj``(dt) + its bias); the
  selective scan h_t = exp(dt_t A) h_{t-1} + dt_t B_t x_t, y_t = C_t h_t +
  D x_t, with A = -exp(A_log); gate silu(z); ``out_proj``;
- attention (``JambaAttention``): grouped-query, causal, no positional
  encoding, scale head_dim ** -0.5;
- expert layer (``JambaSparseMoeBlock``): the softmax of the router's
  logits, its top-k taken as they are (not renormalised), every routed
  (token, expert) pair computed (no capacity, nothing dropped), the
  experts' SwiGLU outputs summed with those weights;
- dense layers (``JambaMLP``): SwiGLU of ``intermediate_size``; a final
  RMSNorm and an untied head.

It follows the equations in float32 with TF32 off (``common.precise``),
with no kernel, no cache and no batching across requests in what it
computes: the token-wise products run over all the sequences' tokens at
once, the convolution, the scan and the attention over each sequence
alone (shorter sequences are zero-padded behind their end, which no
causal position reads). The scan goes through time in chunks of
``SCAN_CHUNK`` steps, the decays and inputs of a chunk computed at once
and the state carried from step to step, and chunk to chunk, in float32.
It is written from the published equations, not from the program's scan.

Departures from the published model (the first two the program's too):

- the published layer computes the router in the model's dtype and casts
  the top-k weights to it; here all is float32 (``precision="fp8"`` is the
  control, every product's operands rounded to float8 e4m3 as in
  ``model.py``);
- the weights are random, from the run's seed (``leaves``); dt, A and the
  router follow the harness's two float32 kinds (``"bias"``: normal of
  zero mean, ``"norm"``: normal about 1), not the published initialisation
  (dt in [0.001, 0.1], A = -[1..16]), which needs means the kinds cannot
  give. A_log is N(0, 0.5^2) (A from -0.22 to -4.5 at three sigma) and the
  time step's pre-activation about N(0, 0.52^2) (dt from 0.19 to 1.75):
  each step decays the state by exp(dt A), 0.50 at the median;
- no training: a configuration of this module has no training cell, so
  ``inputs`` and ``Ref.row_loss_sum`` raise.

The program departs once more: its scan (like the JAX package's) clamps
dt A to [-5, -1e-8]; the published model does not, nor does this module.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, Iterable, List, Optional, Sequence, \
    Tuple

import torch
import torch.nn.functional as F

from reference.common import fp8, padded_vocab

Leaf = Tuple[Tuple[str, ...], Tuple[int, ...], str, float]
BF16 = 2                    # bytes of a served weight, activation or cache
FP32 = 4                    # bytes of the scan's operands and state
SCAN_CHUNK = 16             # steps of the reference's scan computed at once
SCAN_TOKENS = 16384         # padded tokens of one group of sequences
SCAN_ROWS = 64              # sequences of one group at most
ROWS = 8192                 # rows of one block of the token-wise products
A_LOG_STD = 0.5             # A = -exp(N(0, A_LOG_STD^2))
DT_PROJ_STD = 0.5           # dt_proj.w: DT_PROJ_STD / sqrt(dt_rank)
DT_BIAS_STD = 0.1


def _dims(m: Dict[str, Any]) -> Dict[str, int]:
    d = m["d_model"]
    return {"d": d, "di": m.get("mamba_expand", 2) * d,
            "n": m.get("mamba_d_state", 16), "dc": m.get("mamba_d_conv", 4),
            "dtr": m.get("mamba_dt_rank", 0) or max(1, d // 16),
            "H": m["n_heads"], "KV": m["n_kv_heads"], "hd": m["head_dim"],
            "E": m.get("n_experts", 0), "k": m.get("top_k", 0),
            "f": m.get("d_ff_expert", 0), "dff": m["d_ff"],
            "V": m["vocab"], "nb": m["n_layers"] // len(m["layer_pattern"])}


def _is_moe(m: Dict[str, Any], i: int) -> bool:
    """Whether sub-layer ``i`` of the pattern has the expert layer (the
    program's ``i % moe_every == moe_offset``)."""
    return bool(m.get("n_experts", 0)) and \
        i % m.get("moe_every", 1) == m.get("moe_offset", 0)


def unsupported(model: Dict[str, Any]) -> Optional[str]:
    """What of ``model`` this module does not cover, or None."""
    pat = model.get("layer_pattern", "g")
    E, k = model.get("n_experts", 0), model.get("top_k", 0)
    if set(pat) - {"m", "g"} or "m" not in pat:
        return (f"layer_pattern {pat!r} (Mamba 'm' with attention 'g' "
                f"layers; a dense decoder takes model.py)")
    if model["n_layers"] % len(pat):
        return f"n_layers {model['n_layers']} (whole periods of {pat!r})"
    if not model.get("mamba_inner_norms", False):
        return ("mamba_inner_norms false (the published mixer normalises "
                "dt, B and C)")
    if model.get("use_rope", True):
        return "use_rope true (Jamba's attention has no positional encoding)"
    if E and model.get("router_renorm", True):
        return "router_renorm true (the published top-k is not renormalised)"
    if E and (len(pat) % model.get("moe_every", 1) or not 0 < k <= E):
        return f"moe_every {model.get('moe_every')} / top_k {k}"
    if E and model.get("capacity_factor", 1.25) * k < E:
        return (f"capacity_factor {model.get('capacity_factor', 1.25)} below "
                f"n_experts / top_k (the published layer drops no token)")
    for key in ("qkv_bias", "post_norms", "zero_centered_norm",
                "embed_scale", "frontend", "n_enc_layers", "attn_softcap",
                "final_softcap"):
        if model.get(key):
            return f"{key} {model[key]!r}"
    if model.get("act", "silu") != "silu":
        return f"act {model['act']!r}"
    return None


def exact_admission(model: Dict[str, Any]) -> bool:
    """False: the engine pads prompts to its power-of-two buckets (a CUDA
    graph a (rows, bucket) shape), as for attention-only models; the
    Mamba layers get the true lengths and keep pad steps out of their
    states."""
    return False


# ---------------------------------------------------------------- weights

def leaves(model: Dict[str, Any]) -> List[Leaf]:
    """(path, shape, kind, stddev) of every leaf in the program's layout
    (``repro_torch.models.transformer.param_specs``: sub-layer ``sub{i}``
    of the pattern, stacked over the blocks on a leading axis), in a
    fixed order. Kinds: "matrix" (the compute dtype); "bias" (float32,
    normal of zero mean: biases, and every leaf the program keeps in
    float32, the convolution, ``dt_proj``, ``A_log`` and the router) and
    "norm" (float32, normal about 1: norm scales and D)."""
    x = _dims(model)
    d, di, n, dc, dtr = x["d"], x["di"], x["n"], x["dc"], x["dtr"]
    H, KV, hd, E, f, dff, nb = x["H"], x["KV"], x["hd"], x["E"], x["f"], \
        x["dff"], x["nb"]
    V = padded_vocab(x["V"])
    out: List[Leaf] = [(("embed", "table"), (V, d), "matrix", 1.0),
                       (("final_norm",), (d,), "norm", 0.1)]
    if not model.get("tie_embeddings", False):
        out.append((("lm_head", "w"), (d, V), "matrix", d ** -0.5))
    for i, kind in enumerate(model["layer_pattern"]):
        sub = ("blocks", f"sub{i}")
        out.append((sub + ("ln1",), (nb, d), "norm", 0.1))
        if kind == "m":
            mx = sub + ("mamba",)
            out += [
                (mx + ("in_proj", "w"), (nb, d, 2 * di), "matrix", d ** -0.5),
                (mx + ("conv_w",), (nb, dc, di), "bias", dc ** -0.5),
                (mx + ("conv_b",), (nb, di), "bias", 0.05),
                (mx + ("x_proj", "w"), (nb, di, dtr + 2 * n), "matrix",
                 di ** -0.5),
                (mx + ("dt_norm",), (nb, dtr), "norm", 0.1),
                (mx + ("b_norm",), (nb, n), "norm", 0.1),
                (mx + ("c_norm",), (nb, n), "norm", 0.1),
                (mx + ("dt_proj", "w"), (nb, dtr, di), "bias",
                 DT_PROJ_STD * dtr ** -0.5),
                (mx + ("dt_proj", "b"), (nb, di), "bias", DT_BIAS_STD),
                (mx + ("A_log",), (nb, di, n), "bias", A_LOG_STD),
                (mx + ("D",), (nb, di), "norm", 0.1),
                (mx + ("out_proj", "w"), (nb, di, d), "matrix", di ** -0.5)]
        else:
            at = sub + ("attn",)
            for name, width in (("wq", H * hd), ("wk", KV * hd),
                                ("wv", KV * hd)):
                out.append((at + (name, "w"), (nb, d, width), "matrix",
                            d ** -0.5))
            out.append((at + ("wo", "w"), (nb, H * hd, d), "matrix",
                        (H * hd) ** -0.5))
        out.append((sub + ("ln2",), (nb, d), "norm", 0.1))
        ff = sub + ("ffn",)
        if _is_moe(model, i):
            out += [(ff + ("router",), (nb, d, E), "bias", d ** -0.5),
                    (ff + ("w1",), (nb, E, d, f), "matrix", d ** -0.5),
                    (ff + ("wg",), (nb, E, d, f), "matrix", d ** -0.5),
                    (ff + ("w2",), (nb, E, f, d), "matrix", f ** -0.5)]
        else:
            for name in ("wi", "wg"):
                out.append((ff + (name, "w"), (nb, d, dff), "matrix",
                            d ** -0.5))
            out.append((ff + ("wo", "w"), (nb, dff, d), "matrix",
                        dff ** -0.5))
    return out


def _no_training(model: Dict[str, Any]) -> NotImplementedError:
    return NotImplementedError(
        f"configuration {model.get('name')!r}: vcbench/reference/jamba.py "
        f"serves only; no cell trains it")


def inputs(model: Dict[str, Any], rows: int, gen: torch.Generator,
           device: torch.device) -> Dict[str, torch.Tensor]:
    raise _no_training(model)


# ---------------------------------------------------------------- counts
#
# Counts of what a token needs, read by the per-layer metrics through
# ``RunData.flops``. An expert layer counts the router and the top-k
# experts a token is routed to (not the program's capacity buffer, which
# runs every expert over a buffer of all the call's tokens); a Mamba
# layer its four products, the convolution and the scan's recurrence
# (``scan_ops``). Live tokens only: no inactive slot. Each input byte is
# read once and each output byte written once.

SCAN_OPS = (7, 3)           # fp32 operations a (token, channel, state):
#   dt A, exp, x dt B, decay h, + , C h, the sum over states; and a
#   (token, channel): dt x, D x, + .


def _kinds(m: Dict[str, Any]) -> List[Tuple[str, bool]]:
    pat = m["layer_pattern"]
    return [(pat[i % len(pat)], _is_moe(m, i % len(pat)))
            for i in range(m["n_layers"])]


def _layer_params(m: Dict[str, Any], kind: str, moe: bool,
                  routed: bool) -> int:
    """Weights of one layer a token multiplies by (``routed``: its top-k
    experts only, else every expert), norms, biases, conv, A and D
    included where ``routed`` is False."""
    x = _dims(m)
    d, di, n, dtr = x["d"], x["di"], x["n"], x["dtr"]
    if kind == "m":
        p = d * 2 * di + di * (dtr + 2 * n) + dtr * di + di * d
        if not routed:
            p += di * (x["dc"] + 1 + 1 + n + 1) + dtr + 2 * n
    else:
        p = d * x["hd"] * (x["H"] + 2 * x["KV"]) + x["H"] * x["hd"] * d
    if moe:
        p += d * x["E"] + (x["k"] if routed else x["E"]) * 3 * d * x["f"]
    else:
        p += 3 * d * x["dff"]
    return p + (0 if routed else 2 * d)


def num_params(m: Dict[str, Any]) -> int:
    """Every weight: embedding and head, each layer's (all experts), the
    norms."""
    n = m["vocab"] * m["d_model"] * (1 if m.get("tie_embeddings") else 2)
    n += m["d_model"]
    return int(n + sum(_layer_params(m, k, moe, False)
                       for k, moe in _kinds(m)))


def matmul_params(m: Dict[str, Any]) -> int:
    """Weights a token multiplies by outside the embedding and the head:
    the router and its top-k experts in an expert layer."""
    return int(sum(_layer_params(m, k, moe, True) for k, moe in _kinds(m)))


def _n_kind(m: Dict[str, Any], kind: str) -> int:
    return sum(1 for k, _ in _kinds(m) if k == kind)


def _token_extra(m: Dict[str, Any]) -> float:
    """A token's operations outside the products: the convolution and the
    scan of each Mamba layer."""
    x = _dims(m)
    per = 2 * x["dc"] * x["di"] + x["di"] * (SCAN_OPS[0] * x["n"]
                                             + SCAN_OPS[1])
    return float(per * _n_kind(m, "m"))


def model_flops_for(m: Dict[str, Any], seq_len: int, global_batch: int,
                    mode: str) -> float:
    """6 N D (training) or 2 N D with N the routed weights and the
    embedding and head, plus the attention layers' pairs (3x for
    training) and the Mamba layers' scans."""
    tokens = seq_len * global_batch
    n = matmul_params(m) + 2 * m["d_model"] * m["vocab"]
    H, hd, S = m["n_heads"], m["head_dim"], seq_len
    ctx = S if mode == "decode" else S / 2
    per_seq = S if mode != "decode" else 1
    attn = 4.0 * global_batch * per_seq * ctx * H * hd * _n_kind(m, "g")
    extra = _token_extra(m) * (global_batch if mode == "decode" else tokens)
    if mode == "train":
        return 6.0 * n * tokens + 3.0 * (attn + extra)
    if mode == "prefill":
        return 2.0 * n * tokens + attn + extra
    return 2.0 * n * global_batch + attn + extra


def _causal_pairs(n: int) -> int:
    return n * (n + 1) // 2


def prefill_flops(m: Dict[str, Any], lengths: Sequence[int]) -> float:
    """One admit call over prompts of these true lengths: every prompt
    token's routed products, convolution and scan, causal attention in
    the attention layers, and the head at each prompt's last position."""
    H, hd = m["n_heads"], m["head_dim"]
    toks = sum(lengths)
    pairs = sum(_causal_pairs(n) for n in lengths)
    return ((2.0 * matmul_params(m) + _token_extra(m)) * toks
            + 4.0 * H * hd * pairs * _n_kind(m, "g")
            + 2.0 * m["d_model"] * m["vocab"] * len(lengths))


def decode_flops(m: Dict[str, Any], n_active: int, ctx_sum: int) -> float:
    """One decode step of ``n_active`` live slots whose contexts (the new
    token included) sum to ``ctx_sum``."""
    H, hd = m["n_heads"], m["head_dim"]
    return ((2.0 * matmul_params(m) + _token_extra(m)
             + 2.0 * m["d_model"] * m["vocab"]) * n_active
            + 4.0 * H * hd * ctx_sum * _n_kind(m, "g"))


def attention_bound_s(m: Dict[str, Any], lengths: Sequence[int],
                      bound: Callable[[float, float], float]) -> float:
    """Least time of one admit call's ``flash_attention`` launches (one an
    attention layer), bf16: causal pairs at the peak, or q, k, v and the
    output of the live tokens at the bandwidth, whichever is longer."""
    H, KV, hd = m["n_heads"], m["n_kv_heads"], m["head_dim"]
    pairs = sum(_causal_pairs(n) for n in lengths)
    return _n_kind(m, "g") * bound(4.0 * H * hd * pairs,
                                   sum(lengths) * (2 * H + 2 * KV) * hd * BF16)


def decode_attention_bound_s(m: Dict[str, Any], n_active: int, ctx_sum: int,
                             bound: Callable[[float, float], float]) -> float:
    """Least time of one step's ``flash_decode`` launches (one an attention
    layer): the live slots' K and V read once, q read and the output
    written."""
    H, KV, hd = m["n_heads"], m["n_kv_heads"], m["head_dim"]
    nbytes = ctx_sum * 2 * KV * hd * BF16 + n_active * 2 * H * hd * BF16
    return _n_kind(m, "g") * bound(4.0 * H * hd * ctx_sum, nbytes)


def scan_ops_bytes(m: Dict[str, Any], lengths: Sequence[int]
                   ) -> Tuple[float, float]:
    """(fp32 operations, bytes) of one admit call's ``mamba_scan`` launches
    (one a Mamba layer, over the call's rows at ``lengths``): x,
    dt, B, C and the entry state read, y and the final state written, A
    and D read once a launch, all in float32."""
    x = _dims(m)
    di, n = x["di"], x["n"]
    toks = sum(lengths)
    ops = toks * di * (SCAN_OPS[0] * n + SCAN_OPS[1])
    nbytes = (toks * (3 * di + 2 * n) + len(lengths) * 2 * di * n
              + di * n + di) * FP32
    k = _n_kind(m, "m")
    return float(k * ops), float(k * nbytes)


# ---------------------------------------------------------------- reference

class Ref:
    """The reference for one configuration's ``model`` block."""

    def __init__(self, model: Dict[str, Any], precision: str = "fp32"):
        if precision not in ("fp32", "fp8"):
            raise ValueError(precision)
        self.m = model
        self.x = _dims(model)
        self.fp8 = precision == "fp8"
        self.eps = float(model["norm_eps"])

    # -- pieces -------------------------------------------------------------

    def mm(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        if self.fp8:
            a, b = fp8(a), fp8(b)
        return a @ b

    def norm(self, x: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
        return x * torch.rsqrt((x * x).mean(-1, keepdim=True) + self.eps) \
            * scale.float()

    def rows(self, fn: Callable[[torch.Tensor], torch.Tensor],
             h: torch.Tensor) -> torch.Tensor:
        """``fn`` over blocks of ``ROWS`` rows of ``h``."""
        return torch.cat([fn(h[r:r + ROWS]) for r in range(0, h.shape[0],
                                                             ROWS)])

    def mlp(self, h: torch.Tensor, w: Dict[str, Any]) -> torch.Tensor:
        wi, wg, wo = (w[k]["w"].float() for k in ("wi", "wg", "wo"))
        return self.rows(lambda r: self.mm(
            F.silu(self.mm(r, wg)) * self.mm(r, wi), wo), h)

    def moe(self, h: torch.Tensor, w: Dict[str, Any]) -> torch.Tensor:
        """The softmax router's top-k, not renormalised; every routed
        (token, expert) pair through its expert's SwiGLU, weighted by its
        router probability."""
        probs = torch.softmax(self.rows(
            lambda r: self.mm(r, w["router"].float()), h), -1)
        gates, experts = torch.topk(probs, self.x["k"], dim=-1)
        out = torch.zeros_like(h)
        for e in range(self.x["E"]):
            tok, slot = (experts == e).nonzero(as_tuple=True)
            if tok.numel() == 0:
                continue
            w1, wg, w2 = (w[k][e].float() for k in ("w1", "wg", "w2"))
            for r in range(0, tok.numel(), ROWS):
                t, s = tok[r:r + ROWS], slot[r:r + ROWS]
                xe = h[t]
                ye = self.mm(F.silu(self.mm(xe, wg)) * self.mm(xe, w1), w2)
                out.index_add_(0, t, ye * gates[t, s, None])
            del w1, wg, w2
        return out

    def attention(self, h: torch.Tensor, lens: Sequence[int],
                  w: Dict[str, Any]) -> torch.Tensor:
        """Causal GQA attention with no positional encoding, each sequence
        alone."""
        H, KV, hd = self.x["H"], self.x["KV"], self.x["hd"]
        wq, wk, wv, wo = (w[k]["w"].float() for k in ("wq", "wk", "wv", "wo"))
        out, a = [], 0
        for T in lens:
            x = h[a:a + T]
            a += T
            q = self.mm(x, wq).view(T, KV, H // KV, hd).permute(1, 2, 0, 3)
            k = self.mm(x, wk).view(T, KV, hd).permute(1, 0, 2)[:, None]
            v = self.mm(x, wv).view(T, KV, hd).permute(1, 0, 2)[:, None]
            if self.fp8:
                q, k, v = fp8(q), fp8(k), fp8(v)
            s = (q @ k.transpose(-1, -2)) * hd ** -0.5
            mask = torch.ones(T, T, dtype=torch.bool, device=h.device).tril()
            p = torch.softmax(s.masked_fill(~mask, float("-inf")), -1)
            if self.fp8:
                p = fp8(p)
            o = (p @ v).permute(2, 0, 1, 3).reshape(T, H * hd)
            out.append(self.mm(o, wo))
        return torch.cat(out)

    def scan(self, u: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
             B: torch.Tensor, C: torch.Tensor) -> torch.Tensor:
        """The selective scan of u, dt [G, L, DI], B, C [G, L, N] with A
        [DI, N] from a zero state: C_t . h_t for each step, float32.
        ``SCAN_CHUNK`` steps' decays exp(dt A) and inputs dt B u at once,
        then the state through them one step at a time."""
        G, L, DI = u.shape
        h = torch.zeros((G, DI, A.shape[1]), dtype=torch.float32,
                        device=u.device)
        ys = []
        for c0 in range(0, L, SCAN_CHUNK):
            c1 = min(L, c0 + SCAN_CHUNK)
            decay = torch.exp(dt[:, c0:c1, :, None] * A)          # [G,c,DI,N]
            inp = (dt[:, c0:c1] * u[:, c0:c1])[..., None] \
                * B[:, c0:c1, None, :]
            hs = torch.empty_like(decay)
            for t in range(c1 - c0):
                h = torch.addcmul(inp[:, t], decay[:, t], h, out=hs[:, t])
            ys.append(torch.einsum("gtdn,gtn->gtd", hs, C[:, c0:c1]))
        return torch.cat(ys, 1)

    def mixer(self, h: torch.Tensor, lens: Sequence[int],
              w: Dict[str, Any]) -> torch.Tensor:
        """The Mamba mixer over every sequence: sequences grouped by length
        (each group zero-padded behind its ends to its longest) so that
        the scan runs over a group at once."""
        x = self.x
        di, n, dc, dtr = x["di"], x["n"], x["dc"], x["dtr"]
        w_in, w_x = w["in_proj"]["w"].float(), w["x_proj"]["w"].float()
        w_dt, b_dt = w["dt_proj"]["w"].float(), w["dt_proj"]["b"].float()
        w_out = w["out_proj"]["w"].float()
        conv_w, conv_b = w["conv_w"].float(), w["conv_b"].float()
        A, D = -torch.exp(w["A_log"].float()), w["D"].float()
        starts = [0]
        for T in lens:
            starts.append(starts[-1] + T)
        out = torch.empty_like(h)
        for group in _groups(lens):
            G, L = len(group), lens[group[0]]
            xz = torch.zeros((G, L, 2 * di), device=h.device)
            for g, j in enumerate(group):
                xz[g, :lens[j]] = self.rows(lambda r: self.mm(r, w_in),
                                            h[starts[j]:starts[j + 1]])
            u, z = xz[..., :di], xz[..., di:]
            up = F.pad(u, (0, 0, dc - 1, 0))       # causal: dc-1 zeros first
            u = sum(up[:, i:i + L] * conv_w[i] for i in range(dc)) + conv_b
            u = F.silu(u)
            dbc = self.mm(u, w_x)
            t_dt, Bm, Cm = torch.split(dbc, [dtr, n, n], dim=-1)
            t_dt = self.norm(t_dt, w["dt_norm"])
            Bm = self.norm(Bm, w["b_norm"])
            Cm = self.norm(Cm, w["c_norm"])
            dt = F.softplus(self.mm(t_dt, w_dt) + b_dt)
            y = (self.scan(u, dt, A, Bm, Cm) + u * D) * F.silu(z)
            del xz, up, u, dbc, dt
            for g, j in enumerate(group):
                out[starts[j]:starts[j + 1]] = self.rows(
                    lambda r: self.mm(r, w_out), y[g, :lens[j]])
            del y
        return out

    def embed(self, w: Dict[str, Any], tokens: torch.Tensor) -> torch.Tensor:
        return w["embed"]["table"][tokens.long()].float()

    def head_w(self, w: Dict[str, Any]) -> torch.Tensor:
        if self.m.get("tie_embeddings", False):
            return w["embed"]["table"][:self.x["V"]].float().T
        return w["lm_head"]["w"][:, :self.x["V"]].float()

    # -- serving: teacher-forced logits -------------------------------------

    @torch.no_grad()
    def hidden(self, weights: Dict[str, Any],
               seqs: Sequence[torch.Tensor]) -> List[torch.Tensor]:
        """The final hidden states [T_i, d] of each token sequence, layer by
        layer over all of them (one layer's weights in float32 at a time,
        an expert's at a time in an expert layer)."""
        lens = [int(s.shape[0]) for s in seqs]
        x = torch.cat([self.embed(weights, s) for s in seqs])
        pat = self.m["layer_pattern"]
        for blk in range(self.x["nb"]):
            for i, kind in enumerate(pat):
                w = _layer(weights["blocks"][f"sub{i}"], blk)
                h = self.norm(x, w["ln1"])
                if kind == "m":
                    x = x + self.mixer(h, lens, w["mamba"])
                else:
                    x = x + self.attention(h, lens, w["attn"])
                h = self.norm(x, w["ln2"])
                x = x + (self.moe(h, w["ffn"]) if _is_moe(self.m, i)
                         else self.mlp(h, w["ffn"]))
                del h, w
        return list(self.norm(x, weights["final_norm"]).split(lens))

    @torch.no_grad()
    def logits(self, hw: torch.Tensor, h: torch.Tensor,
               chunk: int = 512) -> Iterable[torch.Tensor]:
        """float32 logits over the valid vocabulary (``hw``: ``head_w``),
        ``chunk`` rows at a time."""
        for r0 in range(0, h.shape[0], chunk):
            yield self.mm(h[r0:r0 + chunk], hw)

    def row_loss_sum(self, w: Dict[str, Any], tokens: torch.Tensor,
                     **row_inputs: Any) -> torch.Tensor:
        raise _no_training(self.m)


def _groups(lens: Sequence[int]) -> List[List[int]]:
    """Indices of the sequences, longest first, in groups of at most
    ``SCAN_ROWS`` whose padded size (rows x the group's longest) stays
    within ``SCAN_TOKENS`` (a longer sequence is a group alone)."""
    order = sorted(range(len(lens)), key=lambda j: -lens[j])
    out: List[List[int]] = []
    for j in order:
        if out and len(out[-1]) < SCAN_ROWS and \
                (len(out[-1]) + 1) * lens[out[-1][0]] <= SCAN_TOKENS:
            out[-1].append(j)
        else:
            out.append([j])
    return out


def _layer(blocks: Dict[str, Any], blk: int) -> Dict[str, Any]:
    """Block ``blk`` of the stacked tree, as views in their stored dtype
    (each use converts to float32)."""
    if isinstance(blocks, dict):
        return {k: _layer(v, blk) for k, v in blocks.items()}
    return blocks[blk]
