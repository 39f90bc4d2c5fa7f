"""The reference against independent computations at a tiny size: its
attention against PyTorch's scaled-dot-product attention, its rotary
embedding against complex rotation, its AdamW against ``torch.optim``'s,
its loss against ``cross_entropy``; and its fp8 control is coarser than
float32."""
import math

import pytest
import torch
import torch.nn.functional as F

from harness.weights import make_weights
from reference.model import AdamW, Ref, lr_at

MODEL = {"name": "t", "n_layers": 2, "d_model": 64, "n_heads": 4,
         "n_kv_heads": 2, "head_dim": 16, "d_ff": 96, "vocab": 300,
         "qkv_bias": True, "rope_theta": 10000.0, "norm_eps": 1e-6,
         "layer_pattern": "g"}
CPU = torch.device("cpu")


def _w(seed=1):
    return make_weights({"name": "t", "model": MODEL}, seed, CPU,
                        torch.float32)


def test_rope_is_a_complex_rotation():
    ref = Ref(MODEL)
    x = torch.randn(5, 3, 16, dtype=torch.float64).float()
    pos = torch.arange(5)
    got = ref.rope(x, pos)
    z = torch.complex(x[..., :8].double(), x[..., 8:].double())
    freqs = 10000.0 ** (-torch.arange(8, dtype=torch.float64) / 8)
    z = z * torch.exp(1j * pos[:, None, None].double() * freqs)
    want = torch.cat([z.real, z.imag], -1)
    torch.testing.assert_close(got.double(), want, rtol=1e-5, atol=1e-5)


def test_attention_against_sdpa():
    ref = Ref(MODEL)
    w = _w()
    layer = {k: (v[0] if not isinstance(v, dict) else
                 {kk: vv[0] for kk, vv in v.items()})
             for k, v in w["blocks"]["sub0"]["attn"].items()}
    x = torch.randn(7, 64)
    got = ref.attention(x, layer)
    q = (x @ layer["wq"]["w"] + layer["wq"]["b"]).view(7, 4, 16)
    k = (x @ layer["wk"]["w"] + layer["wk"]["b"]).view(7, 2, 16)
    v = (x @ layer["wv"]["w"] + layer["wv"]["b"]).view(7, 2, 16)
    q, k = ref.rope(q, torch.arange(7)), ref.rope(k, torch.arange(7))
    k, v = k.repeat_interleave(2, 1), v.repeat_interleave(2, 1)
    o = F.scaled_dot_product_attention(q.transpose(0, 1), k.transpose(0, 1),
                                       v.transpose(0, 1), is_causal=True)
    want = o.transpose(0, 1).reshape(7, 64) @ layer["wo"]["w"]
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)


def test_loss_against_cross_entropy():
    ref = Ref(MODEL)
    w = _w()
    toks = torch.randint(0, 300, (12,))
    got = ref.row_loss_sum(w, toks, None)
    h = ref.hidden(w, [toks])[0]
    logits = h[:-1] @ w["lm_head"]["w"][:, :300]
    want = F.cross_entropy(logits, toks[1:], reduction="sum")
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-4)


def test_adamw_against_torch_optim():
    opt = {"peak_lr": 1e-2, "min_lr_ratio": 0.1, "warmup_steps": 0,
           "total_steps": 10 ** 9, "b1": 0.9, "b2": 0.95, "eps": 1e-8,
           "weight_decay": 0.1, "clip_norm": 1e9}
    p = {"a": torch.randn(4, 5), "b": torch.randn(5)}
    q = {k: v.clone().requires_grad_(True) for k, v in p.items()}
    ours = AdamW(opt, p)
    torch_opt = torch.optim.AdamW(
        [{"params": [q["a"]], "weight_decay": 0.1},
         {"params": [q["b"]], "weight_decay": 0.0}],
        lr=lr_at(opt, 1), betas=(0.9, 0.95), eps=1e-8)
    for _ in range(3):
        g = {k: torch.randn_like(v) for k, v in p.items()}
        ours.step([g["a"], g["b"]])
        for k in q:
            q[k].grad = g[k].clone()
        torch_opt.step()
    for k in p:
        torch.testing.assert_close(p[k], q[k].detach(), rtol=1e-5, atol=1e-6)


def test_lr_schedule():
    opt = {"peak_lr": 1.0, "min_lr_ratio": 0.1, "warmup_steps": 2,
           "total_steps": 12}
    assert lr_at(opt, 1) == 0.5
    assert lr_at(opt, 2) == 1.0
    assert lr_at(opt, 7) == pytest.approx(0.1 + 0.9 * 0.5 * (1 + math.cos(
        math.pi * 0.5)))
    assert lr_at(opt, 12) == pytest.approx(0.1)


def test_fp8_control_is_coarser():
    w = _w(3)
    toks = torch.randint(0, 300, (40,))
    a = Ref(MODEL).hidden(w, [toks])[0]
    b = Ref(MODEL, "fp8").hidden(w, [toks])[0]
    rel = float((a - b).norm() / a.norm())
    assert 1e-3 < rel < 0.5
