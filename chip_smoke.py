#!/usr/bin/env python3
"""GPU smoke run of the PyTorch/CUDA port (``src/repro_torch``).

    python3 chip_smoke.py

Needs one NVIDIA H100 (any CUDA card with sm_90a) and the CUDA toolkit's
``nvcc``; imports nothing of JAX or of the JAX package. Phases, in order
(any failure raises and the script exits non-zero):

1. card: the card's name and power limit from ``nvidia-smi``;
2. build: the five hand-written kernels from
   ``src/repro_torch/kernels/*/csrc``, one ``nvcc`` per source, started
   together;
3. kernels: each kernel against its plain PyTorch version on the card at
   the serving shapes (attention at qwen2-7b's H 28, KV 4, D 128, prefill
   also at qwen2-7b's largest bucket, B 8, S 1023, and at gemma2-9b's heads,
   D 256, window 4096, softcap 50, decode also at jamba's and gemma2-9b's
   heads; the RWKV6
   scan at rwkv6-7b's H 64, D 64 and the Mamba scan at jamba's d_inner 8192,
   d_state 16, each at B 2, S 601 and at the served B 1, S 601 and S 300,
   with the per-step kernel that the scans keep for other shapes timed
   beside it on the same inputs), with
   its time, the plain version's, one PyTorch library call's where one
   computes the same function, and its bound (kernel and library times are
   device time, ``graph_ms``; ``events_ms`` keeps the back-to-back event
   timing of earlier runs). The grouped
   GEMM, which no model calls, is driven on its own path: a dropless MoE
   feed-forward through the op at the expert widths of olmoe-1b-7b,
   qwen3-moe-30b-a3b and jamba-v0.1-52b, with group sizes from the port's
   router on 1,202 tokens, held against the dense fp32 oracle; then each
   product against the plain version, a skewed case with empty groups, and
   olmoe's capacity buffer against ``_moe_local``'s own einsum. Each
   decode and grouped GEMM row names the kernel the call took;
4. parity: the same seeded bf16 weights through the kernels and through
   the plain versions, prefill of 2 ragged prompts plus 4 decode steps,
   logits compared: qwen2-7b and rwkv6-7b at full width with 2 layers,
   jamba-v0.1-52b at full width with one period of 8 layers, in bf16 and
   once more in fp32 (compute and cache);
5. serving: each model behind ``ContinuousBatcher`` with 3 WRR tenants
   (weights 1, 1, 2) and seeded bf16 weights, served by two engines on
   the same weights in one process: the default one, whose decode step is
   one CUDA graph captured in its constructor, and its eager twin
   (``cuda_graph=False``). The eager twin first runs one decode step under
   ``torch.cuda.set_sync_debug_mode("error")`` (no op of the step may sync
   with the host). The same 24 seeded requests then drain through the
   twins in turn, graphed, eager, graphed, eager; each drain prints
   tokens/s, the decode-step median against its bound and TTFT p50/p99 per
   tenant, and the greedy tokens must be the same in all four, request by
   request. Then ``torch.profiler`` traces four full-batch decode steps of
   each twin: the device's busy share, and one decode-attention partial and
   combine kernel per attention layer a step, graph replays included. The
   models: qwen2-7b at full width and depth (28 layers), then a trace of
   one admit call (4 prompts of 512); rwkv6-7b at full width and depth (32
   layers), then traces of one served admit call (one prompt of 600) with
   the new scan kernel, the per-step one and the new one again, for the
   scan's share of its device time (jamba likewise); jamba-v0.1-52b at
   full width with one period (8 layers: 7 Mamba, 1 attention, 4 MoE of
   16 experts; its 32 layers, ~104 GB in bf16, do not fit one 80 GB card).
   Each model is freed before the next loads. The launch counters, set to
   0 before each drain and read after it, show that every prefill and
   decode went through the kernels (a graph's replay adds the launches its
   capture recorded), and the decode steps through the tensor-core decode
   kernel;
6. fleet, after qwen2-7b's serving phase, on its weights: the same
   requests through the control plane, tenants of a live
   ``VirtualClusterFramework`` served by a ``ServingFleet`` of graphed
   qwen2-7b replicas on the one card (WorkUnits placed by the
   SuperScheduler, engines built by the node agents' providers on the
   executor's pool threads). Lone, fleet, lone, fleet drains, each fleet
   drain a 0 -> 1 resize under the backlog, must give the lone engine's
   tokens, admit calls and steps; then 1 -> 2 -> 3 -> 1 replicas under
   load must finish every request and retire 2 replicas, every unit
   reaching ``Ready``; each fleet run's launches must be the sum over its
   replicas. Lines ``fleet qwen2-7b ...`` and ``fleet_ab {...}``
   (``fleet_phase``).

The line before the last is ``{"kernels": [...]}``; the last line is
``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import dataclasses
import gc
import json
import subprocess
import sys
import threading
import time
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F

# the port from this checkout's src/ (a bare copy of this script fails here)
sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))
from repro_torch import models as M
from repro_torch import serving as S
from repro_torch.configs import get_config
from repro_torch.core import VirtualClusterFramework
from repro_torch.kernels._build import build_all
from repro_torch.kernels.flash_attention import kernel as fa_kernel
from repro_torch.kernels.flash_attention.ops import decode_mha, mha
from repro_torch.kernels.flash_decode import kernel as fd_kernel
from repro_torch.kernels.grouped_gemm import kernel as gg_kernel
from repro_torch.kernels.grouped_gemm.ops import grouped_gemm
from repro_torch.kernels.mamba_scan import kernel as ms_kernel
from repro_torch.kernels.mamba_scan.ops import mamba_scan
from repro_torch.kernels.rwkv6_scan import kernel as rs_kernel
from repro_torch.kernels.rwkv6_scan.ops import rwkv6_scan
from repro_torch.models import moe as moe_mod

SEED = 0
HBM_BYTES_PER_S = 3.35e12          # H100 SXM, NVIDIA data sheet
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}   # dense, no sparsity


def time_ms(fn, iters=20, warmup=3):
    """Mean time of ``fn`` over ``iters`` back-to-back calls between CUDA
    events: the device's time, or the host's time to issue the calls where
    that is longer. Times the plain versions, which sync the host, and the
    kernels' ``events_ms``, the measure their ``ms`` once was."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def graph_ms(fn, iters=20, replays=3):
    """Device time of one call of ``fn``: ``iters`` calls captured in a CUDA
    graph, the graph replayed ``replays`` times between CUDA events. Unlike
    ``time_ms`` this leaves out the host's time to issue each call, which
    at decode's size is longer than the kernels' own."""
    fn()
    torch.cuda.synchronize()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):     # warm-up off the default stream
        for _ in range(2):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    end.synchronize()
    ms = start.elapsed_time(end) / (iters * replays)
    del graph
    return ms


def bound(nbytes, flops, dtype):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[dtype] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def max_err(a, b):
    return float((a.float() - b.float()).abs().max())


def check(name, err, tol):
    print(f"check {name}: max_abs_err={err!r} tol={tol!r}")
    if not err <= tol:
        raise AssertionError(f"{name}: max abs error {err} > {tol}")


def attn_pairs(S, T, causal, window):
    """(q, k) pairs a prefill attends to, q_offset = T - S when causal."""
    q = np.arange(S, dtype=np.int64) + (T - S if causal else 0)
    hi = np.minimum(q + 1, T) if causal else np.full(S, T, np.int64)
    lo = np.maximum(q - window + 1, 0) if window > 0 else np.zeros(S, np.int64)
    return int(np.maximum(hi - lo, 0).sum())


def attn_bound(B, S, T, H, KV, D, causal, window, esize=2):
    """q and o once, k and v once; 4 D FLOP per attended (q, k) pair and
    head (the two products)."""
    nbytes = esize * (2 * B * S * H * D + 2 * B * T * KV * D)
    flops = 4 * D * attn_pairs(S, T, causal, window) * B * H
    return bound(nbytes, flops, "bfloat16")


def prefill_shape(gen, label, B, S, H, KV, D, window, softcap, sdpa):
    """bf16 causal prefill at a served shape, q, k, v drawn from ``gen``:
    kernel vs plain version (tol 2e-2), its time, the plain version's,
    SDPA's where ``sdpa`` names the call (else None: SDPA has no softcap),
    and the bound. Printed as ``prefill_shape {...}``."""
    q, k, v = (torch.randn(shape, generator=gen, device="cuda").bfloat16()
               for shape in ((B, S, H, D), (B, S, KV, D), (B, S, KV, D)))
    kw = dict(causal=True, window=window, softcap=softcap)
    out = mha(q, k, v, impl="cuda", **kw)
    ref = mha(q, k, v, impl="torch", **kw)
    torch.cuda.synchronize()
    assert torch.isfinite(out.float()).all()
    err = max_err(out, ref)
    check(f"flash_attention {label}", err, 2e-2)
    del out, ref
    ms = graph_ms(lambda: mha(q, k, v, impl="cuda", **kw))
    events_ms = time_ms(lambda: mha(q, k, v, impl="cuda", **kw))
    plain_ms = time_ms(lambda: mha(q, k, v, impl="torch", **kw), iters=3,
                       warmup=1)
    library_ms, library = None, sdpa
    if sdpa is None:
        library = "none: SDPA has no softcap"
    else:
        qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, k, v))
        library_ms = graph_ms(lambda: F.scaled_dot_product_attention(
            qt, kt, vt, is_causal=True, enable_gqa=True))
    b_ms, b_by = attn_bound(B, S, S, H, KV, D, True, window)
    flops = 4 * D * attn_pairs(S, S, True, window) * B * H
    row = {"shape": label, "max_abs_err": err, "tolerance": 2e-2, "ms": ms,
           "events_ms": events_ms, "plain_ms": plain_ms,
           "library_ms": library_ms, "library": library,
           "bound_ms": b_ms, "bound_by": b_by,
           "tflops": flops / (ms * 1e-3) / 1e12}
    print("prefill_shape " + json.dumps(row))
    return row


def prefill_phase(gen):
    """Prefill kernel vs its plain version at B 4, S 512 (qwen2-7b heads):
    three checks and the timed row, drawn from ``gen``; then timed checks
    at qwen2-7b's largest bucket (B 8, S 1023) and at gemma2-9b's heads (D
    256, window 4096, softcap 50), drawn from a generator of their own so
    that the later phases' inputs do not depend on them."""
    B, S, H, KV, D = 4, 512, 28, 4, 128
    dev = "cuda"

    def qkv(dtype):
        return [torch.randn(shape, generator=gen, device=dev).to(dtype)
                for shape in ((B, S, H, D), (B, S, KV, D), (B, S, KV, D))]

    cases = [("bf16 causal", torch.bfloat16, 0, 0.0, 2e-2),
             ("fp32 causal", torch.float32, 0, 0.0, 2e-5),
             ("bf16 window 128 softcap 50", torch.bfloat16, 128, 50.0, 2e-2)]
    errs = {}
    for label, dtype, window, softcap, tol in cases:
        q, k, v = qkv(dtype)
        kw = dict(causal=True, window=window, softcap=softcap)
        out = mha(q, k, v, impl="cuda", **kw)
        ref = mha(q, k, v, impl="torch", **kw)
        torch.cuda.synchronize()
        errs[label] = max_err(out, ref)
        check(f"flash_attention {label}", errs[label], tol)

    row = prefill_shape(gen, f"B{B} S{S} H{H} KV{KV} D{D} bf16 causal",
                        B, S, H, KV, D, 0, 0.0,
                        sdpa="SDPA, enable_gqa, is_causal")
    served = torch.Generator(device=dev).manual_seed(SEED + 1)
    shapes = [prefill_shape(served, "qwen2-7b bucket B8 S1023 H28 KV4 D128 "
                            "bf16 causal", 8, 1023, 28, 4, 128, 0, 0.0,
                            sdpa="SDPA, enable_gqa, is_causal"),
              prefill_shape(served, "gemma2-9b heads B2 S1023 H16 KV8 D256 "
                            "bf16 causal window 4096 softcap 50", 2, 1023,
                            16, 8, 256, 4096, 50.0, sdpa=None)]
    return {"name": "flash_attention", "route": "cuda",
            "source": "src/repro_torch/kernels/flash_attention/csrc/flash_attention.cu",
            "replaces": "src/repro/kernels/flash_attention/kernel.py:73",
            "shape": row["shape"], "max_abs_err": errs["bf16 causal"],
            "tolerance": 2e-2, "errors": errs, "ms": row["ms"],
            "events_ms": row["events_ms"],
            "plain_ms": row["plain_ms"], "library_ms": row["library_ms"],
            "bound_ms": row["bound_ms"], "bound_us": row["bound_ms"] * 1e3,
            "bound_by": row["bound_by"], "tflops": row["tflops"],
            "served_shapes": shapes}


def decode_bound(lengths, B, H, KV, D, window=0):
    """q and out once, the K and V each row attends to once; 4 D FLOP per
    attended (position, head)."""
    n = lengths.long()
    n_pos = int((n.clamp(max=window) if window > 0 else n).sum())
    nbytes = 2 * (2 * n_pos * KV * D + 2 * B * H * D) + 4 * B
    return bound(nbytes, 4 * H * D * n_pos, "bfloat16")


def decode_shape(gen, label, B, L, H, KV, D, window, softcap):
    """bf16 decode at a served head shape, B rows of ragged lengths (1 and
    L among them) drawn from ``gen``: kernel vs plain version (tol 3e-2),
    its time, the plain version's, SDPA's where it computes the same
    function (no softcap; a window shorter than L would need its own
    mask), and the bound. Printed as ``decode_shape {...}``."""
    dev = "cuda"
    kc = torch.randn((B, L, KV, D), generator=gen, device=dev).bfloat16()
    vc = torch.randn((B, L, KV, D), generator=gen, device=dev).bfloat16()
    lengths = torch.randint(2, L, (B,), generator=gen, device=dev,
                            dtype=torch.int32)
    lengths[0], lengths[1] = 1, L
    q = torch.randn((B, 1, H, D), generator=gen, device=dev).bfloat16()
    kw = dict(window=window, softcap=softcap)
    out = decode_mha(q, kc, vc, lengths, impl="cuda", **kw)
    ref = decode_mha(q, kc, vc, lengths, impl="torch", **kw)
    torch.cuda.synchronize()
    assert torch.isfinite(out.float()).all()
    err = max_err(out, ref)
    check(f"flash_decode {label}", err, 3e-2)
    ms = graph_ms(lambda: decode_mha(q, kc, vc, lengths, impl="cuda", **kw),
                  iters=50)
    events_ms = time_ms(lambda: decode_mha(q, kc, vc, lengths, impl="cuda",
                                           **kw), iters=50)
    plain_ms = time_ms(lambda: decode_mha(q, kc, vc, lengths, impl="torch",
                                          **kw), iters=10)
    library_ms, library = None, "none: SDPA has no softcap"
    if softcap == 0.0 and (window == 0 or window >= L):
        mask = torch.arange(L, device=dev)[None, :] < lengths[:, None].long()
        qt, kt, vt = q.transpose(1, 2), kc.transpose(1, 2), vc.transpose(1, 2)
        library_ms = graph_ms(lambda: F.scaled_dot_product_attention(
            qt, kt, vt, attn_mask=mask[:, None, None, :], enable_gqa=True),
            iters=50)
        library = "SDPA, enable_gqa, length mask"
    b_ms, b_by = decode_bound(lengths, B, H, KV, D, window)
    row = {"shape": f"{label} B{B} L{L} H{H} KV{KV} D{D} bf16, window "
                    f"{window}, softcap {softcap}",
           "lengths": lengths.tolist(), "kernel": fd_kernel.variant(q, kc),
           "max_abs_err": err, "tolerance": 3e-2, "ms": ms,
           "events_ms": events_ms, "plain_ms": plain_ms,
           "library_ms": library_ms, "library": library,
           "bound_ms": b_ms, "bound_by": b_by}
    print("decode_shape " + json.dumps(row))
    return row


def decode_phase(gen):
    """Decode kernel vs its plain version at B 8, L 1024, ragged lengths
    (qwen2-7b's heads): four dtype, window and softcap checks and the timed
    row, drawn from ``gen``; then timed checks at jamba's heads (H 32, KV
    8) and gemma2-9b's (D 256, window 4096, softcap 50), drawn from a
    generator of their own so that the later phases' inputs do not depend
    on them."""
    B, L, H, KV, D = 8, 1024, 28, 4, 128
    dev = "cuda"
    kc = torch.randn((B, L, KV, D), generator=gen, device=dev).bfloat16()
    vc = torch.randn((B, L, KV, D), generator=gen, device=dev).bfloat16()
    lengths = torch.randint(2, L, (B,), generator=gen, device=dev,
                            dtype=torch.int32)
    lengths[0], lengths[1] = 1, L
    q32 = torch.randn((B, 1, H, D), generator=gen, device=dev)
    errs, kinds = {}, {}
    for label, q in (("bf16 q, bf16 cache", q32.bfloat16()),
                     ("fp32 q, bf16 cache", q32)):
        kinds[label] = fd_kernel.variant(q, kc)
        for window, softcap in ((0, 0.0), (256, 30.0)):
            kw = dict(window=window, softcap=softcap)
            out = decode_mha(q, kc, vc, lengths, impl="cuda", **kw)
            ref = decode_mha(q, kc, vc, lengths, impl="torch", **kw)
            torch.cuda.synchronize()
            key = f"{label}, window {window}, softcap {softcap}"
            errs[key] = max_err(out, ref)
            check(f"flash_decode {key} ({kinds[label]})", errs[key], 3e-2)

    q = q32.bfloat16()
    ms = graph_ms(lambda: decode_mha(q, kc, vc, lengths, impl="cuda"),
                  iters=50)
    events_ms = time_ms(lambda: decode_mha(q, kc, vc, lengths, impl="cuda"),
                        iters=50)
    plain_ms = time_ms(lambda: decode_mha(q, kc, vc, lengths,
                                                 impl="torch"), iters=10)
    qt = q.transpose(1, 2)
    kt, vt = kc.transpose(1, 2), vc.transpose(1, 2)
    mask = (torch.arange(L, device=dev)[None, :] < lengths[:, None].long())
    mask = mask[:, None, None, :]
    library_ms = graph_ms(lambda: F.scaled_dot_product_attention(
        qt, kt, vt, attn_mask=mask, enable_gqa=True), iters=50)
    b_ms, b_by = decode_bound(lengths, B, H, KV, D)
    served = torch.Generator(device=dev).manual_seed(SEED + 2)
    shapes = [decode_shape(served, "jamba heads", 8, 1024, 32, 8, 128, 0,
                           0.0),
              decode_shape(served, "gemma2-9b heads", 8, 1024, 16, 8, 256,
                           4096, 50.0)]
    return {"name": "flash_decode", "route": "cuda",
            "source": "src/repro_torch/kernels/flash_decode/csrc/flash_decode.cu",
            "replaces": "src/repro/kernels/flash_decode/kernel.py:65",
            "shape": f"B{B} L{L} H{H} KV{KV} D{D} bf16, lengths "
                     f"{lengths.tolist()}", "kernels": kinds,
            "max_abs_err": errs["bf16 q, bf16 cache, window 0, softcap 0.0"],
            "tolerance": 3e-2, "errors": errs, "ms": ms,
            "events_ms": events_ms, "plain_ms": plain_ms,
            "library_ms": library_ms, "bound_ms": b_ms,
            "bound_us": b_ms * 1e3, "bound_by": b_by, "served_shapes": shapes}


def per_step_entry(kernel, symbol, fix=lambda args: args):
    """A callable with the C entry point's arguments that runs the per-step
    kernel of ``kernel``'s library (its ``symbol``) whatever the dtype and
    shape; ``fix`` may rewrite the arguments. For timing the per-step
    kernel beside the new one; the port's wrappers never call it."""
    raw = kernel.entry(symbol, kernel.argtypes)
    return lambda *args: raw(*fix(args))


def rwkv6_per_step_args(args):
    """The per-step kernel's own v split (its plan's rule) in place of the
    chunked kernel's: args are rwkv6_scan_fwd's (B, S, H, D at 8-11, dtype
    12, vsplit 13)."""
    B, S, H, D = args[8:12]
    vsplit = rs_kernel.plan(torch.float32, B, S, H, D,
                            rs_kernel.sm_count(0))["vsplit"]
    return args[:13] + (vsplit,) + args[14:]


def with_fn(kernel, fn, call):
    """``call()`` with ``kernel``'s loaded C entry point replaced by ``fn``
    (the wrapper, its checks and its launch count unchanged)."""
    kernel.fn()
    saved, kernel._fn = kernel._fn, fn
    try:
        return call()
    finally:
        kernel._fn = saved


def rwkv6_bound(B, S, H, D):
    """r, k, v (bf16) and w (fp32) read once, u and the state in and out
    once, out written once; the per-step form's fp32 operations, 5 per
    state element (r^T S and w S + k v) and 4 per output for the bonus.
    Returns (bound ms, by what, bytes-only ms)."""
    n = B * S * H * D
    nbytes = 3 * 2 * n + 4 * n + 4 * H * D + 2 * 4 * B * H * D * D + 2 * n
    flops = 5 * n * D + 4 * n
    b_ms, b_by = bound(nbytes, flops, "float32")
    return b_ms, b_by, nbytes / HBM_BYTES_PER_S * 1e3


def rwkv6_shape(gen, B, S, label, plain_iters=3):
    """bf16 r/k/v at rwkv6-7b's H 64, D 64, fp32 decay, a nonzero initial
    state, drawn from ``gen``: the kernel against its plain version (out
    5e-2, one bf16 ulp at |out| ~ 4; the fp32 state 1e-3), its device time,
    the per-step kernel's on the same inputs, the plain version's and
    the bound. Printed as ``rwkv6_shape {...}``."""
    H, D = 64, 64
    dev = "cuda"

    def randn(*shape, scale=1.0):
        return torch.randn(shape, generator=gen, device=dev) * scale

    r, k, v = (randn(B, S, H, D, scale=0.5).bfloat16() for _ in range(3))
    w = torch.exp(-torch.exp(randn(B, S, H, D, scale=0.5)))
    u = randn(H, D, scale=0.1)
    s0 = randn(B, H, D, D, scale=0.1)
    args = (r, k, v, w, u, s0)
    old = per_step_entry(rs_kernel.KERNEL, "rwkv6_scan_per_step_fwd",
                         rwkv6_per_step_args)
    out, s1 = rwkv6_scan(*args, impl="cuda")
    ref, s2 = rwkv6_scan(*args, impl="torch")
    out12, s12 = with_fn(rs_kernel.KERNEL, old,
                         lambda: rwkv6_scan(*args, impl="cuda"))
    torch.cuda.synchronize()
    assert torch.isfinite(out.float()).all() and torch.isfinite(s1).all()
    assert out.shape == r.shape and s1.shape == (B, H, D, D)
    errs = {"out": max_err(out, ref), "state": max_err(s1, s2),
            "per-step out": max_err(out12, ref),
            "per-step state": max_err(s12, s2)}
    check(f"rwkv6_scan {label} out (bf16)", errs["out"], 5e-2)
    check(f"rwkv6_scan {label} final state (fp32)", errs["state"], 1e-3)
    check(f"rwkv6_scan {label} per-step kernel out", errs["per-step out"], 5e-2)
    ms = graph_ms(lambda: rwkv6_scan(*args, impl="cuda"), iters=50)
    per_step_ms = with_fn(rs_kernel.KERNEL, old, lambda: graph_ms(
        lambda: rwkv6_scan(*args, impl="cuda"), iters=50))
    plain_ms = time_ms(lambda: rwkv6_scan(*args, impl="torch"),
                       iters=plain_iters, warmup=1)
    b_ms, b_by, bytes_ms = rwkv6_bound(B, S, H, D)
    row = {"shape": f"{label}: B{B} S{S} H{H} D{D} bf16 r/k/v, fp32 w, "
                    "initial state",
           "kernel": rs_kernel.variant(r),
           "plan": rs_kernel.plan(r.dtype, B, S, H, D, rs_kernel.sm_count(0)),
           "max_abs_err": errs["out"], "tolerance": 5e-2, "errors": errs,
           "ms": ms, "per_step_ms": per_step_ms, "plain_ms": plain_ms,
           "bound_ms": b_ms, "bound_by": b_by, "bytes_bound_ms": bytes_ms,
           "share_of_bound": b_ms / ms}
    print("rwkv6_shape " + json.dumps(row))
    return row, args


def rwkv6_phase(gen):
    """The RWKV6 scan at rwkv6-7b's heads: B 2, S 601 (the smoke's shape,
    not a multiple of the 16-step chunk; inputs from ``gen``), then the
    served shapes, B 1 at S 601 and S 300 (exact-length admission gives
    B 1; inputs from a generator of their own)."""
    row, args = rwkv6_shape(gen, 2, 601, "smoke", plain_iters=5)
    events_ms = time_ms(lambda: rwkv6_scan(*args, impl="cuda"))
    served = torch.Generator(device="cuda").manual_seed(SEED + 3)
    shapes = [rwkv6_shape(served, 1, 601, "served")[0],
              rwkv6_shape(served, 1, 300, "served")[0]]
    return dict(row, name="rwkv6_scan", route="cuda",
                source="src/repro_torch/kernels/rwkv6_scan/csrc/rwkv6_scan.cu",
                replaces="src/repro/kernels/rwkv6_scan/kernel.py:64",
                events_ms=events_ms, library_ms=None,
                bound_us=row["bound_ms"] * 1e3, served_shapes=shapes)


def mamba_shape(gen, Bt, S, label, plain_iters=3):
    """fp32 at jamba's d_inner 8192, d_state 16, A = -(1..16) as jamba's
    A_log gives, dt from a softplus, a nonzero initial state, drawn from
    ``gen``: the kernel against its plain version (1e-3 on y and the
    state), its device time, the per-step kernel's on the same
    inputs, the plain version's and the bound. Printed as
    ``mamba_shape {...}``."""
    DI, N = 8192, 16
    dev = "cuda"

    def randn(*shape, scale=1.0):
        return torch.randn(shape, generator=gen, device=dev) * scale

    x = randn(Bt, S, DI, scale=0.5)
    dt = F.softplus(randn(Bt, S, DI))
    A = -torch.arange(1, N + 1, dtype=torch.float32, device=dev).expand(
        DI, N).contiguous()
    Bm, Cm = randn(Bt, S, N, scale=0.5), randn(Bt, S, N, scale=0.5)
    D = torch.ones(DI, device=dev)
    h0 = randn(Bt, DI, N, scale=0.5)
    args = (x, dt, A, Bm, Cm, D, h0)
    old = per_step_entry(ms_kernel.KERNEL, "mamba_scan_per_step_fwd")
    y, h1 = mamba_scan(*args, impl="cuda")
    ref, h2 = mamba_scan(*args, impl="torch")
    y12, h12 = with_fn(ms_kernel.KERNEL, old,
                       lambda: mamba_scan(*args, impl="cuda"))
    torch.cuda.synchronize()
    assert torch.isfinite(y).all() and y.shape == x.shape
    # fp32 both; the chunked plain form's exp(+-cumsum) (|cumsum| <= 80,
    # fp32 ulp 7.6e-6) leaves ~1e-5 relative error per state, summed over 16
    errs = {"y": max_err(y, ref), "state": max_err(h1, h2),
            "per-step y": max_err(y12, ref),
            "per-step state": max_err(h12, h2)}
    check(f"mamba_scan {label} y (fp32)", errs["y"], 1e-3)
    check(f"mamba_scan {label} final state (fp32)", errs["state"], 1e-3)
    check(f"mamba_scan {label} per-step kernel y", errs["per-step y"], 1e-3)
    ms = graph_ms(lambda: mamba_scan(*args, impl="cuda"), iters=50)
    per_step_ms = with_fn(ms_kernel.KERNEL, old, lambda: graph_ms(
        lambda: mamba_scan(*args, impl="cuda"), iters=50))
    plain_ms = time_ms(lambda: mamba_scan(*args, impl="torch"),
                       iters=plain_iters, warmup=1)
    n = Bt * S * DI
    nbytes = 4 * (3 * n + DI * N + 2 * Bt * S * N + DI + 2 * Bt * DI * N)
    flops = 8 * n * N          # dt A, exp, h update (2), dt B x (2), C h, sum
    b_ms, b_by = bound(nbytes, flops, "float32")
    row = {"shape": f"{label}: Bt{Bt} S{S} DI{DI} N{N} fp32, initial state",
           "kernel": ms_kernel.variant(x, N),
           "plan": ms_kernel.plan(Bt, S, DI, N, ms_kernel.sm_count(0)),
           "max_abs_err": errs["y"], "tolerance": 1e-3, "errors": errs,
           "ms": ms, "per_step_ms": per_step_ms, "plain_ms": plain_ms,
           "bound_ms": b_ms, "bound_by": b_by, "share_of_bound": b_ms / ms,
           "exps": n * N}
    print("mamba_shape " + json.dumps(row))
    return row, args


def mamba_phase(gen):
    """The Mamba scan at jamba's d_inner and d_state: Bt 2, S 601 (the
    smoke's shape; inputs from ``gen``), then the served shapes, Bt 1 at
    S 601 and S 300 (inputs from a generator of their own)."""
    row, args = mamba_shape(gen, 2, 601, "smoke", plain_iters=5)
    events_ms = time_ms(lambda: mamba_scan(*args, impl="cuda"))
    served = torch.Generator(device="cuda").manual_seed(SEED + 4)
    shapes = [mamba_shape(served, 1, 601, "served")[0],
              mamba_shape(served, 1, 300, "served")[0]]
    return dict(row, name="mamba_scan", route="cuda",
                source="src/repro_torch/kernels/mamba_scan/csrc/mamba_scan.cu",
                replaces="src/repro/kernels/mamba_scan/kernel.py:56",
                events_ms=events_ms, library_ms=None,
                bound_us=row["bound_ms"] * 1e3, served_shapes=shapes)


def check_close(name, got, want, atol, rtol):
    """Every element within atol + rtol * |want| (as ``np.allclose``);
    returns the max abs error."""
    diff = (got.float() - want.float()).abs()
    err = float(diff.max())
    excess = float((diff - rtol * want.float().abs()).max())
    print(f"check {name}: max_abs_err={err!r} atol={atol!r} rtol={rtol!r}")
    if not excess <= atol:
        raise AssertionError(f"{name}: error exceeds {atol} + {rtol}|want| "
                             f"by {excess - atol}")
    return err


MOE_CONFIGS = ("olmoe-1b-7b", "qwen3-moe-30b-a3b", "jamba-v0.1-52b")
T_TOK = 2 * 601              # tokens: 2 prompts of 601, as in the scan phases
GG_TOL = {torch.bfloat16: 3e-2, torch.float32: 1e-4}


def moe_case(cfg, gen):
    """Seeded full-width bf16 hidden states [T_TOK, D] and experts, routed
    by the port's own router (``moe._route``): the rows in its stable
    expert order with nothing dropped, and the group sizes."""
    D, Fe, E = cfg.d_model, cfg.d_ff_expert, cfg.n_experts
    dev = "cuda"
    x = torch.randn((T_TOK, D), generator=gen, device=dev).bfloat16()
    p = {"router": torch.randn((D, E), generator=gen, device=dev) * D ** -0.5}
    for name, (a, b) in (("w1", (D, Fe)), ("wg", (D, Fe)), ("w2", (Fe, D))):
        p[name] = (torch.randn((E, a, b), generator=gen, device=dev)
                   * a ** -0.5).bfloat16()
    e_s, t_s, g_s, _, _ = moe_mod._route(x, p["router"], cfg)
    sizes = torch.bincount(e_s, minlength=E).to(torch.int32)
    return x, p, t_s, g_s, sizes


def dropless_experts(x, p, t_s, g_s, sizes, gemm):
    """The MoE feed-forward with every routed row kept: the experts' GLU
    as three grouped GEMMs over the sorted rows (silu and the bf16
    roundings as in ``moe._moe_local``), combined with the gates in fp32.
    Returns (out [T, D] fp32, the w2 product's input)."""
    xs = x[t_s]
    h = gemm(xs, sizes, p["w1"])
    g = gemm(xs, sizes, p["wg"])
    a = F.silu(g.float()).to(x.dtype) * h
    y = gemm(a, sizes, p["w2"])
    out = torch.zeros((x.shape[0], x.shape[1]), device=x.device)
    out.index_add_(0, t_s, y.float() * g_s[:, None])
    return out, a


def library_grouped_mm(x, sizes, W):
    """One PyTorch call for the same product, timed as a yardstick only:
    ``torch._grouped_mm`` with int32 cumulative offsets; where this torch
    lacks it or refuses the layout, a per-expert ``torch.mm`` loop
    (offsets taken on the host first). Returns (fn, what it is)."""
    offs = sizes.cumsum(0).to(torch.int32)
    try:
        torch._grouped_mm(x, W, offs=offs)
        torch.cuda.synchronize()
        return (lambda: torch._grouped_mm(x, W, offs=offs),
                "torch._grouped_mm (row-major W)")
    except (AttributeError, RuntimeError, TypeError, ValueError) as e:
        why = str(e).splitlines()[0][:160]
    ends = [0] + offs.tolist()
    out = torch.empty((x.shape[0], W.shape[2]), dtype=x.dtype, device=x.device)

    def loop():
        for e in range(W.shape[0]):
            if ends[e + 1] > ends[e]:
                torch.mm(x[ends[e]:ends[e + 1]], W[e],
                         out=out[ends[e]:ends[e + 1]])
        return out
    return loop, f"per-expert torch.mm loop (torch._grouped_mm: {why})"


def tile_fill_bytes(sizes, D, Fo, kind):
    """Bytes the wgmma kernel's blocks copy into shared memory for one
    product (``kind`` names its tile shape): per block and 64-wide k step,
    the 64-row x boxes that hold its rows and the W tile; None for the
    other kernels. From the group sizes, for comparison with the bytes the
    product must read from device memory."""
    shape = {"bf16 wgmma 128x256": (128, 256), "bf16 wgmma 256x128": (256, 128)}
    if kind not in shape:
        return None
    bm, bn = shape[kind]
    nk, ncol = -(-D // 64), -(-Fo // bn)
    total = 0
    for n in sizes.tolist():
        for r0 in range(0, max(n, 0), bm):
            boxes = -(-min(bm, n - r0) // 64)
            total += ncol * nk * (boxes * 64 * 128 + 64 * bn * 2)
    return total


def product_row(label, x, sizes, W):
    """One grouped product: kernel vs plain version, their times, the
    library call's and the bound (x, the W of non-empty experts and out
    moved once; 2 rows D F FLOP)."""
    tol = GG_TOL[x.dtype]
    got = grouped_gemm(x, sizes, W, impl="cuda")
    want = grouped_gemm(x, sizes, W, impl="torch")
    torch.cuda.synchronize()
    assert torch.isfinite(got.float()).all()
    err = check_close(f"grouped_gemm {label}", got, want, tol, tol)
    ms = graph_ms(lambda: grouped_gemm(x, sizes, W, impl="cuda"))
    events_ms = time_ms(lambda: grouped_gemm(x, sizes, W, impl="cuda"))
    plain_ms = time_ms(lambda: grouped_gemm(x, sizes, W, impl="torch"),
                       iters=5)
    lib_fn, lib_what = library_grouped_mm(x, sizes, W)
    lib_err = max_err(lib_fn()[:int(sizes.sum())], want[:int(sizes.sum())])
    # fp32 torch._grouped_mm copies through the host, which a CUDA graph
    # cannot capture: its time is taken between events
    library_ms = (graph_ms(lib_fn) if x.dtype == torch.bfloat16
                  else time_ms(lib_fn))
    rows, D = x.shape
    E, _, Fo = W.shape
    esize = x.element_size()
    live = int((sizes > 0).sum())
    nbytes = esize * (rows * D + live * D * Fo + rows * Fo)
    flops = 2 * int(sizes.sum()) * D * Fo
    b_ms, b_by = bound(nbytes, flops, str(x.dtype).split(".")[-1])
    kind = gg_kernel.variant(x, sizes, W)
    fill = tile_fill_bytes(sizes, D, Fo, kind)
    row = {"product": label, "rows": rows, "D": D, "F": Fo, "E": E,
           "live_experts": live, "kernel": kind, "smem_fill_bytes": fill,
           "smem_fill_tb_s": fill / (ms * 1e-3) / 1e12 if fill else None,
           "max_abs_err": err, "tolerance": tol,
           "ms": ms, "events_ms": events_ms, "plain_ms": plain_ms,
           "library_ms": library_ms, "library": lib_what,
           "library_max_abs_err": lib_err,
           "bound_ms": b_ms, "bound_by": b_by, "bytes": nbytes,
           "flops": flops}
    print("grouped_gemm_product " + json.dumps(row))
    return row


def grouped_gemm_phase(gen, kernels):
    """The grouped GEMM op at the expert widths of the registry's three
    MoE models, with group sizes from the port's router on T_TOK tokens.

    Its path: a dropless MoE feed-forward through the op at each width
    (launch counts set to 0 before, read after), held against the dense
    fp32 oracle ``moe.moe_ref``. Then, for each width, the w1 (D -> F)
    and w2 (F -> D) products against the plain version with times, one
    skewed case (the reference test's [40, 0, 26, 30] scaled to the rows,
    every other expert empty) and, at olmoe, an fp32 product and the
    capacity buffer of ``moe._moe_local`` against its own einsum. Returns
    (the kernels-line row summed over the router-derived products, the
    path's launch counts)."""
    cases = {}
    for name in MOE_CONFIGS:
        cases[name] = moe_case(get_config(name), gen)
    torch.cuda.synchronize()

    for name in MOE_CONFIGS:     # the path's products take the wgmma kernel
        x, p, t_s, _, sizes = cases[name]
        h = torch.empty((len(t_s), p["w2"].shape[1]), dtype=x.dtype,
                        device="cuda")
        kinds = {gg_kernel.variant(x[t_s], sizes, p["w1"]),
                 gg_kernel.variant(h, sizes, p["w2"])}
        print(f"grouped_gemm path {name}: {sorted(kinds)}")
        assert all(k.startswith("bf16 wgmma") for k in kinds), kinds
    for k in kernels:
        k.launches = 0
    outs = {name: dropless_experts(*cases[name], gemm=grouped_gemm)
            for name in MOE_CONFIGS}
    torch.cuda.synchronize()
    path_launches = {k.name: k.launches for k in kernels}
    want = {k.name: 3 * len(MOE_CONFIGS) if k is gg_kernel.KERNEL else 0
            for k in kernels}
    assert path_launches == want, (path_launches, want)

    products = []
    for name in MOE_CONFIGS:
        cfg = get_config(name)
        x, p, t_s, g_s, sizes = cases[name]
        out, a = outs[name]
        ref = moe_mod.moe_ref(p, x.float()[None], cfg)[0]
        assert out.shape == ref.shape and torch.isfinite(out).all()
        # five bf16 roundings (h, g, silu(g), a, y) of ~2^-9 each against
        # the fp32 oracle, on outputs of std ~0.1: 2% of the output's
        # largest magnitude covers them
        scale = float(ref.abs().max())
        check_close(f"dropless MoE {name} vs moe_ref (fp32 oracle)", out,
                    ref, 0.02 * scale, 0.0)
        del ref
        xs = x[t_s]
        products.append(product_row(f"{name} w1 router", xs, sizes, p["w1"]))
        products.append(product_row(f"{name} w2 router", a, sizes, p["w2"]))
        E, rows = cfg.n_experts, xs.shape[0]
        pat = np.array([40, 0, 26, 30])
        skew = np.zeros(E, np.int64)
        skew[:4] = pat * rows // pat.sum()
        skew[0] += rows - skew.sum()
        product_row(f"{name} w1 skewed {skew[:4].tolist()} + {E - 4} empty",
                    xs, torch.from_numpy(skew).cuda(), p["w1"])
        if name == "olmoe-1b-7b":
            # fp32 sums of 2048 products in another order than cuBLAS's:
            # ~sqrt(2048 / 32) times the reference's 1e-5 at D 32
            product_row(f"{name} w1 router fp32", xs.float(), sizes,
                        p["w1"].float())
            capacity_check(cfg, x, p)
        del cases[name], outs[name]
        free_card()

    keys = ("ms", "events_ms", "plain_ms", "library_ms", "bound_ms")
    total = {k: sum(r[k] for r in products) for k in keys}
    b_bytes = sum(r["bytes"] for r in products) / HBM_BYTES_PER_S * 1e3
    b_ops = sum(r["flops"] for r in products) / PEAK_FLOPS["bfloat16"] * 1e3
    return dict(total, name="grouped_gemm", route="cuda",
                source="src/repro_torch/kernels/grouped_gemm/csrc/grouped_gemm.cu",
                replaces="src/repro/kernels/grouped_gemm/kernel.py:29",
                shape="sum of the w1 and w2 products of olmoe-1b-7b, "
                      "qwen3-moe-30b-a3b and jamba-v0.1-52b, router sizes, "
                      f"{T_TOK} tokens, bf16",
                max_abs_err=max(r["max_abs_err"] for r in products),
                tolerance=GG_TOL[torch.bfloat16],
                bound_by="bytes" if b_bytes >= b_ops else "operations",
                library=sorted({r["library"] for r in products})), path_launches


def capacity_check(cfg, x, p):
    """At ``cfg``'s full width, the [E, C, D] dispatch buffer that
    ``moe._moe_local`` builds, flattened, through the grouped GEMM with
    every group of size C: that function's own w1 einsum, to bf16
    tolerance."""
    calls = []
    real = torch.einsum

    def spy(eq, *operands):
        out = real(eq, *operands)
        calls.append((eq, operands, out))
        return out

    torch.einsum = spy
    try:
        moe_mod._moe_local(x.reshape(2, T_TOK // 2, -1), p["router"], p["w1"],
                           p["wg"], p["w2"], cfg)
    finally:
        torch.einsum = real
    eq, (dispatch, w1), want = calls[0]
    assert eq == "ecd,edf->ecf" and w1.shape == p["w1"].shape
    E, C, D = dispatch.shape
    sizes = torch.full((E,), C, dtype=torch.int32, device="cuda")
    got = grouped_gemm(dispatch.reshape(E * C, D), sizes, w1, impl="cuda")
    check_close(f"grouped_gemm vs _moe_local's einsum ecd,edf->ecf "
                f"({cfg.name}, E {E}, C {C}, D {D})", got.reshape(E, C, -1),
                want, 3e-2, 3e-2)


def parity_phase(cfg, n_layers, tol, why, compute_dtype=torch.bfloat16):
    """Full width, ``n_layers`` layers: kernels vs plain versions on the
    same seeded bf16 weights and inputs, computing (and caching K/V) in
    ``compute_dtype``."""
    cfg2 = dataclasses.replace(cfg, n_layers=n_layers)
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    params = M.init_params(cfg2, generator=gen, device="cuda",
                           dtype=torch.bfloat16)
    rng = np.random.default_rng(SEED)
    lens = np.array([100, 37], np.int32)
    toks = np.zeros((2, 128), np.int32)
    for i, n in enumerate(lens):
        toks[i, :n] = rng.integers(0, cfg.vocab, n)
    steps = rng.integers(0, cfg.vocab, (4, 2, 1)).astype(np.int32)
    logits = {}
    for impl in ("cuda", "torch"):
        cache = M.init_cache(cfg2, 2, 256, dtype=compute_dtype,
                             device="cuda")
        out, cache, lengths = M.prefill(
            params, cfg2, torch.from_numpy(toks).cuda(), cache,
            lengths=torch.from_numpy(lens).cuda(), impl=impl,
            compute_dtype=compute_dtype)
        seq = [out]
        lengths = lengths + 1
        for s in steps:
            out, cache, lengths = M.decode_step(
                params, cfg2, torch.from_numpy(s).cuda(), cache, lengths,
                impl=impl, compute_dtype=compute_dtype)
            seq.append(out)
        logits[impl] = torch.stack(seq)[..., :cfg.vocab].float()
    a, b = logits["cuda"], logits["torch"]
    assert torch.isfinite(a).all() and a.shape == (5, 2, 1, cfg.vocab)
    err = max_err(a, b)
    agree = float((a.argmax(-1) == b.argmax(-1)).float().mean())
    print(f"parity {cfg.name} full width, {n_layers} layers, "
          f"{str(compute_dtype).split('.')[-1]}: logits "
          f"max_abs_err={err!r} (logit std {float(b.std())!r}), argmax "
          f"agreement {agree!r}; tolerance {tol}: {why}")
    check(f"parity logits {cfg.name} {compute_dtype}", err, tol)
    del params


def serving_phase(cfg, kernels, *, n_req, max_new, profile_admits=False,
                  profile_scan=None):
    """``cfg`` served to 3 WRR tenants behind ``ContinuousBatcher`` by two
    engines on one set of seeded bf16 weights in this process: the default
    one, whose decode step is one CUDA graph, and its eager twin
    (``cuda_graph=False``). The eager twin first runs one step under
    ``torch.cuda.set_sync_debug_mode("error")`` (``sync_free_step``). Then
    the same seeded requests drain through the twins in turn, graphed,
    eager, graphed, eager: each drain's launch counts must be
    ``expected_launches``, and its greedy tokens those of the first drain,
    request by request. Then four full-batch decode steps of each twin are
    traced (``profile_decode``); ``profile_admits`` traces attention admit
    calls and ``profile_scan`` = (kernel, per-step entry, kernel-name
    match) a recurrent one, on the graphed twin. Prints a ``serving_ab``
    JSON line and returns the first graphed drain's launch counts, with the
    weights and the graphed engine (the fleet phase's lone twin)."""
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    t0 = time.monotonic()
    params = M.init_params(cfg, generator=gen, device="cuda",
                           dtype=torch.bfloat16)
    torch.cuda.synchronize()
    w_total = sum(t.numel() * t.element_size() for t in _leaves(params))
    print(f"serving: init_params {cfg.name} ({cfg.n_layers} layers, bf16 "
          f"matrices, {w_total / 1e9:.2f} GB) {time.monotonic() - t0:.1f} s")
    weights = {"tenant-a": 1, "tenant-b": 1, "tenant-c": 2}
    label = {True: "graphed", False: "eager"}
    twins, build_ms = {}, {}
    for graphed in (False, True):
        t0 = time.perf_counter()
        engine = S.GenerationEngine(cfg, params, slots=8, max_len=1024,
                                    cuda_graph=graphed)
        torch.cuda.synchronize()
        build_ms[graphed] = (time.perf_counter() - t0) * 1e3
        assert (engine._graph is not None) == graphed
        if not graphed:
            sync_free_step(cfg, engine)
        sched = S.SlotScheduler()
        for t, w in weights.items():
            sched.register_tenant(t, weight=w)
        batcher = S.ContinuousBatcher(engine, scheduler=sched)
        # warm-up: one short request (cuBLAS handles, kernel libraries)
        batcher.submit(warmup_prompt(cfg), max_new_tokens=2)
        batcher.run_until_drained()
        twins[graphed] = (engine, batcher)
    recorded = {k.name: n for k, n in twins[True][0]._graph_launches.items()}
    print(f"serving {cfg.name}: engine construction eager "
          f"{build_ms[False]:.1f} ms, graphed {build_ms[True]:.1f} ms (its "
          f"warm-up step and capture: {build_ms[True] - build_ms[False]:.1f} "
          f"ms more); recorded launches a replay {recorded}")

    engine = twins[True][0]
    w_bytes = sum(t.numel() * t.element_size()
                  for t in _leaves(params) if t.dim() >= 2)
    table = params["embed"]["table"]
    w_bytes -= table.numel() * table.element_size()    # only rows gathered
    cache_bytes = sum(t.numel() * t.element_size()
                      for t in _leaves(engine.cache))
    step_bound_ms = (w_bytes + cache_bytes) / HBM_BYTES_PER_S * 1e3
    print(f"serving {cfg.name}: decode step bound {step_bound_ms:.2f} ms "
          f"({(w_bytes + cache_bytes) / 1e9:.2f} GB of weights and cache per "
          f"step at 3.35 TB/s)")

    runs = []
    for graphed in (True, False, True, False):
        r = drain(cfg, *twins[graphed], kernels, weights, n_req, max_new)
        r["twin"] = label[graphed]
        runs.append(r)
        print(f"serving {cfg.name} {r['twin']}: {n_req} requests, "
              f"{r['tokens_total']} tokens in {r['wall_s']:.3f} s = "
              f"{r['tokens_s']:.1f} tokens/s; decode step median "
              f"{r['step_median_ms']:.2f} ms over {r['steps']} steps (bound "
              f"{step_bound_ms:.2f} ms); counters {r['counters']}; launches "
              f"{r['launches']}")
        for t in weights:
            p50, p99, mx = r["ttft_ms"][t]
            print(f"serving {cfg.name} {r['twin']}: {t} (weight {weights[t]}) "
                  f"TTFT p50 {p50:.1f} ms p99 {p99:.1f} ms max {mx:.1f} ms")
    for r in runs[1:]:
        assert r["tokens"] == runs[0]["tokens"], \
            f"{cfg.name}: the {r['twin']} twin's greedy tokens differ"
    print(f"serving {cfg.name}: greedy tokens identical, request by request, "
          f"in all 4 drains (graphed, eager, graphed, eager)")
    if runs[0]["launches"]["flash_decode"]:   # the served cache and q: bf16
        cache = next(sub["k"] for sub in engine.cache.values() if "k" in sub)
        q = torch.empty((1, 1, cfg.n_heads, cfg.head_dim), dtype=cache.dtype,
                        device="cuda")
        kind = fd_kernel.variant(q, cache)
        print(f"serving {cfg.name}: decode kernel {kind}")
        assert kind.startswith("bf16 mma.sync"), kind

    busy = {label[g]: profile_decode(cfg, *twins[g], label[g])
            for g in (True, False)}
    if profile_admits:
        profile_admit(cfg, engine, np.random.default_rng(SEED + 2))
    if profile_scan:
        profile_scan_admit(cfg, engine, np.random.default_rng(SEED + 2),
                           *profile_scan)
    print("serving_ab " + json.dumps({
        "model": cfg.name, "layers": cfg.n_layers,
        "step_bound_ms": step_bound_ms,
        "construct_ms": {label[g]: build_ms[g] for g in (True, False)},
        "profile": busy,
        "drains": [{k: r[k] for k in ("twin", "tokens_s", "step_median_ms",
                                      "ttft_ms")} for r in runs]}))
    return runs[0]["launches"], (params, engine)


def sync_free_step(cfg, engine):
    """One eager decode step of ``engine`` under
    ``torch.cuda.set_sync_debug_mode("error")``: an op of the step that
    syncs with the host raises here (a CUDA graph could not hold it). It
    calls ``_step``, the body the graph captures, on one admitted slot,
    since ``step()`` ends in its one host sync by design; the request is
    then drained and dropped."""
    engine.admit_many([S.Request(0, np.arange(16, dtype=np.int32), 4)])
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        engine._step()
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    while engine.active_slots():
        engine.step()
    print(f"serving {cfg.name}: one eager decode step under sync debug mode "
          f"'error': no op synced")


def drain(cfg, engine, batcher, kernels, weights, n_req, max_new):
    """Submit ``n_req`` seeded requests (the same in every drain: 16-600
    prompt tokens, ``max_new`` new ones, tenant-major flood over
    ``weights``), drain them, and check the drain: every request complete,
    each kernel's launches ``expected_launches``, host syncs = admit calls
    + steps, no whole-cache copy. Returns its numbers and each request's
    tokens in submission order."""
    step_ms = []
    step = engine.step

    def timed_step():    # each step ends in its one host sync
        n, t = engine.steps, time.perf_counter()
        out = step()
        if engine.steps > n:
            step_ms.append((time.perf_counter() - t) * 1e3)
        return out

    engine.step = timed_step
    try:
        batcher.completed.clear()
        before = engine.counters()
        uids = {batcher.submit(prompt, max_new_tokens=max_new,
                               tenant=tenant): tenant
                for tenant, prompt in drain_requests(cfg, weights, n_req)}
        for k in kernels:
            k.launches = 0
        t0 = time.monotonic()
        batcher.run_until_drained()
        torch.cuda.synchronize()
        wall = time.monotonic() - t0
        launches = {k.name: k.launches for k in kernels}
    finally:
        del engine.step          # the class's method again
    after = engine.counters()
    d = {key: after[key] - before[key] for key in after}
    done = batcher.completed
    assert len(done) == n_req and set(done) == set(uids), "requests lost"
    for uid, r in done.items():
        assert r.done and len(r.tokens) == max_new, (uid, len(r.tokens))
        assert all(0 <= t < cfg.vocab for t in r.tokens)
    want = expected_launches(cfg, d)
    assert launches == want, (launches, want, d)
    assert all(launches[k] > 0 for k, n in want.items() if n), launches
    assert d["host_syncs"] == d["admit_calls"] + d["steps"], d
    assert after["full_cache_copies"] == 0
    tokens = [done[uid].tokens for uid in uids]
    n_tok = sum(len(t) for t in tokens)
    return {"tokens": tokens, "tokens_total": n_tok, "wall_s": wall,
            "tokens_s": n_tok / wall, "steps": len(step_ms),
            "step_median_ms": float(np.median(step_ms)),
            "step_total_ms": float(np.sum(step_ms)), "counters": d,
            "launches": launches, "ttft_ms": ttft_ms(done.values(), weights),
            "admits": admit_stats(done.values())}


def drain_requests(cfg, weights, n_req):
    """The drains' ``n_req`` seeded (tenant, prompt) pairs, the same in every
    drain: 16-600 prompt tokens, a tenant-major flood over ``weights``."""
    rng = np.random.default_rng(SEED + 1)
    out = []
    for i in range(n_req):
        tenant = list(weights)[i * len(weights) // n_req]
        n = int(rng.integers(16, 601))
        out.append((tenant, rng.integers(0, cfg.vocab, n)))
    return out


def admit_stats(done):
    """The admit calls that served ``done``: how many, and their host wall
    times (launch to the call's host sync; one call per length bucket),
    summed and median, in ms."""
    ms = sorted({q.admit_started_at: (q.admitted_at - q.admit_started_at)
                 * 1e3 for q in done}.values())
    return {"calls": len(ms), "total_ms": float(np.sum(ms)),
            "median_ms": float(np.median(ms))}


def ttft_ms(done, weights, since=None):
    """{tenant: (p50, p99, max)} of the time to first token in ms, from each
    request's submission, or from ``since`` (a ``time.monotonic()``)."""
    out = {}
    for t in weights:
        ms = sorted((r.first_token_at - (r.submitted_at if since is None
                                         else since)) * 1e3
                    for r in done if r.tenant == t)
        out[t] = (float(np.percentile(ms, 50)), float(np.percentile(ms, 99)),
                  ms[-1])
    return out


def expected_launches(cfg, counters):
    """Each kernel's launches over a drain: one per attention or scan layer
    per admit call (prefill; every prompt is >= 16 tokens, so no one-token
    prefill takes the decode recurrence), one per attention layer per
    decode step (the scans' decode steps are plain PyTorch, as in the
    reference)."""
    layers = {kind: cfg.n_blocks * cfg.layer_pattern.count(kind)
              for kind in "glmr"}
    attn = layers["g"] + layers["l"]
    admits, steps = counters["admit_calls"], counters["steps"]
    return {"flash_attention": attn * admits, "flash_decode": attn * steps,
            "rwkv6_scan": layers["r"] * admits,
            "mamba_scan": layers["m"] * admits, "grouped_gemm": 0}


def fleet_phase(cfg, kernels, params, lone, *, n_req, max_new):
    """``cfg`` served through the control plane: three tenants of a live
    ``VirtualClusterFramework`` (2 nodes), registered from their control
    planes, served by a ``ServingFleet`` whose replicas are graphed engines
    (8 slots, max_len 1024) on ``serving_phase``'s weights, one card for
    all. Each replica is an ``engine-<i>`` WorkUnit that the SuperScheduler
    places and a node agent starts through its provider: the factory, and
    so the decode graph's capture, runs on a pool thread of the framework's
    executor. ``lone``, ``serving_phase``'s graphed engine, is the twin.

    1. The lone engine drains ``drain``'s requests before the framework
       starts (what the framework's threads cost a lone engine).
    2. A warm-up request through a replica spawned for it, retired after
       (the lone engine served the same one in ``serving_phase``).
    3. Lone, fleet, lone, fleet: the lone twin from a fresh
       ``SlotScheduler`` with the same tenants, the fleet by a 0 -> 1
       resize after the requests are submitted, so the replica's first
       ``take`` sees them all as ``pump`` does; the replica is retired
       after. Gated: every drain's tokens, request by request, and its
       admit calls and steps equal the first lone drain's.
    4. 1 -> 2 replicas and the requests drained by both, once at the
       interpreter's switch interval and once at 0.5 ms (how much the
       replicas' drive threads wait for each other's interpreter lock);
       the requests again, with 3 replicas asked for while they are in
       flight; back to 1 once they are done. Gated: every request
       completes, 2 replicas retire, only ``engine-0`` is left. Counted,
       not gated: the requests whose tokens equal the lone drains'
       (admission groups differ, and a bf16 product over another number
       of rows may differ by an ulp).

    Every spawned unit must reach ``Ready`` (a factory that raises leaves
    its unit ``Failed``), an exception on any thread fails the phase, and
    each fleet run's launches must equal the sum over the replicas of
    ``expected_launches`` plus each new replica's capture warm-up step.
    Prints each drain, each spawn (resize to ``Ready``, the time the
    factory held its pool thread, the allocator's reserved memory around
    it), each replica's counters, the card's allocated memory and a
    ``fleet_ab`` JSON line; returns the fleet runs' launch counts, summed.
    """
    t_phase = time.monotonic()
    weights = {"tenant-a": 1, "tenant-b": 1, "tenant-c": 2}
    reqs = drain_requests(cfg, weights, n_req)
    mem = {"before the fleet": torch.cuda.memory_allocated()}
    builds, step_ms, errors = [], {}, []

    def factory():
        reserved = torch.cuda.memory_reserved()
        t0 = time.perf_counter()
        engine = S.GenerationEngine(cfg, params, slots=8, max_len=1024)
        held_ms = (time.perf_counter() - t0) * 1e3
        times = step_ms[engine] = []
        step = engine.step

        def timed_step():    # each step ends in its one host sync
            n, t = engine.steps, time.perf_counter()
            out = step()
            if engine.steps > n:
                times.append((time.perf_counter() - t) * 1e3)
            return out

        engine.step = timed_step
        builds.append({"engine": engine, "held_ms": held_ms,
                       "thread": threading.current_thread().name,
                       "reserved_gb": [reserved / 1e9,
                                       torch.cuda.memory_reserved() / 1e9]})
        return engine

    hook = threading.excepthook

    def record(args):
        errors.append(f"{args.thread.name}: {args.exc_type.__name__}: "
                      f"{args.exc_value}")
        hook(args)

    fleet = S.ServingFleet(factory, replicas=0)
    fw = VirtualClusterFramework(num_nodes=2, scan_interval=0.0,
                                 heartbeat_interval=3600)
    fleet.attach(fw)
    spawns, labels, fleet_launches, runs = [], {}, {}, []

    def resize(n):
        """Resize, wait for the fleet to settle, note each new unit's
        time to ``Ready`` and the factory that built its engine."""
        for name, ms in fleet_resize(fw, fleet, n, errors).items():
            engine = fleet.replica(f"{S.SERVING_NS}/{name}").engine
            build = next(b for b in builds if b["engine"] is engine)
            labels[engine] = f"{name} (spawn {len(spawns) + 1})"
            spawns.append({"unit": labels[engine], "resize_to_ready_ms": ms,
                           "factory_ms": build["held_ms"],
                           "thread": build["thread"],
                           "reserved_gb": build["reserved_gb"]})
            print(f"fleet {cfg.name}: spawn {labels[engine]}: resize to "
                  f"Ready {ms:.1f} ms; the factory (engine construction and "
                  f"graph capture) held pool thread {build['thread']} for "
                  f"{build['held_ms']:.1f} ms; memory reserved "
                  f"{build['reserved_gb'][0]:.3f} -> "
                  f"{build['reserved_gb'][1]:.3f} GB")
            assert build["thread"].startswith(fw.executor.name), build

    def fleet_run(run):
        """``run()`` with every kernel's count set to 0 before and read
        after: the counts must be the sum over the replicas."""
        before = {b["engine"]: b["engine"].counters() for b in builds}
        for k in kernels:
            k.launches = 0
        out = run()
        torch.cuda.synchronize()
        launches = {k.name: k.launches for k in kernels}
        want = dict.fromkeys(launches, 0)
        for b in builds:
            engine = b["engine"]
            c0 = before.get(engine, dict.fromkeys(engine.counters(), 0))
            d = {key: v - c0[key] for key, v in engine.counters().items()}
            assert d["host_syncs"] == d["admit_calls"] + d["steps"], d
            assert d["full_cache_copies"] == 0, d
            for name, n in expected_launches(cfg, d).items():
                want[name] += n
            if engine not in before:     # its capture's warm-up step ran
                for k, n in engine._graph_launches.items():
                    want[k.name] += n
        assert launches == want, (launches, want)
        for name, n in launches.items():
            fleet_launches[name] = fleet_launches.get(name, 0) + n
        return out, launches

    def summary(side, done, engine=None):
        """A fleet drain's numbers; tokens/s from its first take."""
        assert all(q.done and len(q.tokens) == max_new for q in done)
        first = min(q.dequeued_at for q in done)
        wall = max(q.finished_at for q in done) - first
        tokens = [q.tokens for q in done]
        n_tok = sum(len(t) for t in tokens)
        r = {"side": side, "tokens": tokens, "tokens_total": n_tok,
             "wall_s": wall, "tokens_s": n_tok / wall,
             "ttft_ms": ttft_ms(done, weights),
             "ttft_from_first_take_ms": ttft_ms(done, weights, since=first),
             "admits": admit_stats(done)}
        if runs:
            r["same_tokens_as_lone"] = sum(
                t == w for t, w in zip(tokens, runs[0]["tokens"]))
        if engine is not None:
            r.update(steps=len(step_ms[engine]), counters=engine.counters(),
                     step_median_ms=float(np.median(step_ms[engine])),
                     step_total_ms=float(np.sum(step_ms[engine])))
        return r

    def report(r):
        line = (f"fleet {cfg.name} {r['side']}: {n_req} requests, "
                f"{r['tokens_total']} tokens in {r['wall_s']:.3f} s = "
                f"{r['tokens_s']:.1f} tokens/s")
        if "ttft_from_first_take_ms" in r:
            line += " (from the first take)"
        if "steps" in r:
            line += (f"; decode step median {r['step_median_ms']:.2f} ms "
                     f"over {r['steps']} steps (in all "
                     f"{r['step_total_ms']:.1f} ms); counters {r['counters']}")
        for label, (n, med, total) in r.get("replica_steps", {}).items():
            line += (f"; {label}: {n} steps, median {med:.2f} ms, in all "
                     f"{total:.1f} ms")
        a = r["admits"]
        line += (f"; {a['calls']} admit calls, median {a['median_ms']:.1f} "
                 f"ms, in all {a['total_ms']:.1f} ms")
        if "launches" in r:
            line += f"; launches {r['launches']}"
        if "same_tokens_as_lone" in r:
            line += (f"; {r['same_tokens_as_lone']} of {n_req} requests' "
                     f"tokens equal the lone engine's")
        print(line)
        for t in weights:
            p50, p99, mx = r["ttft_ms"][t]
            line = (f"fleet {cfg.name} {r['side']}: {t} (weight "
                    f"{weights[t]}) TTFT p50 {p50:.1f} ms p99 {p99:.1f} ms "
                    f"max {mx:.1f} ms")
            if "ttft_from_first_take_ms" in r:
                p50, p99, mx = r["ttft_from_first_take_ms"][t]
                line += (f"; from the first take p50 {p50:.1f} p99 "
                         f"{p99:.1f} max {mx:.1f}")
            print(line)

    def lone_drain(side):
        sched = S.SlotScheduler()
        for t, w in weights.items():
            sched.register_tenant(t, weight=w)
        r = drain(cfg, lone, S.ContinuousBatcher(lone, scheduler=sched),
                  kernels, weights, n_req, max_new)
        r["side"] = side
        report(r)
        runs.append(r)

    def fleet_drain():
        """The requests, then a 0 -> 1 resize."""
        assert fleet.live_replicas() == 0
        fleet.pop_completed()
        uids = [fleet.submit(t, p, max_new_tokens=max_new) for t, p in reqs]
        resize(1)
        done = fleet_wait(fleet, len(uids), errors)
        return [done[u] for u in uids], builds[-1]["engine"]

    def under_load():
        """1 -> 2 replicas; the requests drained by both, at the default
        and at a 0.5 ms switch interval; again with a third replica asked
        for while they are in flight; back to 1."""
        out = []
        resize(2)
        for label, interval in (("2 replicas", None),
                                ("2 replicas, switch interval 0.5 ms", 5e-4),
                                ("2 -> 3 replicas", None)):
            fleet.pop_completed()
            mark = {e: len(t) for e, t in step_ms.items()}
            default = sys.getswitchinterval()
            sys.setswitchinterval(interval or default)
            try:
                uids = [fleet.submit(t, p, max_new_tokens=max_new)
                        for t, p in reqs]
                if label.endswith("3 replicas"):
                    wait_until(lambda: any(b["engine"].active_slots()
                                           for b in builds), errors)
                    resize(3)
                done = fleet_wait(fleet, len(uids), errors)
            finally:
                sys.setswitchinterval(default)
            mem[f"{fleet.live_replicas()} replicas"] = \
                torch.cuda.memory_allocated()
            r = summary(label, [done[u] for u in uids])
            r["replica_steps"] = {
                labels[e]: (len(t) - mark.get(e, 0),
                            float(np.median(t[mark.get(e, 0):])),
                            float(np.sum(t[mark.get(e, 0):])))
                for e, t in step_ms.items() if len(t) > mark.get(e, 0)}
            out.append(r)
        fleet_resize(fw, fleet, 1, errors)
        return out

    threading.excepthook = record
    try:
        lone_drain("lone, no framework")
        t0 = time.monotonic()
        with fw:
            for t, w in weights.items():
                fleet.register_tenant(fw.add_tenant(t, weight=w))
            start_s = time.monotonic() - t0
            gc_ms = gc_probe(cfg)
            fleet.submit("tenant-a", warmup_prompt(cfg), max_new_tokens=2)
            resize(1)
            fleet_wait(fleet, 1, errors)
            fleet_resize(fw, fleet, 0, errors)

            for side in ("lone", "fleet", "lone", "fleet"):
                if side == "lone":
                    lone_drain(side)
                    continue
                (done, engine), launches = fleet_run(fleet_drain)
                fleet_resize(fw, fleet, 0, errors)
                r = summary("fleet 0 -> 1", done, engine)
                r["launches"] = launches
                report(r)
                runs.append(r)
            for r in runs[1:]:
                assert r["tokens"] == runs[0]["tokens"], \
                    f"{cfg.name}: the {r['side']} drain's greedy tokens differ"
                for key in ("admit_calls", "steps"):
                    assert r["counters"][key] == runs[0]["counters"][key], \
                        (r["side"], key, r["counters"], runs[0]["counters"])
            print(f"fleet {cfg.name}: greedy tokens, admit calls and steps "
                  f"identical in all {len(runs)} drains ("
                  + ", ".join(r["side"] for r in runs) + ")")

            resize(1)
            retired0 = fleet.retired
            n_before = len(builds)
            scale, launches = fleet_run(under_load)
            mem["after the scale-down to 1"] = torch.cuda.memory_allocated()
            units = sorted(u.metadata.name for u in fw.super_api.list(
                "WorkUnit", S.SERVING_NS, copy=False))
            assert fleet.retired - retired0 == 2, fleet.retired
            assert fleet.live_replicas() == 1 and units == ["engine-0"], units
            assert len(builds) == n_before + 2
            for r in scale:
                report(r)
            print(f"fleet {cfg.name} 1 -> 2 -> 3 -> 1: launches {launches}; "
                  f"retired {fleet.retired} in all, 2 in this run; units "
                  f"{units}")
            replicas = {}
            for b in builds[n_before - 1:]:
                engine = b["engine"]
                replicas[labels[engine]] = engine.counters()
                print(f"fleet {cfg.name} 1 -> 2 -> 3 -> 1: {labels[engine]} "
                      f"counters {engine.counters()}, decode step median "
                      f"{float(np.median(step_ms[engine] or [0])):.2f} ms")
            t_exit = time.monotonic()
        stop_s = time.monotonic() - t_exit
    finally:
        threading.excepthook = hook
    assert not errors, errors
    for key, n in mem.items():
        print(f"fleet {cfg.name}: torch.cuda.memory_allocated() {key}: "
              f"{n / 1e9:.3f} GB")
    phase_s = time.monotonic() - t_phase
    print(f"fleet {cfg.name}: phase {phase_s:.1f} s; framework start and 3 "
          f"tenants {start_s:.2f} s, stop {stop_s:.2f} s")
    drop = ("tokens",)
    print("fleet_ab " + json.dumps({
        "model": cfg.name, "layers": cfg.n_layers, "slots": 8,
        "max_len": 1024, "spawns": spawns,
        "drains": [{k: v for k, v in r.items() if k not in drop}
                   for r in runs],
        "scale_1_2_3_1": {"runs": [{k: v for k, v in r.items()
                                    if k not in drop} for r in scale],
                          "launches": launches, "retired": fleet.retired,
                          "replicas": replicas},
        "memory_allocated_gb": {k: n / 1e9 for k, n in mem.items()},
        "phase_s": phase_s, "framework_start_s": start_s,
        "framework_stop_s": stop_s, "gc_collect_ms": gc_ms}))
    return fleet_launches


def gc_probe(cfg):
    """Time one full ``gc.collect()`` in this process (it holds the
    interpreter lock throughout), and say whether ``torch.cuda.graph``
    runs one at the start of every capture, as a replica's factory does."""
    import inspect
    enter = inspect.getsource(torch.cuda.graph.__enter__)
    at_capture = "gc.collect()" in enter and (
        "force_cudagraph_gc" not in enter
        or bool(torch.compiler.config.force_cudagraph_gc))
    t0 = time.perf_counter()
    gc.collect()
    ms = (time.perf_counter() - t0) * 1e3
    print(f"fleet {cfg.name}: one gc.collect() {ms:.1f} ms "
          f"({len(gc.get_objects())} objects tracked); torch.cuda.graph "
          f"collects at every capture: {at_capture}")
    return ms


def fleet_resize(fw, fleet, n, errors, timeout=120.0):
    """``fleet.resize(n)``, then wait until units ``engine-0..n-1`` are all
    ``Ready``, ``n`` replicas are live and every retired replica's drive
    thread has exited. Returns {unit: ms from the resize to the unit's
    ``Ready`` condition} for the units that became ready (the condition's
    own timestamp, so the 10 ms poll neither rounds it nor takes the
    interpreter lock often). A ``Failed`` unit, an exception on another
    thread or the timeout raises."""
    def units():
        return {u.metadata.name: u.status for u in fw.super_api.list(
            "WorkUnit", S.SERVING_NS, copy=False)}

    was_ready = {k for k, st in units().items() if st.phase == "Ready"}
    want = {f"engine-{i}" for i in range(n)}
    t0 = time.time()                 # the conditions' clock
    fleet.resize(n)
    while True:
        assert not errors, errors
        assert time.time() - t0 < timeout, (
            f"fleet did not reach {n} replicas in {timeout} s", units())
        got = units()
        for name, st in got.items():
            if st.phase == "Failed":
                raise RuntimeError(f"{name} failed: {st.message}")
        drives = {t.name for t in threading.enumerate()
                  if t.name.startswith("engine:")}
        if (set(got) == want and all(got[k].phase == "Ready" for k in want)
                and fleet.live_replicas() == n
                and drives == {f"engine:{S.SERVING_NS}/{k}" for k in want}):
            return {k: (got[k].condition("Ready").last_transition_time
                        - t0) * 1e3 for k in sorted(want - was_ready)}
        time.sleep(0.01)


def wait_until(cond, errors, timeout=120.0):
    """Poll ``cond`` every 5 ms; an exception on another thread or the
    timeout raises."""
    deadline = time.monotonic() + timeout
    while not cond():
        assert not errors, errors
        assert time.monotonic() < deadline, "timed out"
        time.sleep(0.005)


def fleet_wait(fleet, n, errors, timeout=120.0):
    """``fleet.wait_completed(n)``, failing early on an exception raised on
    another thread (a drive thread that dies leaves its requests pending)."""
    deadline = time.monotonic() + timeout
    while True:
        try:
            return fleet.wait_completed(n, timeout=0.5)
        except TimeoutError:
            assert not errors, errors
            if time.monotonic() > deadline:
                raise


def warmup_prompt(cfg):
    """The one short request that warms an engine's drive thread."""
    return np.random.default_rng(SEED).integers(0, cfg.vocab, 16)


def free_card():
    gc.collect()
    torch.cuda.empty_cache()


def profile_decode(cfg, engine, batcher, label, n_steps=4):
    """Device busy share and kernel mix of ``n_steps`` full-batch decode
    steps, from a ``torch.profiler`` trace (run after the measured drains).
    The trace lists a graph's kernels one by one, so it checks the launch
    accounting on its own: each step holds one decode-attention partial
    and one combine kernel per attention layer. Returns the numbers."""
    from torch.profiler import ProfilerActivity, profile
    rng = np.random.default_rng(SEED + 3)
    for _ in range(engine.slots):
        batcher.submit(rng.integers(0, cfg.vocab, 64), max_new_tokens=16)
    batcher.pump()                       # admission + first step, untraced
    torch.cuda.synchronize()
    steps0 = engine.steps
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(n_steps):
            batcher.pump()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    assert engine.steps - steps0 == n_steps
    batcher.run_until_drained()
    per_name = device_ms_by_name(prof)
    busy = sum(t for _, t in per_name.values())
    count = sum(n for n, _ in per_name.values())
    assert busy > 0, "the profiler recorded no device time"
    print(f"profile {cfg.name} {label}: {n_steps} decode steps "
          f"({engine.slots} active slots) wall {wall_ms:.2f} ms, device busy "
          f"{busy:.2f} ms ({100 * busy / wall_ms:.1f}%), "
          f"{count / n_steps:.0f} kernels per step")
    attn_layers = cfg.n_blocks * sum(cfg.layer_pattern.count(k) for k in "gl")
    attn = {k: v for k, v in per_name.items() if "decode_" in k}
    combines = sum(n for k, (n, _) in attn.items() if "decode_combine" in k)
    partials = sum(n for k, (n, _) in attn.items()
                   if "decode_mma" in k or "decode_partial" in k)
    assert combines == partials == attn_layers * n_steps, \
        (label, combines, partials, attn_layers, n_steps)
    attn_ms = sum(t for _, t in attn.values())
    print(f"profile {cfg.name} {label}: decode attention "
          f"{combines // n_steps} launches/step (= {attn_layers} attention "
          f"layers), {attn_ms / n_steps:.3f} ms/step = "
          f"{100 * attn_ms / busy:.1f}% of device time")
    for name, (n, t) in sorted(per_name.items(), key=lambda kv: -kv[1][1])[:6]:
        print(f"profile {cfg.name} {label}:   {t / n_steps:8.3f} ms/step  "
              f"{n // n_steps:5d} launches/step  {name[:90]}")
    return {"wall_ms": wall_ms, "busy_ms": busy, "busy_share": busy / wall_ms,
            "kernels_per_step": count / n_steps,
            "decode_attention_launches_per_step": combines / n_steps}


def device_ms_by_name(prof):
    """{kernel name: (launches, device ms)} from a profiler's CUDA events."""
    from torch.autograd import DeviceType
    per_name = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            ms = e.time_range.elapsed_us() / 1e3
            n, t = per_name.get(e.name, (0, 0.0))
            per_name[e.name] = (n + 1, t + ms)
    return per_name


def profile_admit(cfg, engine, rng, n_req=4, length=512, match="attn_fwd",
                  label="prefill attention"):
    """Device time by kernel name over one admit call: ``n_req`` prompts of
    ``length`` tokens (one bucket), one token each so no slot stays taken;
    a first call of the same shape runs untraced. Prints the share of the
    device time of the kernels whose names hold ``match``, and returns
    (their ms, device busy ms, wall ms)."""
    from torch.profiler import ProfilerActivity, profile

    def reqs(uid0):
        return [S.Request(uid0 + i, rng.integers(0, cfg.vocab, length), 1)
                for i in range(n_req)]

    engine.admit_many(reqs(10_000))
    torch.cuda.synchronize()
    calls0 = engine.admit_calls
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        done = engine.admit_many(reqs(20_000))
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    assert engine.admit_calls - calls0 == 1 and all(r.done for r in done)
    per_name = device_ms_by_name(prof)
    busy = sum(t for _, t in per_name.values())
    assert busy > 0, "the profiler recorded no device time"
    mine = {k: v for k, v in per_name.items() if match in k}
    mine_ms = sum(t for _, t in mine.values())
    print(f"profile_admit {cfg.name}: one admit call of {n_req} x {length} "
          f"tokens ({cfg.n_layers} layers) wall {wall_ms:.2f} ms, device "
          f"busy {busy:.2f} ms ({100 * busy / wall_ms:.1f}%), "
          f"{sum(n for n, _ in per_name.values())} kernels; {label} "
          f"{mine_ms:.3f} ms in {sum(n for n, _ in mine.values())} "
          f"launches = {100 * mine_ms / busy:.1f}% of device time")
    for name, (n, t) in sorted(per_name.items(), key=lambda kv: -kv[1][1])[:10]:
        print(f"profile_admit:   {t:8.3f} ms {100 * t / busy:5.1f}%  {n:5d} "
              f"launches  {name[:90]}")
    return mine_ms, busy, wall_ms


def profile_scan_admit(cfg, engine, rng, kernel, old, match):
    """One served recurrent admit call (B 1, a 600-token prompt) profiled
    with the scan's new kernel, with the per-step kernel (``old``,
    through the same wrapper), and with the new one again, in turn: the
    scan's share of the call's device time and the call's wall time."""
    for tag, fn in (("new", None), ("per-step", old), ("new", None)):
        call = lambda: profile_admit(cfg, engine, rng, n_req=1, length=600,
                                     match=match, label=f"scan ({tag} kernel)")
        scan_ms, busy, wall = call() if fn is None else with_fn(kernel, fn, call)
        print(f"profile_scan_admit {cfg.name} {tag}: scan {scan_ms:.3f} ms "
              f"= {100 * scan_ms / busy:.1f}% of {busy:.2f} ms device time; "
              f"admit call wall {wall:.2f} ms")


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    else:
        yield tree


def ptxas_entries(log):
    """[(entry function, its register and spill lines)] from the output of
    ``nvcc -Xptxas -v``."""
    entries = []
    for line in log.splitlines():
        if "Compiling entry function" in line:
            entries.append((line.split("'")[1], []))
        elif entries and ("registers" in line or "spill" in line):
            entries[-1][1].append(line.strip().replace("ptxas info    : ", ""))
    return entries


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this script needs an "
              "NVIDIA GPU", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_start = time.monotonic()

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.splitlines()[0]
    print(card)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} device "
          f"{torch.cuda.get_device_name(0)}")

    kernels = [fa_kernel.KERNEL, fd_kernel.KERNEL, rs_kernel.KERNEL,
               ms_kernel.KERNEL, gg_kernel.KERNEL]
    t0 = time.monotonic()
    build_all(kernels)
    print(f"build: {len(kernels)} kernels in {time.monotonic() - t0:.1f} s")
    for k in kernels:   # ptxas: each entry function's report, any warning
        for name, report in ptxas_entries(k.build_log):
            print(f"build {k.name}: {name}: {'; '.join(report)}")
        for line in k.build_log.splitlines():
            if "arning" in line:
                print(f"build {k.name}: {line.strip()}")

    gen = torch.Generator(device="cuda").manual_seed(SEED)
    rows = [prefill_phase(gen), decode_phase(gen), rwkv6_phase(gen),
            mamba_phase(gen)]
    free_card()
    gg_row, gg_path = grouped_gemm_phase(gen, kernels)
    rows.append(gg_row)
    for row in rows:
        print("kernel_check " + json.dumps(row))
    free_card()

    qwen2, rwkv6 = get_config("qwen2-7b"), get_config("rwkv6-7b")
    jamba = dataclasses.replace(get_config("jamba-v0.1-52b"), n_layers=8)
    bf16_ulps = ("bf16 attention and scan outputs may differ by an ulp "
                 "between the two paths; through the layers that moves "
                 "logits of std ~1 by a few bf16 ulps")
    parity_phase(qwen2, 2, 0.1, bf16_ulps)
    parity_phase(rwkv6, 2, 0.1, bf16_ulps)
    parity_phase(jamba, 8, 0.25,
                 bf16_ulps + "; an ulp can also flip a near-tie of the "
                 "top-2 router for one token, which moves that token by "
                 "one expert's output")
    parity_phase(jamba, 8, 2e-3,
                 "fp32 compute and cache, bf16 weights: the kernels differ "
                 "from the chunked plain scans by ~1e-5 relative (their "
                 "exp(+-cumsum)), and no bf16 rounding amplifies it",
                 compute_dtype=torch.float32)
    free_card()

    by_path = {"grouped_gemm op, dropless MoE experts at "
               + ", ".join(MOE_CONFIGS): gg_path}
    by_path["qwen2-7b"], (params, lone) = serving_phase(
        qwen2, kernels, n_req=24, max_new=32, profile_admits=True)
    by_path["fleet qwen2-7b"] = fleet_phase(qwen2, kernels, params, lone,
                                            n_req=24, max_new=32)
    del params, lone
    free_card()
    by_path["rwkv6-7b"] = serving_phase(
        rwkv6, kernels, n_req=24, max_new=32,
        profile_scan=(rs_kernel.KERNEL, per_step_entry(
            rs_kernel.KERNEL, "rwkv6_scan_per_step_fwd", rwkv6_per_step_args),
            "rwkv6_"))[0]
    free_card()
    by_path["jamba-v0.1-52b/8"] = serving_phase(
        jamba, kernels, n_req=24, max_new=32,
        profile_scan=(ms_kernel.KERNEL, per_step_entry(
            ms_kernel.KERNEL, "mamba_scan_per_step_fwd"), "mamba_"))[0]
    free_card()
    launches = {k.name: sum(p[k.name] for p in by_path.values())
                for k in kernels}
    print("launches_by_path " + json.dumps(by_path))

    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err",
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    out = []
    for row in rows:
        row = dict(row, launches=launches[row["name"]])
        out.append({k: row[k] for k in keys})
    print(f"total {time.monotonic() - t_start:.1f} s")
    print(json.dumps({"kernels": out}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
