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
   timing of earlier runs). Prefill attention also runs non-causal at
   seamless-m4t-large-v2's heads (H = KV = 16, D 64) in the
   encoder-decoder's three roles: the encoder (B 2, S = T 1024), a
   prompt's cross-attention (B 2, S 512, T 1024) and the decode step's
   one-row cross query (B 8, S 1, T 1024), then at the speech path's own
   shapes (B 8, 1000 frames: a ragged last kv tile; the 16-token prompts'
   causal self-attention too), each in fp32 and bf16
   (``encdec_attention_phase``); decode also runs at seamless-m4t's and
   internvl2-2b's heads. The grouped
   GEMM, which no model calls, is driven on its own path: a dropless MoE
   feed-forward through the op at the expert widths of olmoe-1b-7b,
   qwen3-moe-30b-a3b and jamba-v0.1-52b, with group sizes from the port's
   router on 1,202 tokens, held against the dense fp32 oracle; then each
   product against the plain version, a skewed case with empty groups, and
   olmoe's capacity buffer against ``_moe_local``'s own einsum. Each
   decode and grouped GEMM row names the kernel the call took;
3b. the kernels in their sharded roles (``sharded_kernel_phase``): the
   decode kernel's partials entry (``flash_decode_partials``) on 4 and 16
   slices of a B 8, L 1024 cache at each slice's global offset, at
   qwen2-7b's and gemma2-9b's heads, bf16 and fp32, combined as the ranks
   combine them and held against ``flash_decode`` on the whole cache and
   against the plain partials; ``flash_attention`` on 16 q slices of
   qwen2-7b's S 4096 at their ``q_offset`` against one unsharded call
   (``sharded_decode {...}``, ``sharded_context {...}``);
4. training, on attention-only layers: the prefill kernel's forward with
   its log-sum-exp against ``_mha_torch``'s (out, lse) at qwen2-7b's
   and internvl2-2b's train_4k (B 2, S 4096), at gemma2-9b's heads (B 1,
   S 5000, D 256, window 4096 binding, softcap 50), at seamless's
   non-causal encoder and cross shapes and in fp32; ``MhaFunction``'s
   dq/dk/dv through the kernels (the forward and ``flash_attention_bwd``)
   against the plain forward and ``_mha_bwd_torch``, and against "ref"
   autograd at B 1, S 300; the forward's time with and without the lse,
   the backward kernel's and the PyTorch backward's, and SDPA's backward
   and forward plus backward beside them (``train_kernel {...}``); then the trace
   readers that the training profiles use, held against the profiler's
   ``key_averages`` on one short window (``trace_readers {...}``). The scans'
   training form at their training shapes (rwkv6 B 2, S 4096, H 64, D 64
   bf16; mamba Bt 2, S 4096, DI 8192, N 16 fp32): ``Rwkv6ScanFunction``
   and ``MambaScanFunction`` through the kernel (one launch a group of 16
   chunks) against autograd through the plain versions, output and every
   gradient; the forward as grouped launches and as one launch, the
   PyTorch backward, forward plus backward and the plain version's, beside
   the backward's bound (``train_scan {...}``). Then training at full
   width with fp32 masters (16 bytes a parameter), 16,384 tokens a step
   (batch 4 as 2 microbatches of 2, seq 4096) on one repeated batch:
   qwen2-7b cut to 8 of its 28 layers (2.98 B parameters; 28 layers would
   need ~123 GB), 6 steps; rwkv6-7b cut to 8 of its 32 layers (2.30 B; 32
   would need ~121 GB), 3 steps; jamba-v0.1-52b cut to the pattern "mm"
   (2 Mamba layers, one with the dense feed-forward and one with all 16
   experts: 3.74 B; one period of 8 would need ~213 GB), 3 steps as 4
   microbatches of 1 (at 2 it ran out of memory); and at full depth
   seamless-m4t-large-v2 (24 encoder and 24 decoder layers, 2.04 B; the
   pipeline's frames as long as the tokens, so the encoder and the
   cross-attention attend over S x T = 4096 x 4096 pairs, non-causal) and
   internvl2-2b (24 layers, 1.90 B, 256 patches a row), 3 steps each. Each:
   loss and gradient norm through the kernels against the plain path
   before any update, the loss falling, each kernel's launches a step
   (attention and the scans: layers x 2 microbatches x forward and remat
   recompute, the scans x 16 groups; the encoder's blocks are recomputed
   too, and seamless runs three attentions a decoder layer and encoder
   layer pair), step ms, tokens/s, share of the
   bf16 peak, peak memory (``train_step {...}``) and one profiled step
   with the backwards' shares (``train_profile {...}``). Then
   ``examples/train_tenant_job_torch.py``'s ``100m`` preset through a live
   ``VirtualClusterFramework``: 3 units of 5 steps, each saving a
   checkpoint, every unit ``Ready``, the last checkpoint restored bit for
   bit (``train_tenant ...``);
5. parity: the same seeded bf16 weights through the kernels and through
   the plain versions, prefill of 2 ragged prompts plus 4 decode steps,
   logits compared: qwen2-7b, rwkv6-7b and gemma2-9b at full width with 2
   layers (gemma2 also in fp32, and at prompts of 5000 and 4500 tokens in a
   cache of 8192 positions, where its 4096-position window binds, with the
   window's effect shown by a run without it: ``window_phase``),
   jamba-v0.1-52b at full width with one period of 8 layers, in bf16 and
   once more in fp32 (compute and cache); seamless-m4t-large-v2 (2
   encoder and 2 decoder layers, 300 seeded frames prefilled into a cross
   cache of 300 rows, the decode steps attending to it) and internvl2-2b
   (2 layers, 256 seeded patches, prompts of 320 and 290 tokens), each in
   bf16 and fp32;
6. serving: each model behind ``ContinuousBatcher`` with 3 WRR tenants
   (weights 1, 1, 2) and seeded bf16 weights, served by two engines on
   the same weights in one process: the default one, whose decode step is
   one CUDA graph captured in its constructor and whose admission is one
   graph per (rows, bucket) shape for attention-only models (captured
   after a shape's first call), and its eager twin (``cuda_graph=False``).
   The eager twin first runs one decode step and, for attention-only
   models, one admit call under ``torch.cuda.set_sync_debug_mode("error")``
   (no op of either body may sync with the host). The same 24 seeded
   requests then drain through the twins in turn, graphed, eager, graphed,
   eager; each drain prints tokens/s, the decode-step median against its
   bound, the admit calls and TTFT p50/p99 per tenant, and the greedy
   tokens must be the same in all four, request by request. Then
   ``torch.profiler`` traces four full-batch decode steps of each twin:
   the device's busy share, and one decode-attention partial and combine
   kernel per attention layer a step, graph replays included. The models:
   qwen2-7b at full width and depth (28 layers), then a trace of one admit
   call (4 prompts of 512) of each twin; rwkv6-7b at full width and depth
   (32 layers), then traces of one served admit call (one prompt of 600)
   with the new scan kernel, the per-step one and the new one again, for
   the scan's share of its device time (jamba likewise); jamba-v0.1-52b at
   full width with one period (8 layers: 7 Mamba, 1 attention, 4 MoE of
   16 experts; its 32 layers, ~104 GB in bf16, do not fit one 80 GB card);
   gemma2-9b at full width and depth (42 layers, alternating "l" and "g",
   softcaps 50 and 30, a tied table of 256,000 rows), then served at
   max_len 8192 with prompts past its window (``long_window_drain``);
   seamless-m4t-large-v2 at full depth (its engine, as the reference's,
   passes no frames: the decoder cross-attends to a zero cross cache of
   max_len rows, one more ``flash_attention`` a layer in every step and
   admit call), then its speech path eagerly (``speech_phase``: B 8, 1000
   frames, prompts of 16, 32 decode steps: prefill ms and the encoder's
   share, the step against its bound, launches); internvl2-2b at full
   depth (24 layers, served as a text model).
   Each model is freed before the next loads. The launch counters, set to
   0 before each drain and read after it, show that every prefill and
   decode went through the kernels (a graph's replay adds the launches its
   capture recorded), and the decode steps through the tensor-core decode
   kernel;
7. admission, after qwen2-7b's serving phase, on its weights: graphed
   against eager admission on one engine with the graphed step
   (``admission_ab``: lines ``admission qwen2-7b ...`` and
   ``admission_ab {...}``);
8. fleet, on the same weights: the same requests through the control
   plane, tenants of a live ``VirtualClusterFramework`` served by a
   ``ServingFleet`` of graphed qwen2-7b replicas on the one card
   (WorkUnits placed by the SuperScheduler, engines built by the node
   agents' providers on the executor's pool threads). Lone, fleet, lone,
   fleet drains, each fleet drain a 0 -> 1 resize under the backlog, must
   give the lone engine's tokens, admit calls and steps; a 0 -> 2 resize
   in one call (both replicas built at once) must give the lone engine's
   tokens for one request per bucket; then 2 replicas with eager and
   graphed admission in turn, 2 -> 3 -> 1 under load must finish every
   request and retire 2 replicas, every unit reaching ``Ready``; each
   fleet run's launches must be the sum over its replicas. Lines
   ``fleet qwen2-7b ...`` and ``fleet_ab {...}`` (``fleet_phase``).

9. roofline, after the last model is freed (``roofline_phase``): the
   dry-run (``repro_torch.launch.dryrun``, a host run over a fake process
   group and fake tensors) of qwen2-7b train_4k on the production 16 x 16
   mesh, then of two cells this run measured on the card, on a mesh of
   one: qwen2-7b's decode step at B 8 against a cache of 1024 (the
   serving phase's graphed step medians) and qwen2-7b cut to 8 layers at
   train_4k, batch 4 as 2 microbatches (``train_phase``'s step median and
   peak memory). Every step-time lower bound must lie at or below its
   measured step times, and the predicted peak memory of the train step
   within ``ROOFLINE_MEM_TOL`` of the measured one (``roofline {...}``).
   gemma2-9b's softcapped attention shapes (prefill, decode, and the
   training forward and backward) are also timed through one compiled
   ``flex_attention`` call, their library time (SDPA has no softcap);

10. multi-GPU, after the last model is freed: qwen2-7b at full width cut
   to 2 layers through the sharded code paths on an NCCL mesh of every
   visible GPU, in processes of their own (``sharded_step_phase``): one
   train step against the port's single-device step, a prefill under the
   prefill plan and 8 decode steps under the decode plan against the
   single-device ones, the kernels' launches in those runs an entry of
   ``launches_by_path`` (``sharded_step {...}``); then
   ``examples/elastic_failover_torch.py`` on the card (``failover ...``).

Every device-wide sync here takes the port's ``CAPTURE_LOCK``, since
engines capture on other threads. The line before the last is ``{"kernels": [...]}``; the last line is
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
from repro_torch.device import CAPTURE_LOCK
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


def sync():
    """A device-wide sync under the port's capture lock: engines may be
    capturing on other threads (a fleet's replicas on pool threads, any
    engine's admission shapes on its drive thread), and CUDA refuses a
    device-wide sync while another thread captures."""
    with CAPTURE_LOCK:
        torch.cuda.synchronize()


def time_ms(fn, iters=20, warmup=3):
    """Mean time of ``fn`` over ``iters`` back-to-back calls between CUDA
    events: the device's time, or the host's time to issue the calls where
    that is longer. Times the plain versions, which sync the host, and the
    kernels' ``events_ms``, the measure their ``ms`` once was."""
    for _ in range(warmup):
        fn()
    sync()
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
    sync()
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
    sync()
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


def flex_attention_call(B, S, T, H, KV, D, *, causal, window, softcap,
                        lengths=None):
    """One call of ``torch.nn.attention.flex_attention`` (compiled with
    ``torch.compile``) that computes the kernels' function where SDPA
    cannot: the tanh softcap as a ``score_mod``, the causal window and,
    for decode (``lengths``: one query row at ``lengths[b] - 1``), each
    row's length as a ``block_mask``. Takes and returns [B, S, H, D]; its
    first call compiles."""
    from torch.nn.attention.flex_attention import (create_block_mask,
                                                   flex_attention)
    off = T - S

    def mask_mod(b, h, q_idx, kv_idx):
        qpos = lengths[b] - 1 if lengths is not None else q_idx + off
        keep = kv_idx <= qpos if (causal or lengths is not None) else \
            kv_idx >= 0
        if window > 0:
            keep = keep & (kv_idx > qpos - window)
        return keep

    def score_mod(score, b, h, q_idx, kv_idx):
        return torch.tanh(score / softcap) * softcap

    block_mask = create_block_mask(mask_mod, B if lengths is not None
                                   else None, None, S, T, device="cuda")
    fn = torch.compile(flex_attention, dynamic=False)

    def call(q, k, v):
        return fn(q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
                  score_mod=score_mod if softcap > 0.0 else None,
                  block_mask=block_mask, enable_gqa=KV < H).transpose(1, 2)
    return call


def flex_library_ms(call, args, want, tol=2e-2):
    """(device ms, note) of ``call(*args)``, compiled before the timed
    window, held against ``want`` (the plain version's output) at ``tol``.
    A library call that fails to build, or computes another function,
    gives no time, and the note says why."""
    try:
        out = call(*args)
        sync()
        err = max_err(out, want)
        if not err <= tol:
            return None, f"flex_attention disagrees: max abs error {err!r}"
        try:
            return graph_ms(lambda: call(*args)), \
                f"flex_attention, compiled (max abs error {err!r})"
        except Exception:      # a compiled call that a graph cannot hold
            return time_ms(lambda: call(*args)), \
                f"flex_attention, compiled, events (max abs error {err!r})"
    except Exception as e:
        return None, f"flex_attention failed: {type(e).__name__}: {e}"[:300]


def prefill_shape(gen, label, B, S, H, KV, D, window, softcap, sdpa, *,
                  T=None, causal=True, iters=20):
    """bf16 prefill attention at a served shape (T keys, S by default;
    causal unless asked otherwise), q, k, v drawn from ``gen``: kernel vs
    plain version (tol 2e-2), its time, the plain version's, SDPA's where
    ``sdpa`` names the call (else None: SDPA has no softcap), and the
    bound. Printed as ``prefill_shape {...}``."""
    T = S if T is None else T
    q, k, v = (torch.randn(shape, generator=gen, device="cuda").bfloat16()
               for shape in ((B, S, H, D), (B, T, KV, D), (B, T, KV, D)))
    kw = dict(causal=causal, window=window, softcap=softcap)
    out = mha(q, k, v, impl="cuda", **kw)
    ref = mha(q, k, v, impl="torch", **kw)
    sync()
    assert torch.isfinite(out.float()).all()
    err = max_err(out, ref)
    check(f"flash_attention {label}", err, 2e-2)
    del out, ref
    ms = graph_ms(lambda: mha(q, k, v, impl="cuda", **kw), iters=iters)
    events_ms = time_ms(lambda: mha(q, k, v, impl="cuda", **kw), iters=iters)
    plain_ms = time_ms(lambda: mha(q, k, v, impl="torch", **kw), iters=3,
                       warmup=1)
    library_ms, library = None, sdpa
    if sdpa is None:      # SDPA has no softcap
        want = mha(q, k, v, impl="torch", **kw)
        library_ms, library = flex_library_ms(flex_attention_call(
            B, S, T, H, KV, D, causal=causal, window=window,
            softcap=softcap), (q, k, v), want)
        del want
    else:
        qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, k, v))
        library_ms = graph_ms(lambda: F.scaled_dot_product_attention(
            qt, kt, vt, is_causal=causal, enable_gqa=True), iters=iters)
    b_ms, b_by = attn_bound(B, S, T, H, KV, D, causal, window)
    flops = 4 * D * attn_pairs(S, T, causal, window) * B * H
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
        sync()
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


ENCDEC_SHAPES = [
    # label, B, S, T, causal: seamless-m4t-large-v2's heads (H = KV = 16,
    # D 64). The kernel phase's shapes (whole kv tiles), then the speech
    # path's own (``speech_phase``: 1000 frames leave a ragged last kv tile)
    ("seamless encoder B2 S1024 T1024", 2, 1024, 1024, False),
    ("seamless cross B2 S512 T1024", 2, 512, 1024, False),
    ("seamless decode cross B8 S1 T1024", 8, 1, 1024, False),
    ("seamless speech encoder B8 S1000 T1000", 8, 1000, 1000, False),
    ("seamless speech self-attention B8 S16 T16", 8, 16, 16, True),
    ("seamless speech cross B8 S16 T1000", 8, 16, 1000, False),
    ("seamless speech decode cross B8 S1 T1000", 8, 1, 1000, False),
]


def encdec_attention_phase():
    """The prefill kernel in the encoder-decoder's roles at seamless's
    heads (H = KV = 16, D 64): bidirectional encoder attention (S = T),
    cross-attention of a prompt to the encoder output (S < T) and the
    decode step's one-row query against the cross cache, all non-causal,
    at the kernel phase's shapes and at the speech path's (with its
    prompts' causal self-attention). Each in fp32 against the plain
    version (tol 2e-5), then timed in bf16 beside the plain version, SDPA
    (no softcap in seamless) and the bound (``prefill_shape``, tol 2e-2).
    Inputs from a generator of their own. Returns the bf16 rows."""
    gen = torch.Generator(device="cuda").manual_seed(SEED + 9)
    H = KV = 16
    D = 64
    rows = []
    for label, B, S, T, causal in ENCDEC_SHAPES:
        kind = "causal" if causal else "non-causal"
        q = torch.randn((B, S, H, D), generator=gen, device="cuda")
        k, v = (torch.randn((B, T, KV, D), generator=gen, device="cuda")
                for _ in range(2))
        out = mha(q, k, v, causal=causal, impl="cuda")
        ref = mha(q, k, v, causal=causal, impl="torch")
        sync()
        check(f"flash_attention {label} H{H} KV{KV} D{D} fp32 {kind}",
              max_err(out, ref), 2e-5)
        del q, k, v, out, ref
        rows.append(prefill_shape(
            gen, f"{label} H{H} KV{KV} D{D} bf16 {kind}", B, S, H, KV, D,
            0, 0.0, sdpa="SDPA, is_causal" if causal else "SDPA, no mask",
            T=T, causal=causal, iters=50 if S <= 16 else 20))
    return rows


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
    sync()
    assert torch.isfinite(out.float()).all()
    err = max_err(out, ref)
    check(f"flash_decode {label}", err, 3e-2)
    ms = graph_ms(lambda: decode_mha(q, kc, vc, lengths, impl="cuda", **kw),
                  iters=50)
    events_ms = time_ms(lambda: decode_mha(q, kc, vc, lengths, impl="cuda",
                                           **kw), iters=50)
    plain_ms = time_ms(lambda: decode_mha(q, kc, vc, lengths, impl="torch",
                                          **kw), iters=10)
    library_ms = None
    library = "none: a window shorter than the cache needs its own mask"
    if softcap > 0.0:     # SDPA has no softcap
        library_ms, library = flex_library_ms(flex_attention_call(
            B, 1, L, H, KV, D, causal=True, window=window, softcap=softcap,
            lengths=lengths), (q, kc, vc), ref, tol=3e-2)
    elif window == 0 or window >= L:
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
    8), gemma2-9b's (D 256, window 4096, softcap 50), seamless-m4t's (H =
    KV = 16, D 64; also at the speech path's cache of 64 positions) and
    internvl2-2b's (H 16, KV 8, D 128), drawn from a
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
            sync()
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
                           4096, 50.0),
              decode_shape(served, "seamless-m4t-large-v2 heads", 8, 1024,
                           16, 16, 64, 0, 0.0),
              decode_shape(served, "seamless-m4t-large-v2 heads, speech "
                           "cache", 8, 64, 16, 16, 64, 0, 0.0),
              decode_shape(served, "internvl2-2b heads", 8, 1024, 16, 8,
                           128, 0, 0.0)]
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
    sync()
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
    sync()
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
        sync()
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
    sync()
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
    sync()

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
    sync()
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


def parity_phase(cfg, n_layers, tol, why, compute_dtype=torch.bfloat16,
                 lens=(100, 37), max_len=256, frames=0):
    """Full width, ``n_layers`` layers (an encoder-decoder's encoder too):
    kernels vs plain versions on the same seeded bf16 weights and inputs,
    computing (and caching K/V) in ``compute_dtype``: two right-padded
    prompts of ``lens`` tokens prefilled into a cache of ``max_len``, with
    ``frames`` seeded frames (x 0.1, as the data pipeline makes them) into
    a cross cache of as many rows for an encoder-decoder, and the
    ``frontend_tokens`` seeded patches for a ``vit_stub`` model; then 4
    decode steps. Returns the kernels' logits [5, 2, 1, vocab] (fp32)."""
    cut = dict(n_layers=n_layers)
    if cfg.is_encdec:
        cut["n_enc_layers"] = n_layers
    cfg2 = dataclasses.replace(cfg, **cut)
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    params = M.init_params(cfg2, generator=gen, device="cuda",
                           dtype=torch.bfloat16)
    rng = np.random.default_rng(SEED)
    lens = np.array(lens, np.int32)
    toks = np.zeros((2, -(-int(lens.max()) // 128) * 128), np.int32)
    for i, n in enumerate(lens):
        toks[i, :n] = rng.integers(0, cfg.vocab, n)
    steps = rng.integers(0, cfg.vocab, (4, 2, 1)).astype(np.int32)
    frontend = {}
    if cfg.is_encdec:
        assert frames > 0
        frontend["frames"] = torch.from_numpy(rng.standard_normal(
            (2, frames, cfg.frontend_dim)).astype(np.float32) * 0.1).cuda()
    elif cfg.frontend == "vit_stub":
        frontend["patches"] = torch.from_numpy(rng.standard_normal(
            (2, cfg.frontend_tokens, cfg.frontend_dim)).astype(
                np.float32)).cuda()
    logits = {}
    for impl in ("cuda", "torch"):
        cache = M.init_cache(cfg2, 2, max_len, enc_len=frames,
                             dtype=compute_dtype, device="cuda")
        out, cache, lengths = M.prefill(
            params, cfg2, torch.from_numpy(toks).cuda(), cache,
            lengths=torch.from_numpy(lens).cuda(), impl=impl,
            compute_dtype=compute_dtype, **frontend)
        seq = [out]
        lengths = lengths + 1
        for s in steps:
            out, cache, lengths = M.decode_step(
                params, cfg2, torch.from_numpy(s).cuda(), cache, lengths,
                impl=impl, compute_dtype=compute_dtype)
            seq.append(out)
        logits[impl] = torch.stack(seq)[..., :cfg.vocab].float()
        del cache
    a, b = logits["cuda"], logits["torch"]
    assert torch.isfinite(a).all() and a.shape == (5, 2, 1, cfg.vocab)
    err = max_err(a, b)
    agree = float((a.argmax(-1) == b.argmax(-1)).float().mean())
    fe = {k: tuple(v.shape) for k, v in frontend.items()}
    print(f"parity {cfg.name} full width, {n_layers} layers, "
          f"{str(compute_dtype).split('.')[-1]}, prompts {lens.tolist()}, "
          f"frontend {fe}, max_len {max_len}, window {cfg.sliding_window}: "
          f"logits "
          f"max_abs_err={err!r} (logit std {float(b.std())!r}), argmax "
          f"agreement {agree!r}; tolerance {tol}: {why}")
    check(f"parity logits {cfg.name} {compute_dtype} prompts "
          f"{lens.tolist()} window {cfg.sliding_window}", err, tol)
    del params
    return a


BF16_ULPS = ("bf16 attention and scan outputs may differ by an ulp between "
             "the two paths; through the layers that moves logits of std ~1 "
             "by a few bf16 ulps")


def encdec_parity_phase(seamless, internvl):
    """``parity_phase`` for the encoder-decoder (300 seeded frames into a
    cross cache of 300 rows, the decode steps attending to it) and the
    ``vit_stub`` frontend (256 patches, then 64 and 34 prompt tokens past
    them), 2 layers each, bf16 and fp32. The limits come from the readings
    on an H100 80GB HBM3 (700 W): 0.03125 in bf16 for both models (one ulp
    of the largest logits, |logit| in [4, 8), std 0.88), 2.7e-6 and 2.3e-6
    in fp32; each limit is twice the bf16 reading and ~8x the fp32 ones."""
    read = ("; measured 0.03125 on an H100, one bf16 ulp of the largest "
            "logits (in [4, 8)): the limit is two")
    fp32 = ("fp32 compute and cache, bf16 weights: the fp32 kernels and the "
            "plain versions sum in other orders (~1e-6 relative), logits of "
            "std ~1; measured 2.7e-6 (seamless) and 2.3e-6 (internvl2-2b) "
            "on an H100")
    parity_phase(seamless, 2, 0.0625, BF16_ULPS + read, frames=300)
    parity_phase(seamless, 2, 2e-5, fp32, compute_dtype=torch.float32,
                 frames=300)
    parity_phase(internvl, 2, 0.0625, BF16_ULPS + read, lens=(320, 290),
                 max_len=512)
    parity_phase(internvl, 2, 2e-5, fp32, compute_dtype=torch.float32,
                 lens=(320, 290), max_len=512)


def window_phase(cfg, tol, why):
    """The sliding window where it binds: ``cfg`` (gemma2-9b) at full
    width with 2 layers ("l", then "g"), a cache of 8192 positions and
    prompts of 5000 and 4500 tokens, past the 4096-position window, then 4
    decode steps at positions 5000-5003 and 4500-4503. The kernels' logits
    against the plain versions' (``parity_phase``), then the same with the
    window removed; the two kernel runs must differ (the kernels are
    deterministic, so any difference is the window's: the "l" layer masks
    keys in prefill and in decode). Returns the difference."""
    lens, max_len = (5000, 4500), 8192
    assert min(lens) > cfg.sliding_window and max(lens) + 5 < max_len
    windowed = parity_phase(cfg, 2, tol, why, lens=lens, max_len=max_len)
    free_card()
    opened = parity_phase(dataclasses.replace(cfg, sliding_window=0), 2, tol,
                          why, lens=lens, max_len=max_len)
    diff = max_err(windowed, opened)
    print(f"window {cfg.name}: the kernels' logits with and without the "
          f"{cfg.sliding_window}-position window differ by up to {diff!r} "
          f"at prompts {list(lens)} (the window binds)")
    assert diff > 0, "the window changed no logit"
    free_card()
    return diff


def serving_phase(cfg, kernels, *, n_req, max_new, profile_admits=False,
                  profile_scan=None, record=None):
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
    weights and the graphed engine (the fleet phase's lone twin). With
    ``record`` (a dict) its "step_ms" gets the graphed drains' decode-step
    medians."""
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    t0 = time.monotonic()
    params = M.init_params(cfg, generator=gen, device="cuda",
                           dtype=torch.bfloat16)
    sync()
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
        sync()
        build_ms[graphed] = (time.perf_counter() - t0) * 1e3
        assert (engine._graph is not None) == graphed
        assert engine._graph_admit == (graphed and not engine._exact_buckets)
        if not graphed:
            sync_free_step(cfg, engine)
            if not engine._exact_buckets:
                sync_free_admit(cfg, engine)
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
    w_bytes = decode_weight_bytes(cfg, params)
    cache_bytes = sum(t.numel() * t.element_size()
                      for t in _leaves(engine.cache))
    step_bound_ms = (w_bytes + cache_bytes) / HBM_BYTES_PER_S * 1e3
    print(f"serving {cfg.name}: decode step bound {step_bound_ms:.2f} ms "
          f"({(w_bytes + cache_bytes) / 1e9:.2f} GB of weights and cache per "
          f"step at 3.35 TB/s: weights {w_bytes / 1e9:.3f} GB, cache "
          f"{cache_bytes / 1e9:.3f} GB)")

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
    if record is not None:
        record["step_ms"] = [r["step_median_ms"] for r in runs
                             if r["twin"] == "graphed"]
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
    admit_profile = {}
    if profile_admits:     # the graphed twin's second call replays a graph
        for g in (True, False):
            ms, busy_ms, wall = profile_admit(
                cfg, twins[g][0], np.random.default_rng(SEED + 2),
                label=f"prefill attention, {label[g]} admission")
            admit_profile[label[g]] = {"attention_ms": ms, "busy_ms": busy_ms,
                                       "wall_ms": wall}
    if profile_scan:
        profile_scan_admit(cfg, engine, np.random.default_rng(SEED + 2),
                           *profile_scan)
    print("serving_ab " + json.dumps({
        "model": cfg.name, "layers": cfg.n_layers,
        "step_bound_ms": step_bound_ms,
        "construct_ms": {label[g]: build_ms[g] for g in (True, False)},
        "profile": busy, "admit_profile": admit_profile,
        "admit_graphs": sorted(engine._admit_graphs),
        "drains": [{k: r[k] for k in ("twin", "tokens_s", "step_median_ms",
                                      "ttft_ms", "admits")} for r in runs]}))
    return runs[0]["launches"], (params, engine)


def decode_weight_bytes(cfg, params):
    """Bytes of the matrices a decode step reads: every parameter of two or
    more dimensions, less the embedding table where the head has its own
    (only the step's rows are gathered), and less what the step never
    reads: the encoder, ``frontend_proj`` and the cross-attention's K/V
    projections (the step attends to the cached cross K/V)."""
    skip = ("/enc_blocks/", "/frontend_proj/", "/cross/wk/", "/cross/wv/")
    if not cfg.tie_embeddings:
        skip += ("/embed/",)
    return sum(t.numel() * t.element_size()
               for key, t in _flat_items(params) if t.dim() >= 2
               and not any(k in key + "/" for k in skip))


def sync_free_step(cfg, engine):
    """One eager decode step of ``engine`` under
    ``torch.cuda.set_sync_debug_mode("error")``: an op of the step that
    syncs with the host raises here (a CUDA graph could not hold it). It
    calls ``_step``, the body the graph captures, on one admitted slot,
    since ``step()`` ends in its one host sync by design; the request is
    then drained and dropped."""
    engine.admit_many([S.Request(0, np.arange(16, dtype=np.int32), 4)])
    sync()
    torch.cuda.set_sync_debug_mode("error")
    try:
        engine._step()
    finally:
        torch.cuda.set_sync_debug_mode(0)
    sync()
    while engine.active_slots():
        engine.step()
    print(f"serving {cfg.name}: one eager decode step under sync debug mode "
          f"'error': no op synced")


def sync_free_admit(cfg, engine):
    """One eager admit call of ``engine`` under
    ``torch.cuda.set_sync_debug_mode("error")``: ``_admit_staged``, the body
    an admission graph captures, on a staged buffer of 2 prompts of 12 and
    7 tokens (bucket 16) into two free slots, with a budget of one token,
    so that both slots stay free."""
    rng = np.random.default_rng(SEED + 5)
    k, pad_len = 2, 16
    lens = np.array([12, 7], np.int32)
    prompts = np.zeros((k, pad_len), np.int32)
    for j, n in enumerate(lens):
        prompts[j, :n] = rng.integers(0, cfg.vocab, n)
    idx = np.asarray(engine.free_slots()[:k], np.int32)
    buf = torch.from_numpy(np.concatenate(
        [prompts.reshape(-1), idx, lens, np.ones(k, np.int32)])).cuda()
    sync()
    torch.cuda.set_sync_debug_mode("error")
    try:
        first = engine._admit_staged(buf, k, pad_len)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    first = first.cpu()
    assert bool(((first >= 0) & (first < cfg.vocab)).all()), first
    assert not bool(engine._active.any())
    print(f"serving {cfg.name}: one eager admit call ({k} x {pad_len}) under "
          f"sync debug mode 'error': no op synced")


def long_window_drain(cfg, kernels, params, *, max_new=8):
    """Full-depth ``cfg`` (gemma2-9b) served at max_len 8192, so that its
    4096-position window binds: one graphed engine of 4 slots (2.82 GB of
    cache a slot), prompts of 5000, 4200, 700 and 100 tokens (admit calls
    of 2 x 8191, 1 x 1024 and 1 x 128), ``max_new`` tokens each, drained
    three times, its graph admission cleared, then set (each shape captured
    after its first call), then set again (every call replays). Gated:
    greedy tokens identical in all three, each drain's launches
    ``expected_launches``, the third drain all replays. Prints a
    ``long_window {...}`` line; returns the first graphed drain's
    launches."""
    weights = {"tenant-a": 1, "tenant-b": 1, "tenant-c": 2}
    mem = {"before the engine": memory_gb()}
    engine = S.GenerationEngine(cfg, params, slots=4, max_len=8192)
    sync()
    mem["engine built (decode graph)"] = memory_gb()
    assert engine._graph_admit and cfg.sliding_window < 4200
    sched = S.SlotScheduler()
    for t, w in weights.items():
        sched.register_tenant(t, weight=w)
    batcher = S.ContinuousBatcher(engine, scheduler=sched)
    rng = np.random.default_rng(SEED + 7)
    reqs = [(list(weights)[i % len(weights)], rng.integers(0, cfg.vocab, n))
            for i, n in enumerate((5000, 4200, 700, 100))]
    runs = []
    for graph_admit in (False, True, True):
        engine._graph_admit = graph_admit
        replays = engine.admit_replays
        r = drain(cfg, engine, batcher, kernels, weights, len(reqs), max_new,
                  reqs=reqs)
        r["twin"] = "graphed admission" if graph_admit else "eager admission"
        r["admit_replays"] = engine.admit_replays - replays
        runs.append(r)
        a = r["admits"]
        print(f"long_window {cfg.name} max_len 8192 {r['twin']}: "
              f"{r['tokens_total']} tokens in {r['wall_s']:.3f} s; "
              f"{a['calls']} admit calls, median {a['median_ms']:.1f} ms, in "
              f"all {a['total_ms']:.1f} ms ({r['admit_replays']} replays); "
              f"decode step median {r['step_median_ms']:.2f} ms over "
              f"{r['steps']} steps; launches {r['launches']}")
    mem["after its admission graphs"] = memory_gb()
    for r in runs[1:]:
        assert r["tokens"] == runs[0]["tokens"], \
            f"{cfg.name}: the {r['twin']} drain's greedy tokens differ"
    assert runs[2]["admit_replays"] == runs[2]["counters"]["admit_calls"] == 3
    pools = {"decode graph": pool_gb(engine._graph.pool()),
             "admission graphs": pool_gb(engine._admit_pool)}
    print(f"long_window {cfg.name}: greedy tokens identical in all 3 drains "
          f"(eager, graphed, graphed admission); graph pools {pools} GB")
    drop = ("tokens",)
    print("long_window " + json.dumps({
        "model": cfg.name, "layers": cfg.n_layers, "slots": 4,
        "max_len": 8192, "prompt_lengths": [len(p) for _, p in reqs],
        "graph_pools_gb": pools, "memory_gb": mem,
        "drains": [{k: v for k, v in r.items() if k not in drop}
                   for r in runs]}))
    del engine, batcher
    free_card()
    return runs[1]["launches"]


def speech_phase(cfg, kernels, params, *, B=8, n_frames=1000, prompt=16,
                 steps=32):
    """seamless at full depth on its speech path, eagerly (the engine takes
    no frames, as the reference's): ``B`` utterances of ``n_frames`` seeded
    frames (x 0.1, as the data pipeline makes them) and prompts of
    ``prompt`` tokens, one prefill with the frames into a cache whose cross
    K/V hold ``n_frames`` rows, then ``steps`` greedy decode steps. After a
    warm-up prefill: the prefill's ms (host clock, synced) and the
    encoder's share of it (the encoder alone on the same frames), each
    decode step's ms against its bound (the matrices the step reads, and
    the whole cache: self K/V and cross K/V, at 3.35 TB/s), and each
    kernel's launches, counted from 0 before the prefill: the prefill
    launches ``flash_attention`` three times a layer (encoder, causal
    self-attention, cross-attention) and every step once a layer (the
    one-row cross query) beside one ``flash_decode``. Returns the
    launches."""
    from repro_torch.models.transformer import _encode
    t_phase = time.monotonic()
    rng = np.random.default_rng(SEED + 11)
    frames = torch.from_numpy(rng.standard_normal(
        (B, n_frames, cfg.frontend_dim)).astype(np.float32) * 0.1).cuda()
    toks = torch.from_numpy(rng.integers(
        0, cfg.vocab, (B, prompt)).astype(np.int32)).cuda()
    cache = M.init_cache(cfg, B, prompt + steps + 16, enc_len=n_frames,
                         device="cuda")
    cache_bytes = sum(t.numel() * t.element_size() for t in _leaves(cache))
    w_bytes = decode_weight_bytes(cfg, params)
    bound_ms = (w_bytes + cache_bytes) / HBM_BYTES_PER_S * 1e3
    with torch.inference_mode():
        M.prefill(params, cfg, toks, cache, frames=frames)    # warm-up
        sync()
        enc_ms = []
        for _ in range(3):
            t0 = time.perf_counter()
            _encode(params, frames, cfg, None, torch.bfloat16)
            sync()
            enc_ms.append((time.perf_counter() - t0) * 1e3)
        for k in kernels:
            k.launches = 0
        t0 = time.perf_counter()
        logits, cache, lengths = M.prefill(params, cfg, toks, cache,
                                           frames=frames)
        sync()
        prefill_ms = (time.perf_counter() - t0) * 1e3
        assert bool(cache["sub0"]["cross_k"].abs().amax() > 0)
        out, step_ms = [], []
        lengths = lengths + 1
        for _ in range(steps):
            assert bool(torch.isfinite(logits).all())
            nxt = logits[:, 0, :cfg.vocab].argmax(dim=-1).int()[:, None]
            out.append(nxt)
            sync()
            t0 = time.perf_counter()
            logits, cache, lengths = M.decode_step(params, cfg, nxt, cache,
                                                   lengths)
            sync()
            step_ms.append((time.perf_counter() - t0) * 1e3)
        launches = {k.name: k.launches for k in kernels}
    attn = cfg.n_blocks * cfg.layer_pattern.count("g")
    want = {"flash_attention": cfg.n_enc_layers + 2 * attn + attn * steps,
            "flash_decode": attn * steps}
    assert {k: launches[k] for k in want} == want, (launches, want)
    enc = float(np.median(enc_ms))
    row = {"model": cfg.name, "layers": cfg.n_layers,
           "enc_layers": cfg.n_enc_layers, "batch": B, "frames": n_frames,
           "prompt": prompt, "steps": steps, "prefill_ms": prefill_ms,
           "encoder_ms": enc, "encoder_share": enc / prefill_ms,
           "step_ms_median": float(np.median(step_ms)),
           "step_bound_ms": bound_ms, "step_bound_gb": {
               "weights": w_bytes / 1e9, "cache": cache_bytes / 1e9},
           "launches": launches,
           "tokens": torch.cat(out, dim=1)[0, :8].tolist()}
    print(f"speech {cfg.name}: {B} x {n_frames} frames, prompts of {prompt}: "
          f"prefill {prefill_ms:.1f} ms, the encoder {enc:.1f} ms of it "
          f"({100 * enc / prefill_ms:.1f}%); decode step median "
          f"{row['step_ms_median']:.2f} ms over {steps} eager steps (bound "
          f"{bound_ms:.3f} ms); launches {launches}")
    print("speech " + json.dumps(row))
    del cache, logits
    free_card()
    print(f"speech {cfg.name}: phase {time.monotonic() - t_phase:.1f} s")
    return launches


def memory_gb():
    """The allocator's allocated and reserved memory on the card, GB."""
    return {"allocated": torch.cuda.memory_allocated() / 1e9,
            "reserved": torch.cuda.memory_reserved() / 1e9}


def pool_gb(pool):
    """GB of the allocator's segments in CUDA-graph memory pool ``pool``,
    from its snapshot; None where this torch's snapshot names no pools."""
    segs = torch.cuda.memory_snapshot()
    if segs and "segment_pool_id" not in segs[0]:
        return None
    return sum(sg["total_size"] for sg in segs
               if tuple(sg["segment_pool_id"]) == tuple(pool)) / 1e9


def admission_ab(cfg, kernels, params, *, n_req, max_new):
    """Graphed against eager admission in one process: one engine (8
    slots, max_len 1024, graphed decode step) on ``serving_phase``'s
    weights, its graph admission cleared and set in turn (eager, graphed,
    eager, graphed), the serving drains' requests each time. The first
    graphed drain captures each (rows, bucket) shape after its first call
    (each capture's host time noted); the second replays every call. Gated:
    greedy tokens identical in all four, each drain's launches
    ``expected_launches`` (a replay adds what its capture recorded), the
    second graphed drain all replays. Prints each drain and an
    ``admission_ab`` JSON line: admit-call medians and sums, TTFT, tokens/s,
    the graphs with their capture ms, and the engine's memory before and
    after its admission graphs (allocated, reserved, and the pools of its
    decode and admission graphs). Returns the first graphed drain's
    launches."""
    weights = {"tenant-a": 1, "tenant-b": 1, "tenant-c": 2}
    mem = {"before the engine": memory_gb()}
    engine = S.GenerationEngine(cfg, params, slots=8, max_len=1024)
    sync()
    assert engine._graph is not None and engine._graph_admit
    mem["engine built (decode graph)"] = memory_gb()
    captures = []
    capture = engine._capture_admit

    def timed_capture(k, pad_len):
        t0 = time.perf_counter()
        capture(k, pad_len)
        captures.append({"rows": k, "bucket": pad_len,
                         "ms": (time.perf_counter() - t0) * 1e3})

    engine._capture_admit = timed_capture
    sched = S.SlotScheduler()
    for t, w in weights.items():
        sched.register_tenant(t, weight=w)
    batcher = S.ContinuousBatcher(engine, scheduler=sched)
    engine._graph_admit = False         # the warm-up request, eagerly
    batcher.submit(warmup_prompt(cfg), max_new_tokens=2)
    batcher.run_until_drained()
    label = {True: "graphed admission", False: "eager admission"}
    runs = []
    for graph_admit in (False, True, False, True):
        engine._graph_admit = graph_admit
        replays, graphs = engine.admit_replays, len(engine._admit_graphs)
        r = drain(cfg, engine, batcher, kernels, weights, n_req, max_new)
        r.update(twin=label[graph_admit],
                 admit_replays=engine.admit_replays - replays,
                 graphs_captured=len(engine._admit_graphs) - graphs)
        if graph_admit and "after its admission graphs" not in mem:
            mem["after its admission graphs"] = memory_gb()
        runs.append(r)
        a = r["admits"]
        print(f"admission {cfg.name} {r['twin']}: {r['tokens_s']:.1f} "
              f"tokens/s; {a['calls']} admit calls, median "
              f"{a['median_ms']:.1f} ms, in all {a['total_ms']:.1f} ms "
              f"({r['admit_replays']} replays, {r['graphs_captured']} graphs "
              f"captured); decode step median {r['step_median_ms']:.2f} ms; "
              f"launches {r['launches']}")
        for t in weights:
            p50, p99, mx = r["ttft_ms"][t]
            print(f"admission {cfg.name} {r['twin']}: {t} (weight "
                  f"{weights[t]}) TTFT p50 {p50:.1f} ms p99 {p99:.1f} ms "
                  f"max {mx:.1f} ms")
    for r in runs[1:]:
        assert r["tokens"] == runs[0]["tokens"], \
            f"{cfg.name}: the {r['twin']} drain's greedy tokens differ"
    assert runs[0]["admit_replays"] == runs[2]["admit_replays"] == 0
    assert runs[1]["graphs_captured"] == len(engine._admit_graphs) > 0
    assert runs[3]["graphs_captured"] == 0
    assert runs[3]["admit_replays"] == runs[3]["counters"]["admit_calls"]
    pools = {"decode graph": pool_gb(engine._graph.pool()),
             "admission graphs": pool_gb(engine._admit_pool)}
    print(f"admission {cfg.name}: greedy tokens identical in all 4 drains; "
          f"{len(captures)} admission graphs captured, "
          f"{sum(c['ms'] for c in captures):.1f} ms in all; graph pools "
          f"{pools} GB; memory {mem}")
    drop = ("tokens",)
    print("admission_ab " + json.dumps({
        "model": cfg.name, "layers": cfg.n_layers, "slots": 8,
        "max_len": 1024, "captures": captures, "graph_pools_gb": pools,
        "memory_gb": mem,
        "drains": [{k: v for k, v in r.items() if k not in drop}
                   for r in runs]}))
    return runs[1]["launches"]


def drain(cfg, engine, batcher, kernels, weights, n_req, max_new,
          reqs=None):
    """Submit ``n_req`` seeded requests (the same in every drain: 16-600
    prompt tokens, ``max_new`` new ones, tenant-major flood over
    ``weights``; or ``reqs``, (tenant, prompt) pairs), drain them, and
    check the drain: every request complete, each kernel's launches
    ``expected_launches``, host syncs = admit calls + steps, no whole-cache
    copy. Returns its numbers and each request's tokens in submission
    order."""
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
        if reqs is None:
            reqs = drain_requests(cfg, weights, n_req)
        uids = {batcher.submit(prompt, max_new_tokens=max_new,
                               tenant=tenant): tenant
                for tenant, prompt in reqs}
        for k in kernels:
            k.launches = 0
        t0 = time.monotonic()
        batcher.run_until_drained()
        sync()
        wall = time.monotonic() - t0
        launches = {k.name: k.launches for k in kernels}
    finally:
        del engine.step          # the class's method again
    after = engine.counters()
    d = {key: after[key] - before[key] for key in after}
    done = batcher.completed
    assert len(done) == len(reqs) and set(done) == set(uids), "requests lost"
    for uid, r in done.items():
        assert r.done and len(r.tokens) == max_new, (uid, len(r.tokens))
        assert all(0 <= t < cfg.vocab for t in r.tokens)
    want = expected_launches(cfg, d)
    assert launches == want, (launches, want, d)
    assert all(launches[k] > 0 for k, n in want.items() if n), launches
    assert d["host_syncs"] == d["admit_calls"] + d["steps"], d
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


def distinct_requests(cfg, weights, lengths=(5, 12, 30, 60, 120, 250, 500,
                                             800)):
    """Seeded (tenant, prompt) pairs, one prompt per admission bucket of a
    max_len 1024 engine (buckets 8 to 1023): every admit call then holds
    one row, whichever engine takes the request, so each replica computes
    each request as a lone engine does (a bf16 product over another number
    of rows may differ in its last bit)."""
    rng = np.random.default_rng(SEED + 6)
    return [(list(weights)[i % len(weights)], rng.integers(0, cfg.vocab, n))
            for i, n in enumerate(lengths)]


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
    reference). An encoder-decoder's cross-attention adds one prefill
    launch per attention layer to every admit call and every decode step
    (a one-row query against the cross cache)."""
    layers = {kind: cfg.n_blocks * cfg.layer_pattern.count(kind)
              for kind in "glmr"}
    attn = layers["g"] + layers["l"]
    cross = attn if cfg.is_encdec else 0
    admits, steps = counters["admit_calls"], counters["steps"]
    return {"flash_attention": attn * admits + cross * (admits + steps),
            "flash_attention_bwd": 0, "flash_decode": attn * steps,
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
    4. 0 -> 2 replicas in one resize, both built at once on pool threads
       (their captures take turns under the port's capture lock), under a
       backlog of one request per admission bucket
       (``distinct_requests``). Gated: those requests' tokens equal the
       lone engine's (every admit call holds one row, whichever replica
       takes it).
    5. The requests drained by the 2 replicas with their admission eager
       and graphed in turn (eager, graphed, eager, graphed: each engine's
       graph admission cleared or set), then at a 0.5 ms switch interval
       (how much the replicas' drive threads wait for each other's
       interpreter lock); again with 3 replicas asked for while they are
       in flight; back to 1 once they are done. Gated: every request
       completes, 2 replicas retire, only ``engine-0`` is left. Counted,
       not gated: the requests whose tokens equal the lone drains'
       (admission groups differ, and a bf16 product over another number
       of rows may differ in its last bit).

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
        sync()
        launches = {k.name: k.launches for k in kernels}
        want = dict.fromkeys(launches, 0)
        for b in builds:
            engine = b["engine"]
            c0 = before.get(engine, dict.fromkeys(engine.counters(), 0))
            d = {key: v - c0[key] for key, v in engine.counters().items()}
            assert d["host_syncs"] == d["admit_calls"] + d["steps"], d
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
        if runs and len(tokens) == n_req:
            r["same_tokens_as_lone"] = sum(
                t == w for t, w in zip(tokens, runs[0]["tokens"]))
        if engine is not None:
            r.update(steps=len(step_ms[engine]), counters=engine.counters(),
                     step_median_ms=float(np.median(step_ms[engine])),
                     step_total_ms=float(np.sum(step_ms[engine])))
        return r

    def report(r):
        line = (f"fleet {cfg.name} {r['side']}: {len(r['tokens'])} requests, "
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
            line += (f"; {r['same_tokens_as_lone']} of {len(r['tokens'])} "
                     f"requests' "
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

    def lone_drain(side, drain_reqs=None):
        sched = S.SlotScheduler()
        for t, w in weights.items():
            sched.register_tenant(t, weight=w)
        r = drain(cfg, lone, S.ContinuousBatcher(lone, scheduler=sched),
                  kernels, weights, n_req, max_new, reqs=drain_reqs)
        r["side"] = side
        report(r)
        if drain_reqs is None:
            runs.append(r)
        return r

    def fleet_drain():
        """The requests, then a 0 -> 1 resize."""
        assert fleet.live_replicas() == 0
        fleet.pop_completed()
        uids = [fleet.submit(t, p, max_new_tokens=max_new) for t, p in reqs]
        resize(1)
        done = fleet_wait(fleet, len(uids), errors)
        return [done[u] for u in uids], builds[-1]["engine"]

    def under_load():
        """0 -> 2 replicas in one resize under a backlog of one request per
        bucket; the requests drained by both with eager and graphed
        admission in turn, then at a 0.5 ms switch interval; again with a
        third replica asked for while they are in flight; back to 1."""
        fleet.pop_completed()
        uids = [fleet.submit(t, p, max_new_tokens=max_new)
                for t, p in distinct]
        resize(2)
        done = fleet_wait(fleet, len(uids), errors)
        r = summary("0 -> 2 replicas, one request a bucket",
                    [done[u] for u in uids])
        r["same_tokens_as_lone"] = sum(
            t == w for t, w in zip(r["tokens"], distinct_lone["tokens"]))
        assert r["tokens"] == distinct_lone["tokens"], \
            f"{cfg.name}: a replica's tokens differ from the lone engine's"
        out = [r]
        for label, interval, graph_admit in (
                ("2 replicas, eager admission", None, False),
                ("2 replicas, graphed admission", None, True),
                ("2 replicas, eager admission", None, False),
                ("2 replicas, graphed admission", None, True),
                ("2 replicas, switch interval 0.5 ms", 5e-4, True),
                ("2 -> 3 replicas", None, True)):
            for b in builds[n_before:]:
                b["engine"]._graph_admit = graph_admit
            replays = {b["engine"]: b["engine"].admit_replays
                       for b in builds[n_before:]}
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
            r["admit_replays"] = sum(e.admit_replays - n
                                     for e, n in replays.items())
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

            distinct = distinct_requests(cfg, weights)
            distinct_lone = lone_drain("lone, one request a bucket", distinct)
            retired0 = fleet.retired
            n_before = len(builds)
            scale, launches = fleet_run(under_load)
            mem["after the scale-down to 1"] = torch.cuda.memory_allocated()
            units = sorted(u.metadata.name for u in fw.super_api.list(
                "WorkUnit", S.SERVING_NS, copy=False))
            assert fleet.retired - retired0 == 2, fleet.retired
            assert fleet.live_replicas() == 1 and units == ["engine-0"], units
            assert len(builds) == n_before + 3
            for r in scale:
                report(r)
            print(f"fleet {cfg.name} 0 -> 2 -> 3 -> 1: launches {launches}; "
                  f"retired {fleet.retired} in all, 2 in this run; units "
                  f"{units}")
            replicas = {}
            for b in builds[n_before:]:
                engine = b["engine"]
                replicas[labels[engine]] = engine.counters()
                print(f"fleet {cfg.name} 0 -> 2 -> 3 -> 1: {labels[engine]} "
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
        "scale_0_2_3_1": {"runs": [{k: v for k, v in r.items()
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
    would run one at the start of every capture (the engine drives
    ``capture_begin`` itself, which runs none)."""
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
    with CAPTURE_LOCK:
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
    sync()
    steps0 = engine.steps
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(n_steps):
            batcher.pump()
        sync()
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


def trace_events(prof):
    """A profiler's raw Kineto events, hidden ones left out. Read directly:
    ``prof.events()`` first builds a tree of Python ``FunctionEvent``s,
    which took 130 s of host time for one seamless train step (~10^5
    kernels); these readers take seconds."""
    return [e for e in prof.profiler.kineto_results.events()
            if not getattr(e, "is_hidden_event", lambda: False)()]


def device_ms_by_name(prof):
    """{kernel name: (launches, device ms)} from a profiler's CUDA events."""
    from torch.autograd import DeviceType
    per_name = {}
    for e in trace_events(prof):
        if e.device_type() == DeviceType.CUDA:
            n, t = per_name.get(e.name(), (0, 0.0))
            per_name[e.name()] = (n + 1, t + e.duration_ns() / 1e6)
    return per_name


def node_device_ms(prof, nodes):
    """{node: device ms} of the kernels launched inside each autograd node
    whose name holds ``node`` (its ``device_time_total`` in
    ``key_averages``): a kernel belongs to the CPU op that launched it (its
    ``linked_correlation_id``), and an op to a node when it starts inside
    the node's time range on the node's thread."""
    from bisect import bisect_right
    from torch.autograd import DeviceType
    kernel_ns, ops = {}, []
    ranges = {node: {} for node in nodes}
    for e in trace_events(prof):
        if e.device_type() == DeviceType.CUDA:
            cid = e.linked_correlation_id()
            kernel_ns[cid] = kernel_ns.get(cid, 0) + e.duration_ns()
        elif (e.device_type() == DeviceType.CPU and not e.is_async()
              and e.linked_correlation_id() == 0):    # an op, not a launch
            thread = e.start_thread_id()
            ops.append((e.correlation_id(), thread, e.start_ns()))
            for node in nodes:
                if node in e.name():
                    ranges[node].setdefault(thread, []).append(
                        (e.start_ns(), e.end_ns()))
    out = {}
    for node, by_thread in ranges.items():
        merged = {}
        for thread, spans in by_thread.items():
            m = []
            for lo, hi in sorted(spans):      # nested spans: keep the outer
                if m and lo <= m[-1][1]:
                    m[-1][1] = max(m[-1][1], hi)
                else:
                    m.append([lo, hi])
            merged[thread] = ([lo for lo, _ in m], m)
        ns = 0
        for cid, thread, start in ops:
            if cid in kernel_ns and thread in merged:
                starts, m = merged[thread]
                i = bisect_right(starts, start) - 1
                if i >= 0 and start <= m[i][1]:
                    ns += kernel_ns[cid]
        out[node] = ns / 1e6
    return out


def trace_readers_phase(gen):
    """``device_ms_by_name`` and ``node_device_ms`` read the profiler's
    private Kineto events and redo ``key_averages``' attribution; hold them
    against the public ``key_averages`` on one short profiled window, so
    that a torch whose events or attribution differ fails here and not in
    the training profiles' shares: ``MhaFunction``'s forward and backward
    through the kernels (B 1, S 1024, H 8, D 64, bf16, causal).
    Device kernels: the same count and total; the backward node: the same
    device time. Each event may differ by 1 us (a torch that rounds its
    events' times to whole microseconds)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    node = "MhaFunctionBackward"
    q, k, v = (torch.randn((1, 1024, 8, 64), generator=gen, device="cuda")
               .bfloat16().requires_grad_() for _ in range(3))
    mha(q, k, v, causal=True, impl="cuda").float().square().sum().backward()
    sync()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        mha(q, k, v, causal=True,
            impl="cuda").float().square().sum().backward()
        sync()
    per_name = device_ms_by_name(prof)
    n = sum(c for c, _ in per_name.values())
    busy = sum(t for _, t in per_name.values())
    node_ms = node_device_ms(prof, [node])[node]
    avg = prof.key_averages()
    want_n = sum(e.count for e in avg if e.device_type == DeviceType.CUDA)
    want_busy = sum(e.device_time_total for e in avg
                    if e.device_type == DeviceType.CUDA) / 1e3
    want_node = max(e.device_time_total for e in avg if node in e.key) / 1e3
    row = {"kernels": n, "key_averages_kernels": want_n, "busy_ms": busy,
           "key_averages_busy_ms": want_busy, "node_ms": node_ms,
           "key_averages_node_ms": want_node}
    print("trace_readers " + json.dumps(row))
    assert n == want_n > 0, row
    assert abs(busy - want_busy) <= n * 1e-3, row
    assert 0 < node_ms < busy and abs(node_ms - want_node) <= n * 1e-3, row


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
    sync()
    calls0 = engine.admit_calls
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        done = engine.admit_many(reqs(20_000))
        sync()
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


TRAIN_SHAPES = [
    # label, B, S, T, H, KV, D, causal, window, softcap, dtype, tolerance
    ("qwen2-7b train_4k B2 S4096 H28 KV4 D128 bf16 causal", 2, 4096, 4096,
     28, 4, 128, True, 0, 0.0, torch.bfloat16, 2e-2),
    ("internvl2-2b train_4k B2 S4096 H16 KV8 D128 bf16 causal", 2, 4096,
     4096, 16, 8, 128, True, 0, 0.0, torch.bfloat16, 2e-2),
    ("gemma2-9b heads B1 S5000 H16 KV8 D256 bf16 causal window 4096 "
     "softcap 50", 1, 5000, 5000, 16, 8, 256, True, 4096, 50.0,
     torch.bfloat16, 2e-2),
    ("seamless encoder heads B2 S1024 H16 KV16 D64 bf16 non-causal", 2, 1024,
     1024, 16, 16, 64, False, 0, 0.0, torch.bfloat16, 2e-2),
    ("seamless cross heads B2 S512 T1024 H16 KV16 D64 bf16 non-causal", 2,
     512, 1024, 16, 16, 64, False, 0, 0.0, torch.bfloat16, 2e-2),
    ("qwen2-7b heads B1 S1024 H28 KV4 D128 fp32 causal", 1, 1024, 1024, 28, 4,
     128, True, 0, 0.0, torch.float32, 2e-5),
]
LSE_TOL = 1e-4   # fp32 statistics on both sides: summation order, SFU exp2
GRAD_TOL = 2e-2  # of the gradient's largest magnitude: see check_grad


def check_grad(name, got, want, tol=GRAD_TOL):
    """Max abs error of a gradient within ``tol`` of the largest |want|
    (returned). For bf16 gradients ``GRAD_TOL``: the flash backward rounds
    p and ds to bf16 before its products (as the reference does), so a
    forward that differs by an output ulp, or the fp32 "ref" autograd,
    moves a gradient by an ulp or two of its largest values (0.5% of the
    scale on the CPU at B 1, S 300)."""
    assert torch.isfinite(got.float()).all()
    scale = float(want.float().abs().max())
    err = max_err(got, want)
    print(f"check {name}: max_abs_err={err!r} of max |grad| {scale!r}")
    check(f"{name} (relative to max |grad|)", err / scale, tol)
    return err / scale


def attn_train_bound(B, S, T, H, D, window, causal=True):
    """Forward: 4 D FLOP per attended (q, k) pair and head; backward: 10 D
    (recomputed scores, dP, dQ, dK, dV), 2.5x the forward; the kernel's two
    passes recompute the scores and dP twice, 14 D (3.5x). All bound by the
    operations at training shapes."""
    fwd = 4 * D * attn_pairs(S, T, causal, window) * B * H
    return fwd, 2.5 * fwd, 3.5 * fwd


def train_kernel_phase(gen):
    """Attention's training form on the card: the kernel's forward with
    its lse (``return_lse``) against ``_mha_torch``'s (out, lse) at the
    training shapes (``TRAIN_SHAPES``: qwen2-7b's and internvl2-2b's
    train_4k, gemma2-9b's heads at S 5000 where its window binds,
    seamless's non-causal encoder and cross shapes, and fp32), then
    ``MhaFunction``'s dq/dk/dv through the kernels (forward and
    ``flash_attention_bwd``) against the plain forward and
    ``_mha_bwd_torch``, then times: the kernel's forward with and without
    the lse, the backward kernel's and the plain backward's device time,
    forward plus backward, against SDPA's backward and forward plus
    backward (for gemma2's softcap and window, ``flex_attention``'s), each
    beside its bound (``bwd_bound_ms``: five products; ``bwd7_bound_ms``:
    the kernel's seven). Lines ``train_kernel {...}``; returns the first
    (qwen2) row."""
    from repro_torch.kernels.flash_attention.ops import (MhaFunction,
                                                         _mha_bwd_torch,
                                                         _mha_torch)
    rows = []
    for (label, B, S, T, H, KV, D, causal, window, softcap, dtype,
         tol) in TRAIN_SHAPES:
        q = torch.randn((B, S, H, D), generator=gen, device="cuda").to(dtype)
        k, v = (torch.randn((B, T, KV, D), generator=gen,
                            device="cuda").to(dtype) for _ in range(2))
        dout = torch.randn((B, S, H, D), generator=gen,
                           device="cuda").to(dtype)
        qoff = T - S if causal else 0
        kw = dict(causal=causal, window=window, softcap=softcap, scale=None,
                  q_offset=qoff, q_chunk=1024, kv_chunk=1024)
        fkw = dict(causal=causal, window=window, softcap=softcap,
                   q_offset=qoff)
        out, lse = fa_kernel.flash_attention(q, k, v, return_lse=True, **fkw)
        ref, ref_lse = _mha_torch(q, k, v, **kw)
        sync()
        assert torch.isfinite(lse).all() and lse.shape == (B, S, H)
        err = max_err(out, ref)
        lse_err = max_err(lse.view(B, S, KV, H // KV), ref_lse)
        check(f"flash_attention fwd {label}", err, tol)
        check(f"flash_attention lse {label}", lse_err, LSE_TOL)
        # gradients: the kernels' forward and backward against the plain
        # forward and backward
        grads = {}
        for impl in ("cuda", "torch"):
            leaves = [t.detach().requires_grad_(True) for t in (q, k, v)]
            o = MhaFunction.apply(*leaves, impl, kw)
            grads[impl] = torch.autograd.grad(o, leaves, dout)
            del o, leaves
        for name, a, b in zip(("dq", "dk", "dv"), grads["cuda"],
                              grads["torch"]):
            check_grad(f"MhaFunction {name} cuda vs torch {label}", a, b)
        del grads, ref, ref_lse
        fwd_flops, bwd_flops, bwd7_flops = attn_train_bound(
            B, S, T, H, D, window, causal)
        row = {"shape": label, "max_abs_err": err, "lse_max_abs_err": lse_err,
               "tolerance": tol, "lse_tolerance": LSE_TOL,
               "fwd_bound_ms": fwd_flops / PEAK_FLOPS["bfloat16"] * 1e3,
               "bwd_bound_ms": bwd_flops / PEAK_FLOPS["bfloat16"] * 1e3,
               "bwd7_bound_ms": bwd7_flops / PEAK_FLOPS["bfloat16"] * 1e3,
               "fwd_gflop": fwd_flops / 1e9}
        if dtype == torch.bfloat16:
            row["fwd_ms"] = graph_ms(lambda: fa_kernel.flash_attention(
                q, k, v, **fkw))
            row["fwd_lse_ms"] = graph_ms(lambda: fa_kernel.flash_attention(
                q, k, v, return_lse=True, **fkw))
            row["plain_fwd_ms"] = time_ms(lambda: _mha_torch(q, k, v, **kw),
                                          iters=2, warmup=1)
            lse4 = lse.view(B, S, KV, H // KV)
            row["bwd_ms"] = graph_ms(lambda: _mha_bwd_torch(
                q, k, v, out, lse4, dout, **kw), iters=2, replays=2)
            row["bwd_kernel_ms"] = graph_ms(
                lambda: fa_kernel.flash_attention_bwd(q, k, v, out, lse, dout,
                                                      **fkw))
            leaves = [t.detach().requires_grad_(True) for t in (q, k, v)]

            def mine():
                o = MhaFunction.apply(*leaves, "cuda", kw)
                torch.autograd.grad(o, leaves, dout)
            row["fwd_bwd_ms"] = time_ms(mine, iters=3, warmup=1)
            row["sdpa_fwd_ms"] = row["sdpa_fwd_bwd_ms"] = None
            row["sdpa_bwd_ms"] = None
            if softcap == 0.0 and window == 0:
                qt, kt, vt = (t.transpose(1, 2).detach().requires_grad_(True)
                              for t in (q, k, v))
                dt = dout.transpose(1, 2)
                row["sdpa_fwd_ms"] = graph_ms(
                    lambda: F.scaled_dot_product_attention(
                        qt.detach(), kt.detach(), vt.detach(),
                        is_causal=causal, enable_gqa=True))

                def sdpa():
                    o = F.scaled_dot_product_attention(
                        qt, kt, vt, is_causal=causal, enable_gqa=True)
                    torch.autograd.grad(o, (qt, kt, vt), dt)
                row["sdpa_fwd_bwd_ms"] = time_ms(sdpa, iters=3, warmup=1)
                o_sdpa = F.scaled_dot_product_attention(
                    qt, kt, vt, is_causal=causal, enable_gqa=True)
                row["sdpa_bwd_ms"] = time_ms(lambda: torch.autograd.grad(
                    o_sdpa, (qt, kt, vt), dt, retain_graph=True), iters=5,
                    warmup=1)
                del qt, kt, vt, o_sdpa
            else:         # SDPA has no softcap: flex_attention's fwd + bwd
                call = flex_attention_call(B, S, T, H, KV, D, causal=causal,
                                           window=window, softcap=softcap)
                row["flex_fwd_ms"], row["flex_note"] = flex_library_ms(
                    call, (q, k, v), out)
                row["flex_fwd_bwd_ms"] = None
                if row["flex_fwd_ms"] is not None:
                    flex_leaves = [t.detach().requires_grad_(True)
                                   for t in (q, k, v)]

                    def flex():
                        o = call(*flex_leaves)
                        torch.autograd.grad(o, flex_leaves, dout)
                    try:    # the first call compiles the backward too
                        row["flex_fwd_bwd_ms"] = time_ms(flex, iters=3,
                                                         warmup=1)
                    except Exception as e:
                        row["flex_note"] += (f"; backward failed: "
                                             f"{type(e).__name__}: {e}")[:300]
                    del flex_leaves
            del leaves
        del out, lse
        print("train_kernel " + json.dumps(row))
        rows.append(row)
        free_card()
    # against "ref" autograd (materialized softmax, fp32) at B 1, S 300
    q, k, v, dout = (torch.randn(shape, generator=gen, device="cuda").bfloat16()
                     for shape in ((1, 300, 28, 128), (1, 300, 4, 128),
                                   (1, 300, 4, 128), (1, 300, 28, 128)))
    grads = {}
    for impl in ("cuda", "ref"):
        leaves = [t.detach().requires_grad_(True) for t in (q, k, v)]
        o = mha(*leaves, impl=impl)
        grads[impl] = torch.autograd.grad(o, leaves, dout)
    for name, a, b in zip(("dq", "dk", "dv"), grads["cuda"], grads["ref"]):
        check_grad(f"MhaFunction {name} cuda vs ref autograd B1 S300 H28 KV4 "
                   "D128 bf16", a, b)
    return rows[0]


SCAN_TRAIN = {
    # scan: (shape, what the train step hands over)
    "rwkv6_scan": ((2, 4096, 64, 64), "rwkv6-7b heads, bf16 r/k/v and u "
                   "(the train step's copies), fp32 w, no initial state"),
    "mamba_scan": ((2, 4096, 8192, 16), "jamba d_inner and d_state, fp32, "
                   "A = -(1..16), dt from a softplus, no initial state"),
}
SCAN_GRAD_TOL = {"rwkv6_scan": GRAD_TOL, "mamba_scan": 1e-3}


def scan_train_case(gen, name):
    """(inputs, the Function's call on them with an impl, the plain
    version, the one-launch kernel call, the cotangent of the output) of
    ``name`` at its training shape (``SCAN_TRAIN``), drawn from ``gen``."""
    from repro_torch.kernels.mamba_scan.ops import (MambaScanFunction,
                                                    _mamba_torch)
    from repro_torch.kernels.rwkv6_scan.ops import (Rwkv6ScanFunction,
                                                    _rwkv6_torch)
    shape = SCAN_TRAIN[name][0]

    def randn(*dims, scale=1.0):
        return torch.randn(dims, generator=gen, device="cuda") * scale

    if name == "rwkv6_scan":
        B, S, H, D = shape
        r, k, v = (randn(B, S, H, D, scale=0.5).bfloat16() for _ in range(3))
        w = torch.exp(-torch.exp(randn(B, S, H, D, scale=0.5)))
        u = randn(H, D, scale=0.1).bfloat16()
        dout = randn(B, S, H, D).bfloat16()
        return ((r, k, v, w, u),
                lambda impl, *t: Rwkv6ScanFunction.apply(*t, None, impl, 16),
                lambda *t: _rwkv6_torch(*t, None, chunk=16),
                lambda: rs_kernel.rwkv6_scan(r, k, v, w, u.float()), dout)
    Bt, S, DI, N = shape
    x = randn(Bt, S, DI, scale=0.5)
    dt = F.softplus(randn(Bt, S, DI))
    A = -torch.arange(1, N + 1, dtype=torch.float32, device="cuda").expand(
        DI, N).contiguous()
    Bm, Cm = randn(Bt, S, N, scale=0.5), randn(Bt, S, N, scale=0.5)
    D = torch.ones(DI, device="cuda")
    return ((x, dt, A, Bm, Cm, D),
            lambda impl, *t: MambaScanFunction.apply(*t, None, impl, 16),
            lambda *t: _mamba_torch(*t, None, chunk=16),
            lambda: ms_kernel.mamba_scan(x, dt, A, Bm, Cm, D),
            randn(Bt, S, DI))


def scan_bwd_bound(name, groups):
    """The scans' backward: the inputs, the output's cotangent and each
    group's saved entry state read once, the gradients written once; twice
    the forward's per-step fp32 operations (``rwkv6_bound``'s and the
    mamba row's rules) at 67 TFLOP/s. Returns (ms, by what, bytes)."""
    if name == "rwkv6_scan":
        B, S, H, D = SCAN_TRAIN[name][0]
        n = B * S * H * D
        io = n * (3 * 2 + 4) + H * D * 2          # r, k, v bf16, w fp32, u
        nbytes = 2 * io + 2 * n + groups * B * H * D * D * 4
        flops = 2 * (5 * n * D + 4 * n)
    else:
        Bt, S, DI, N = SCAN_TRAIN[name][0]
        n = Bt * S * DI
        io = 4 * (2 * n + DI * N + 2 * Bt * S * N + DI)   # x, dt, A, B, C, D
        nbytes = 2 * io + 4 * n + groups * Bt * DI * N * 4
        flops = 2 * 8 * n * N
    b_ms, b_by = bound(nbytes, flops, "float32")
    return b_ms, b_by, nbytes


def train_scan_phase(gen):
    """Each scan's training form at its training shape (``SCAN_TRAIN``):
    ``Rwkv6ScanFunction`` / ``MambaScanFunction`` through the kernel
    against autograd through the plain version (``_rwkv6_torch`` /
    ``_mamba_torch``) on the same inputs and output cotangent: the output
    (rwkv6 one bf16 ulp, 5e-2; mamba 1e-3) and every gradient (of its
    largest magnitude: ``SCAN_GRAD_TOL``; the backward is the same PyTorch
    recompute on both, from entry states that the kernel gives to 1e-3).
    Times: the forward as the Function's grouped launches and as one
    launch (device time, ``graph_ms``), the backward alone (the Function's
    backward replayed on a retained graph, CUDA events around back-to-back
    calls: mostly the host issuing its small kernels), the Function's
    forward plus backward and the plain version's, beside the backward's
    bound. Lines ``train_scan {...}``."""
    from repro_torch.kernels.scan_groups import group_bounds
    rows = []
    t0 = time.monotonic()
    for name, (shape, what) in SCAN_TRAIN.items():
        kernel = rs_kernel.KERNEL if name == "rwkv6_scan" else ms_kernel.KERNEL
        ins, fn, plain, one_launch, dout = scan_train_case(gen, name)
        S = shape[1]
        groups = len(group_bounds(S, 16))
        leaves = [t.detach().requires_grad_(True) for t in ins]
        kernel.launches = 0
        out, state = fn("cuda", *leaves)
        assert kernel.launches == groups, (kernel.launches, groups)
        grads = torch.autograd.grad(out, leaves, dout, retain_graph=True)
        pleaves = [t.detach().requires_grad_(True) for t in ins]
        pout, pstate = plain(*pleaves)
        pgrads = torch.autograd.grad(pout, pleaves, dout)
        sync()
        out_tol = 5e-2 if name == "rwkv6_scan" else 1e-3
        out_err = max_err(out, pout)
        check(f"{name} Function out through the kernel vs plain", out_err,
              out_tol)
        check(f"{name} Function final state vs plain",
              max_err(state, pstate), 1e-3)
        names = (("r", "k", "v", "w", "u") if name == "rwkv6_scan"
                 else ("x", "dt", "A", "B", "C", "D"))
        grad_errs = {n: check_grad(f"{name} Function d{n} vs plain autograd",
                                   g, p, SCAN_GRAD_TOL[name])
                     for n, g, p in zip(names, grads, pgrads)}
        del pout, pstate, pgrads, pleaves
        free_card()
        with torch.no_grad():
            fwd_ms = graph_ms(lambda: fn("cuda", *ins), iters=5, replays=2)
            one_ms = graph_ms(one_launch, iters=5, replays=2)
        bwd_ms = time_ms(lambda: torch.autograd.grad(
            out, leaves, dout, retain_graph=True), iters=3, warmup=1)
        del out, state, grads
        fwd_bwd_ms = time_ms(lambda: torch.autograd.grad(
            fn("cuda", *leaves)[0], leaves, dout), iters=3, warmup=1)
        plain_ms = time_ms(lambda: torch.autograd.grad(
            plain(*leaves)[0], leaves, dout), iters=1, warmup=1)
        b_ms, b_by, nbytes = scan_bwd_bound(name, groups)
        row = {"scan": name, "shape": f"{shape}: {what}", "groups": groups,
               "fwd_grouped_ms": fwd_ms, "fwd_one_launch_ms": one_ms,
               "bwd_ms": bwd_ms, "fwd_bwd_ms": fwd_bwd_ms,
               "plain_fwd_bwd_ms": plain_ms, "bwd_bound_ms": b_ms,
               "bwd_bound_by": b_by, "bwd_bound_bytes": nbytes,
               "out_max_abs_err": out_err, "out_tolerance": out_tol,
               "grad_rel_errors": grad_errs,
               "grad_tolerance": SCAN_GRAD_TOL[name], "library_ms": None}
        print("train_scan " + json.dumps(row))
        rows.append(row)
        del leaves, ins, dout
        free_card()
    print(f"train_scan: phase {time.monotonic() - t0:.1f} s")
    return rows


def train_phase(cfg, kernels, cut, steps=6, microbatches=2, batch=4,
                seq=4096, record=None):
    """``cfg`` at full width, cut by ``cut`` (a depth, and for jamba a
    shorter pattern), fp32 masters (parameters, gradients, m and v: 16
    bytes a parameter), bf16 compute: train_4k's sequence of 4096 at batch
    4 as 2 microbatches of 2. First the loss and the global gradient norm
    through the kernels against ``impl="torch"`` on the same weights and
    batch (before any update), then ``steps`` steps on one repeated batch
    (the loss must fall from the first to the last), with step ms,
    tokens/s, the share of peak, peak memory and each kernel's launches a
    step (the main path, its counts read after the steps: attention twice
    a layer and microbatch, forward and remat recompute; a scan as often,
    one launch a group of 16 chunks), then one profiled step with the
    shares of attention's backward (a kernel) and the scans' (PyTorch).
    Returns the
    path's launches; with ``record`` (a dict) the ``train_step`` row goes
    into it."""
    from repro_torch.data import DataConfig, SyntheticTokens
    from repro_torch.kernels.scan_groups import group_bounds
    from repro_torch.models.config import ShapeConfig
    from repro_torch.training import (OptimizerConfig, compute_grads,
                                      global_norm, make_opt_state,
                                      make_train_step)
    from repro_torch.training.optimizer import tree_leaves
    t_phase = time.monotonic()
    full_layers = cfg.n_layers
    cfg = dataclasses.replace(cfg, **cut)
    n_layers = cfg.n_layers
    enc = (f" and {cfg.n_enc_layers} encoder layers" if cfg.is_encdec
           else "")
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    params = M.init_params(cfg, generator=gen, device="cuda",
                           dtype=torch.float32)
    n_params = sum(p.numel() for p in tree_leaves(params))
    # products per token: every parameter outside the embedding, the MoE
    # experts at top_k of n_experts
    n_matmul = (n_params - params["embed"]["table"].numel()
                - (cfg.num_params() - cfg.num_active_params()))
    shape = ShapeConfig("train_4k", seq, batch, "train")
    data = SyntheticTokens(cfg, shape, DataConfig(seed=SEED)).batch_at(0)
    tokens = batch * seq
    print(f"train {cfg.name}: {n_layers} of {full_layers} layers{enc} "
          f"(pattern {cfg.layer_pattern}), {n_params / 1e9:.3f} "
          f"B parameters ({n_matmul / 1e9:.3f} B active outside the "
          f"embedding, {16 * n_params / 1e9:.1f} GB at 16 bytes each), "
          f"fp32 masters, batch {batch} x {seq} as {microbatches} "
          f"microbatches, {tokens} tokens a step")
    got, grads_s = {}, {}
    for impl in ("cuda", "torch"):
        t0 = time.monotonic()
        loss, _, grads = compute_grads(cfg, params, data, remat=True,
                                       microbatches=microbatches, impl=impl)
        got[impl] = (float(loss), float(global_norm(grads)))
        del grads
        free_card()
        grads_s[impl] = time.monotonic() - t0
    (lc, nc), (lt, nt) = got["cuda"], got["torch"]
    print(f"train {cfg.name}: before any update, loss {lc!r} (kernel) vs "
          f"{lt!r} (plain), grad norm {nc!r} vs {nt!r} (their gradients in "
          f"{grads_s['cuda']:.1f} s and {grads_s['torch']:.1f} s)")
    why = ("bf16 attention and scan outputs differ by about an ulp "
           "between the two forwards; the loss is a mean over "
           f"{tokens} tokens and the norm runs over {n_params / 1e9:.2f} B "
           "gradients, so both move far less than that")
    check(f"train loss kernel vs plain, relative ({why})",
          abs(lc / lt - 1), 2e-3)
    check("train grad norm kernel vs plain, relative", abs(nc / nt - 1), 2e-2)

    # Adam's first steps move every parameter by about the learning rate,
    # whatever its gradient: on this repeated batch a peak of 1e-4 swung
    # the loss (12.5, 10.4, 14.0, 13.0, 8.4, 9.7 on the card), 3e-5 much
    # less (12.5, 7.5, 8.6, 6.8, 5.3, 5.6)
    opt_cfg = OptimizerConfig(peak_lr=3e-5, warmup_steps=2, total_steps=50)
    step = make_train_step(cfg, opt_cfg, remat=True,
                           microbatches=microbatches)
    opt = make_opt_state(params)
    for k in kernels:
        k.launches = 0
    torch.cuda.reset_peak_memory_stats()
    losses, step_ms = [], []
    for _ in range(steps):
        sync()
        t0 = time.perf_counter()
        params, opt, metrics = step(params, opt, data)
        loss = float(metrics["loss"])
        sync()
        step_ms.append((time.perf_counter() - t0) * 1e3)
        losses.append(loss)
    launches = {k.name: k.launches for k in kernels}
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    per_step = {name: n / steps for name, n in launches.items()}
    layers = {kind: cfg.n_blocks * cfg.layer_pattern.count(kind)
              for kind in "glmr"}
    attn_layers = layers["g"] + layers["l"]
    # bidirectional calls: the encoder's self-attention and the decoder's
    # cross-attention to it (the frames are as long as the tokens)
    bidir = (cfg.n_enc_layers + attn_layers) if cfg.is_encdec else 0
    calls = microbatches * 2       # a layer's forward and remat recompute
    groups = len(group_bounds(seq, 16))
    want = {"flash_attention": (attn_layers + bidir) * calls,
            "flash_attention_bwd": (attn_layers + bidir) * microbatches,
            "flash_decode": 0,
            "rwkv6_scan": layers["r"] * calls * groups,
            "mamba_scan": layers["m"] * calls * groups, "grouped_gemm": 0}
    print(f"train {cfg.name}: losses {losses}, grad norm "
          f"{float(metrics['grad_norm'])!r}, lr {float(metrics['lr'])!r}")
    assert all(np.isfinite(losses)) and losses[-1] < losses[0], losses
    assert per_step == want, (per_step, want)
    ms = float(np.median(step_ms[1:]))
    attn_fwd, attn_bwd, _ = attn_train_bound(batch // microbatches, seq, seq,
                                             cfg.n_heads, cfg.head_dim, 0)
    bi_fwd, bi_bwd, _ = attn_train_bound(batch // microbatches, seq, seq,
                                         cfg.n_heads, cfg.head_dim, 0,
                                         causal=False)
    flops = (6 * n_matmul * tokens      # the scans' fp32 work: < 0.1% of it
             + (attn_fwd + attn_bwd) * attn_layers * microbatches
             + (bi_fwd + bi_bwd) * bidir * microbatches)
    peak_s = flops / PEAK_FLOPS["bfloat16"]
    row = {"model": cfg.name, "layers": n_layers,
           "enc_layers": cfg.n_enc_layers, "params": n_params,
           "tokens_per_step": tokens, "step_ms": step_ms,
           "step_ms_median": ms, "tokens_per_s": tokens / (ms / 1e3),
           "model_tflop_per_step": flops / 1e12,
           "peak_step_ms": peak_s * 1e3, "share_of_peak": peak_s / (ms / 1e3),
           "peak_allocated_gb": peak_gb, "losses": losses,
           "launches_per_step": {k: n for k, n in per_step.items() if n}}
    print("train_step " + json.dumps(row))
    if record is not None:
        record.update(row)

    # one profiled step: device busy share, attention forward (kernel) and
    # the backwards of attention and the scans (their Functions' backward
    # nodes, with every kernel they launch)
    from torch.profiler import ProfilerActivity, profile
    sync()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        params, opt, metrics = step(params, opt, data)
        float(metrics["loss"])
        sync()
        wall_ms = (time.perf_counter() - t0) * 1e3
        t_trace = time.monotonic()     # the profiler's stop and our reading
    per_name = device_ms_by_name(prof)
    busy = sum(t for _, t in per_name.values())
    assert busy > 0, "the profiler recorded no device time"
    parts = (("attention", "attn_fwd", "MhaFunctionBackward"),
             ("rwkv6_scan", "rwkv6_", "Rwkv6ScanFunctionBackward"),
             ("mamba_scan", "mamba_", "MambaScanFunctionBackward"))
    node_ms = node_device_ms(prof, [node for _, _, node in parts])
    prof_row = {"model": cfg.name, "wall_ms": wall_ms, "busy_ms": busy,
                "busy_share": busy / wall_ms}
    for label, kernel_match, node in parts:
        kernel_ms = sum(t for name, (_, t) in per_name.items()
                        if kernel_match in name)
        bwd_ms = node_ms[node]
        if kernel_ms or bwd_ms:
            prof_row.update({f"{label}_fwd_kernel_ms": kernel_ms,
                             f"{label}_fwd_kernel_share": kernel_ms / busy,
                             f"{label}_bwd_ms": bwd_ms,
                             f"{label}_bwd_share": bwd_ms / busy})
    prof_row["trace_reading_s"] = time.monotonic() - t_trace
    print("train_profile " + json.dumps(prof_row))
    for name, (n, t) in sorted(per_name.items(), key=lambda kv: -kv[1][1])[:8]:
        print(f"train_profile:   {t:9.3f} ms {100 * t / busy:5.1f}%  {n:6d} "
              f"launches  {name[:90]}")
    del params, opt, metrics
    free_card()
    print(f"train {cfg.name}: phase {time.monotonic() - t_phase:.1f} s")
    return launches


def train_tenant_phase(kernels, units=3, steps_per_unit=5, preset="100m"):
    """``examples/train_tenant_job_torch.py``'s ``100m`` preset (the
    reference's preset for real hardware: 12 layers, d 768, 12 heads, KV
    4, head dim 64, d_ff 2048, vocab 32768, seq 512, batch 8) through a
    live ``VirtualClusterFramework``: ``units`` WorkUnits of
    ``steps_per_unit`` train steps, each saving a checkpoint; every unit
    must reach Ready, and the last checkpoint, restored into fresh tensors,
    must equal the live state bit for bit. Returns the path's launches."""
    import importlib.util
    import tempfile
    from repro_torch.training.optimizer import tree_leaves, tree_map
    path = Path(__file__).resolve().parent / "examples" / \
        "train_tenant_job_torch.py"
    spec = importlib.util.spec_from_file_location("train_tenant_job_torch",
                                                  path)
    example = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(example)
    for k in kernels:
        k.launches = 0
    with tempfile.TemporaryDirectory() as ckpt_dir:
        t0 = time.monotonic()
        out = example.run(preset, units=units, steps_per_unit=steps_per_unit,
                          ckpt_dir=ckpt_dir, device="cuda",
                          log=lambda m: print(f"train_tenant: {m}"))
        wall = time.monotonic() - t0
        launches = {k.name: k.launches for k in kernels}
        for rec in out["units"]:
            print("train_tenant_unit " + json.dumps(rec))
        assert [r["phase"] for r in out["units"]] == ["Ready"] * units
        live = (out["state"]["params"], out["state"]["opt"])
        restored, step = out["mgr"].restore(
            tuple(tree_map(torch.zeros_like, t) for t in live))
        assert step == units * steps_per_unit
        same = all(torch.equal(a, b) for a, b in zip(
            tree_leaves(restored[0]) + tree_leaves(restored[1]),
            tree_leaves(live[0]) + tree_leaves(live[1])))
        print(f"train_tenant: {units} units of {steps_per_unit} steps in "
              f"{wall:.1f} s, losses {out['state']['losses']}; checkpoint "
              f"of step {step} restored bit for bit: {same}")
        assert same, "the restored checkpoint differs from the live state"
    cfg = out["cfg"]
    want = cfg.n_layers * 2 * units * steps_per_unit
    assert launches["flash_attention"] == want, (launches, want)
    del out, live, restored
    free_card()
    return launches


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    else:
        yield tree


def _flat_items(tree, prefix=""):
    """(path, leaf) pairs of a tree of dicts, paths as "/a/b"."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _flat_items(v, f"{prefix}/{k}")
    else:
        yield prefix, tree


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


# ------------------------------------------------------------ multi-GPU

SHARDED_HEADS = (("qwen2-7b heads", 28, 4, 128, 0, 0.0),
                 ("gemma2-9b heads", 16, 8, 256, 4096, 50.0),
                 # a window that binds and spans slices
                 ("gemma2-9b heads", 16, 8, 256, 300, 50.0))


def combine_partials(parts, shape):
    """The cross-rank combine of ``_decode_mha_seq_sharded`` in one
    process: the slices' (acc, m, l), max-rescaled and summed, divided."""
    m_g = torch.stack([p[1] for p in parts]).amax(0)
    corr = [torch.exp(p[1] - m_g) for p in parts]
    l_g = sum(p[2] * c for p, c in zip(parts, corr))
    acc_g = sum(p[0] * c[..., None] for p, c in zip(parts, corr))
    return (acc_g / (l_g[..., None] + 1e-30)).reshape(shape)


def sharded_kernel_phase(gen):
    """The kernels in their sharded roles, each rank's slice in one
    process. Decode: ``flash_decode_partials`` on 4 and 16 slices of a B 8,
    L 1024 cache (ragged lengths, 1 and L among them, so that some slices
    hold no valid row) at each slice's global offset, at qwen2-7b's heads
    and gemma2-9b's (D 256, softcap 50; window 4096, and 300 where it binds
    across slices), bf16 and fp32: the
    slices combined as the ranks combine them, held against
    ``flash_decode`` on the whole cache and against the plain partials
    (``_decode_partials(pos_offset=...)``) combined alike (2e-2 bf16, 2e-5
    fp32); the n slices' calls timed together against the bound of the
    same function, beside the whole-cache call (lines ``sharded_decode
    {...}``). Context attention: qwen2-7b's 28 heads, B 1, S 4096 cut into
    16 q slices of 256, each through ``flash_attention`` at its
    ``q_offset`` against the whole K/V, held against one unsharded call
    and against the plain version (2e-2), timed (``sharded_context
    {...}``). No launch here counts toward a path."""
    from repro_torch.kernels.flash_attention.ops import _decode_partials
    B, L = 8, 1024
    rows = []
    for label, H, KV, D, window, softcap in SHARDED_HEADS:
        kc = torch.randn((B, L, KV, D), generator=gen, device="cuda")
        vc = torch.randn((B, L, KV, D), generator=gen, device="cuda")
        q32 = torch.randn((B, 1, H, D), generator=gen, device="cuda")
        lengths = torch.randint(2, L, (B,), generator=gen, device="cuda",
                                dtype=torch.int32)
        lengths[0], lengths[1] = 1, L
        kw = dict(window=window, softcap=softcap)
        for dtype, tol in ((torch.bfloat16, 2e-2), (torch.float32, 2e-5)):
            q, k, v = (t.to(dtype) for t in (q32, kc, vc))
            whole = decode_mha(q, k, v, lengths, impl="cuda", **kw)
            for n in (4, 16):
                Ll = L // n
                ks = [k[:, i * Ll:(i + 1) * Ll].contiguous() for i in range(n)]
                vs = [v[:, i * Ll:(i + 1) * Ll].contiguous() for i in range(n)]

                def kernel_parts():
                    return [fd_kernel.flash_decode_partials(
                        q, ks[i], vs[i], lengths, pos_offset=i * Ll, **kw)
                        for i in range(n)]

                def plain_parts():
                    return [_decode_partials(
                        q, ks[i], vs[i], lengths, pos_offset=i * Ll,
                        scale=None, kv_chunk=2048, **kw) for i in range(n)]
                got = combine_partials(kernel_parts(), q.shape).to(dtype)
                plain = combine_partials(plain_parts(), q.shape).to(dtype)
                sync()
                assert torch.isfinite(got.float()).all()
                err_whole, err_plain = max_err(got, whole), max_err(got, plain)
                name = (f"flash_decode_partials {label} {n} slices "
                        f"{str(dtype).split('.')[-1]}")
                check(name + " vs whole cache", err_whole, tol)
                check(name + " vs plain", err_plain, tol)
                ms = graph_ms(kernel_parts, iters=10)
                whole_ms = graph_ms(lambda: decode_mha(
                    q, k, v, lengths, impl="cuda", **kw), iters=10)
                plain_ms = time_ms(plain_parts, iters=3, warmup=1)
                b_ms, b_by = decode_bound(lengths, B, H, KV, D, window)
                row = {"shape": f"{label} B{B} L{L} ({n} slices of {Ll}) "
                                f"H{H} KV{KV} D{D} "
                                f"{str(dtype).split('.')[-1]}, window "
                                f"{window}, softcap {softcap}",
                       "kernel": fd_kernel.variant(q, k),
                       "max_abs_err": max(err_whole, err_plain),
                       "err_vs_whole": err_whole, "err_vs_plain": err_plain,
                       "tolerance": tol, "ms": ms, "whole_cache_ms": whole_ms,
                       "plain_ms": plain_ms, "bound_ms": b_ms,
                       "bound_by": b_by}
                print("sharded_decode " + json.dumps(row))
                rows.append(row)
        del kc, vc, q32
    B, S, H, KV, D, n = 1, 4096, 28, 4, 128, 16
    q, k, v = (torch.randn(shape, generator=gen, device="cuda").bfloat16()
               for shape in ((B, S, H, D), (B, S, KV, D), (B, S, KV, D)))
    Sl = S // n
    qs = [q[:, i * Sl:(i + 1) * Sl].contiguous() for i in range(n)]

    def sliced(impl):
        return torch.cat([mha(qs[i], k, v, causal=True, q_offset=i * Sl,
                              impl=impl) for i in range(n)], dim=1)
    whole = mha(q, k, v, causal=True, impl="cuda")
    got, plain = sliced("cuda"), sliced("torch")
    sync()
    err_whole, err_plain = max_err(got, whole), max_err(got, plain)
    check("flash_attention context slices vs whole", err_whole, 2e-2)
    check("flash_attention context slices vs plain", err_plain, 2e-2)
    b_ms, b_by = attn_bound(B, S, S, H, KV, D, True, 0)
    row = {"shape": f"qwen2-7b heads B{B} S{S} ({n} q slices of {Sl}, "
                    f"q_offset i*{Sl}) H{H} KV{KV} D{D} bf16 causal",
           "max_abs_err": max(err_whole, err_plain),
           "err_vs_whole": err_whole, "err_vs_plain": err_plain,
           "tolerance": 2e-2, "ms": graph_ms(lambda: sliced("cuda"), iters=5),
           "whole_ms": graph_ms(lambda: mha(q, k, v, causal=True,
                                            impl="cuda"), iters=5),
           "plain_ms": time_ms(lambda: sliced("torch"), iters=1, warmup=0),
           "bound_ms": b_ms, "bound_by": b_by}
    print("sharded_context " + json.dumps(row))
    rows.append(row)
    return rows


def sharded_step_rank(rank, n, device="cuda", cfg=None):
    """One rank of ``sharded_step_phase`` (a process of its own, GPU
    ``rank``, an NCCL group of ``n``): qwen2-7b at full width cut to 2
    layers on a (1, n) ("data", "model") mesh. One train step (B 2, S 1024,
    fp32 masters, the plan's tp_heads layout with FSDP) and the port's
    single-device step on the same seeded weights and batch, each after
    ``compute_grads`` on that batch (bf16 compute, as the step): every
    leaf's gradient relative to the single-device one (Frobenius), the
    single-device gradients' largest change from a second call (run to
    run repeatability) and every parameter's largest difference between
    the two steps; a prefill of
    4 ragged prompts under the prefill plan and 8 decode steps under the
    decode plan (cache sequence-sharded, the decode kernel's partials
    entry), bf16 weights, against the single-device prefill and decode.
    Times (host clock, synced, eager): the first train step each way and
    the decode steps' medians each way. Returns the readings and each
    kernel's launches in the sharded runs.
    ``device`` and ``cfg`` let a CPU rehearsal run the same code small."""
    from repro_torch.launch.mesh import make_test_mesh
    from repro_torch.models.config import ShapeConfig
    from repro_torch.sharding.api import use_rules
    from repro_torch.sharding.planner import plan_for
    from repro_torch.training import (OptimizerConfig, make_decode_step,
                                      make_opt_state, make_prefill_step,
                                      make_train_step)
    from repro_torch.training.optimizer import opt_state_axes, tree_map
    from repro_torch.training.step import compute_grads
    cfg = cfg or dataclasses.replace(get_config("qwen2-7b"), n_layers=2)
    mesh = make_test_mesh((1, n), ("data", "model"), device=device)
    kernels = (fa_kernel.KERNEL, fd_kernel.KERNEL)
    out = {"gpus": n, "launches": {k.name: 0 for k in kernels}}

    def weights(dtype):
        gen = torch.Generator(device=device).manual_seed(SEED + 20)
        return M.init_params(cfg, generator=gen, device=device, dtype=dtype)

    def synced():
        if device == "cuda":
            torch.cuda.synchronize()
        return time.monotonic()

    def counted(fn):
        for k in kernels:
            k.launches = 0
        res = fn()
        synced()
        for k in kernels:
            out["launches"][k.name] += k.launches
        return res

    def whole(tree):
        return tree_map(lambda t: t.full_tensor() if hasattr(
            t, "full_tensor") else t, tree)

    def flat(tree, prefix=""):
        if isinstance(tree, dict):
            return {k: v for key, sub in tree.items()
                    for k, v in flat(sub, f"{prefix}/{key}").items()}
        return {prefix: tree}

    B, S = 2, 1024
    gen = torch.Generator(device=device).manual_seed(SEED + 21)
    tokens = torch.randint(0, cfg.vocab, (B, S), generator=gen,
                           device=device, dtype=torch.int32)
    batch = {"tokens": tokens, "mask": torch.ones(B, S, device=device)}
    t0 = time.monotonic()
    params = weights(torch.float32)
    opt = make_opt_state(params)
    grads_single = flat(compute_grads(cfg, params, batch)[2])
    again = flat(compute_grads(cfg, params, batch)[2])
    repeat_err = max(float((again[k] - g).abs().max())
                     for k, g in grads_single.items())
    del again
    t1 = synced()
    _, _, m1 = make_train_step(cfg, OptimizerConfig())(params, opt, batch)
    single_ms = (synced() - t1) * 1e3
    want = (float(m1["loss"]), float(m1["grad_norm"]), flat(params))
    del opt, m1
    gc.collect()
    if device == "cuda":
        torch.cuda.empty_cache()
    plan = plan_for(cfg, ShapeConfig("t", S, B, "train"), mesh)
    params = weights(torch.float32)
    p = plan.distribute(params, M.param_axes(cfg))
    del params
    o = plan.distribute(make_opt_state(p), opt_state_axes(M.param_axes(cfg)))
    with use_rules(plan.rules):
        grads = flat(whole(counted(lambda: compute_grads(cfg, p, batch))[2]))
        grad_err = {k: float((grads[k] - g).norm() / g.norm().clamp_min(1e-30))
                    for k, g in grads_single.items()}
        del grads, grads_single
        step = make_train_step(cfg, OptimizerConfig(), mesh=mesh)
        t1 = synced()
        p, o, m2 = counted(lambda: step(p, o, batch))
        sharded_ms = (synced() - t1) * 1e3
    got = (float(m2["loss"].full_tensor()), float(m2["grad_norm"].full_tensor()),
           flat(whole(p)))
    worst = max(grad_err, key=grad_err.get)
    out["train"] = {"loss": got[0], "loss_single": want[0],
                    "grad_norm": got[1], "grad_norm_single": want[1],
                    "grad_rel_err": grad_err[worst], "grad_worst_leaf": worst,
                    "grad_rel_err_by_leaf": grad_err,
                    "grad_repeat_err": repeat_err,
                    "param_err": max(float((got[2][k] - v).abs().max())
                                     for k, v in want[2].items()),
                    "plan": plan.strategy, "first_step_ms": sharded_ms,
                    "first_step_ms_single": single_ms,
                    "s": time.monotonic() - t0}
    del p, o, m2, got, want
    gc.collect()
    if device == "cuda":
        torch.cuda.empty_cache()

    t0 = time.monotonic()
    Bs, L, steps = 4, 512, 8
    lens = torch.tensor([300, 17, 256, 129], dtype=torch.int32, device=device)
    prompt = torch.randint(0, cfg.vocab, (Bs, 300), generator=gen,
                           device=device, dtype=torch.int32)
    params = weights(torch.bfloat16)
    cache = M.init_cache(cfg, Bs, L, device=device)
    seq, feed = [], []
    logits, cache, lengths = M.prefill(params, cfg, prompt, cache,
                                       lengths=lens)
    seq.append(logits)
    lengths = lengths + 1
    single_ms = []
    for _ in range(steps):      # greedy, the sharded run replays the tokens
        nxt = logits[:, -1:, :cfg.vocab].argmax(-1).to(torch.int32)
        feed.append(nxt)
        t1 = synced()
        logits, cache, lengths = M.decode_step(params, cfg, nxt, cache,
                                               lengths)
        single_ms.append((synced() - t1) * 1e3)
        seq.append(logits)
    want = torch.stack(seq)[..., :cfg.vocab].float()
    del cache
    sharded = []
    pf = plan_for(cfg, ShapeConfig("p", 300, Bs, "prefill"), mesh)
    dc = plan_for(cfg, ShapeConfig("d", L, Bs, "decode"), mesh)
    cache = pf.distribute(M.init_cache(cfg, Bs, L, device=device),
                          M.cache_axes(cfg))
    with use_rules(pf.rules):
        logits, cache, lengths = counted(lambda: make_prefill_step(cfg)(
            pf.distribute(params, M.param_axes(cfg)), prompt, cache,
            lengths=lens))
    sharded.append(logits.full_tensor())
    lengths = lens + 1
    p = dc.distribute(params, M.param_axes(cfg))
    cache = dc.distribute(cache, M.cache_axes(cfg))
    sharded_ms = []
    with use_rules(dc.rules):
        step = make_decode_step(cfg)
        for nxt in feed:
            t1 = synced()
            logits, cache, lengths = counted(lambda: step(p, nxt, cache,
                                                          lengths))
            sharded_ms.append((synced() - t1) * 1e3)
            sharded.append(logits.full_tensor())
    got = torch.stack(sharded)[..., :cfg.vocab].float()
    out["serve"] = {"max_abs_err": float((got - want).abs().max()),
                    "logit_std": float(want.std()),
                    "argmax_agreement": float((got.argmax(-1)
                                               == want.argmax(-1)).float()
                                              .mean()),
                    "plans": [pf.strategy, dc.strategy],
                    "decode_step_ms_median": float(np.median(sharded_ms)),
                    "decode_step_ms_median_single": float(
                        np.median(single_ms)),
                    "s": time.monotonic() - t0}
    return out


# Per leaf, relative (Frobenius), bf16 compute. CPU rehearsal of
# sharded_step_rank (qwen2-7b cut to 2 layers, vocab 512, gloo): a mesh of
# one reads 1.0e-5, of four 1.35e-2 (bf16 sums in another order); the
# norm scales' gradients left unreduced over "model" read 0.86 on four.
# The H100's mesh of one reads 6.1e-3, the same in every run.
SHARDED_GRAD_TOL = 5e-2


def sharded_step_phase():
    """qwen2-7b through the sharded code paths on an NCCL mesh of every
    visible GPU (``sharded_step_rank``, in processes of their own, started
    after the earlier phases freed the card; this process joins no process
    group, so nothing touches the engines' captures). The train step is
    held to the port's single-device step (loss 5e-3 and parameters 5e-2,
    the reference's sharded-exec bounds; grad norm 2e-2 relative) and,
    since one warm-up step moves a parameter by about 3e-6 whatever its
    gradient, every leaf's gradient too (``SHARDED_GRAD_TOL``); the
    served logits to the single-device prefill and decode (0.1: bf16
    ulps through 2 layers, as the parity phase's). Prints ``sharded_step
    {...}`` and returns the sharded runs' launches."""
    from repro_torch.launch.spmd import spawn
    n = torch.cuda.device_count()
    print(f"sharded_step: NCCL mesh (1, {n}) of {n} visible GPU(s)")
    t0 = time.monotonic()
    res = spawn(sharded_step_rank, n, device="cuda")[0]
    res["s"] = time.monotonic() - t0
    print("sharded_step " + json.dumps(res))
    tr, sv = res["train"], res["serve"]
    check("sharded train loss vs single device",
          abs(tr["loss"] - tr["loss_single"]), 5e-3)
    check("sharded train params vs single device", tr["param_err"], 5e-2)
    check("sharded train grad norm vs single device (relative)",
          abs(tr["grad_norm"] / tr["grad_norm_single"] - 1), 2e-2)
    check(f"sharded train gradients vs single device (worst leaf "
          f"{tr['grad_worst_leaf']}, relative)", tr["grad_rel_err"],
          SHARDED_GRAD_TOL)
    check("sharded serve logits vs single device", sv["max_abs_err"], 0.1)
    for name in ("flash_attention", "flash_decode"):
        if not res["launches"][name] > 0:
            raise AssertionError(f"sharded step: no {name} launch")
    return res["launches"]


def failover_phase():
    """``examples/elastic_failover_torch.py`` on the card: a node fails, the
    next unit is rescheduled and resumes from the port's checkpoint."""
    import importlib.util
    path = Path(__file__).resolve().parent / "examples" / \
        "elastic_failover_torch.py"
    spec = importlib.util.spec_from_file_location("failover", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    t0 = time.monotonic()
    res = mod.run("cuda", log=lambda m: print("failover " + m, flush=True))
    node, result = res["u1"]
    if node == res["u0"] or result["resumed_from"] != 5:
        raise AssertionError(f"failover: {res}")
    print(f"failover: phase {time.monotonic() - t0:.1f} s")


# the dry-run's predicted peak memory of a train step against the card's
# max_memory_allocated, relative: the first card run read 0.97% (58.55 GB
# predicted, 59.12 GB measured; PERF.md section 6, PR 24), kept with 2x room
ROOFLINE_MEM_TOL = 0.02


def roofline_phase(serving, train):
    """The dry-run (``repro_torch.launch.dryrun``) on the host, then held
    to this run's own measurements. (a) qwen2-7b train_4k on the
    production 16 x 16 mesh over a fake process group of 256 ranks. (b)
    Two cells on a mesh of one GPU that earlier phases measured on the
    card: qwen2-7b's decode step at B 8 against a cache of 1024 (the
    serving phase's graphed drains' step medians) and qwen2-7b cut to 8
    layers at train_4k, batch 4 as 2 microbatches (``train_phase``'s step
    median and ``max_memory_allocated``; ``serving`` and ``train`` are
    those phases' ``record`` dicts). Each cell's step-time lower bound
    (the largest of its compute, memory and collective terms at the H100's
    peak rates) must lie at or below every measured step time, and the
    predicted peak memory of the train step within ``ROOFLINE_MEM_TOL`` of
    the measured peak. Lines ``roofline {...}``."""
    from repro_torch.launch.dryrun import lower_cell
    from repro_torch.models.config import ShapeConfig
    from repro_torch.sharding.api import abstract_mesh
    t_phase = time.monotonic()
    keys = ("arch", "shape", "mesh", "chips", "hlo_flops", "model_flops",
            "hlo_bytes", "t_compute", "t_memory", "t_collective",
            "bottleneck", "mfu_bound", "bytes_per_device", "microbatches",
            "fits", "collective_counts", "t_lower_s")
    rec = lower_cell("qwen2-7b", "train_4k")
    print("roofline " + json.dumps({k: rec[k] for k in keys}))
    one = abstract_mesh((1, 1), ("data", "model"))
    cells = [("qwen2-7b decode B8 L1024 (serving)",
              dict(shape=ShapeConfig("decode", 1024, 8, "decode")),
              serving["step_ms"], None),
             ("qwen2-7b 8 layers train_4k B4 as 2 microbatches",
              dict(cut=dict(n_layers=8), plan_overrides={"microbatches": 2},
                   shape=ShapeConfig("train_4k", 4096, 4, "train")),
              [train["step_ms_median"]], train["peak_allocated_gb"])]
    for label, kw, measured_ms, measured_gb in cells:
        rec = lower_cell("qwen2-7b", label, mesh=one, **kw)
        bound_ms = 1e3 * max(rec["t_compute"], rec["t_memory"],
                             rec["t_collective"])
        row = {k: rec[k] for k in keys}
        row.update(step_time_lower_bound_ms=bound_ms,
                   predicted_peak_gb=rec["bytes_per_device"] / 1e9,
                   measured_step_ms=measured_ms, measured_peak_gb=measured_gb)
        print("roofline " + json.dumps(row))
        check(f"roofline {label}: step-time bound over the fastest measured "
              "step (a bound above a measured time means a wrong count)",
              bound_ms / min(measured_ms), 1.0)
        if measured_gb is not None:
            check(f"roofline {label}: predicted peak memory against "
                  "max_memory_allocated, relative",
                  abs(rec["bytes_per_device"] / 1e9 / measured_gb - 1),
                  ROOFLINE_MEM_TOL)
    print(f"roofline: phase {time.monotonic() - t_phase:.1f} s")


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

    kernels = [fa_kernel.KERNEL, fa_kernel.BWD_KERNEL, fd_kernel.KERNEL,
               rs_kernel.KERNEL, ms_kernel.KERNEL, gg_kernel.KERNEL]
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
    t0 = time.monotonic()
    rows[1]["sharded_shapes"] = sharded_kernel_phase(
        torch.Generator(device="cuda").manual_seed(SEED + 11))
    print(f"sharded_kernel: phase {time.monotonic() - t0:.1f} s")
    free_card()
    t0 = time.monotonic()
    rows[0]["encdec_shapes"] = encdec_attention_phase()
    print(f"encdec_attention: phase {time.monotonic() - t0:.1f} s")
    free_card()
    gg_row, gg_path = grouped_gemm_phase(gen, kernels)
    rows.append(gg_row)
    for row in rows:
        print("kernel_check " + json.dumps(row))
    free_card()

    qwen2, rwkv6 = get_config("qwen2-7b"), get_config("rwkv6-7b")
    jamba_full = get_config("jamba-v0.1-52b")
    seamless = get_config("seamless-m4t-large-v2")
    internvl = get_config("internvl2-2b")
    train_kernel_phase(torch.Generator(device="cuda").manual_seed(SEED + 7))
    free_card()
    trace_readers_phase(torch.Generator(device="cuda").manual_seed(SEED + 10))
    train_scan_phase(torch.Generator(device="cuda").manual_seed(SEED + 8))
    free_card()
    measured = {"train": {}, "serving": {}}   # what the roofline phase reads
    train_paths = {
        "qwen2-7b train (8 layers, train_4k)": train_phase(
            qwen2, kernels, dict(n_layers=8), record=measured["train"]),
        "rwkv6-7b train (8 layers, train_4k)": train_phase(
            rwkv6, kernels, dict(n_layers=8), steps=3),
        # jamba at 2 microbatches peaked at 81.8 GB on an H100 80GB: out of memory
        "jamba-v0.1-52b train (pattern mm, train_4k)": train_phase(
            jamba_full, kernels, dict(n_layers=2, layer_pattern="mm"),
            steps=3, microbatches=4),
        # the first models trained at full depth: 2.04 B and 1.90 B
        # parameters, 32.6 and 30.4 GB at 16 bytes each
        "seamless-m4t-large-v2 train (24 + 24 layers, train_4k)":
            train_phase(seamless, kernels, {}, steps=3),
        "internvl2-2b train (24 layers, train_4k)": train_phase(
            internvl, kernels, {}, steps=3),
        "train_tenant 100m": train_tenant_phase(kernels)}
    free_card()

    jamba = dataclasses.replace(jamba_full, n_layers=8)
    parity_phase(qwen2, 2, 0.1, BF16_ULPS)
    parity_phase(rwkv6, 2, 0.1, BF16_ULPS)
    parity_phase(jamba, 8, 0.25,
                 BF16_ULPS + "; an ulp can also flip a near-tie of the "
                 "top-2 router for one token, which moves that token by "
                 "one expert's output")
    parity_phase(jamba, 8, 2e-3,
                 "fp32 compute and cache, bf16 weights: the kernels differ "
                 "from the chunked plain scans by ~1e-5 relative (their "
                 "exp(+-cumsum)), and no bf16 rounding amplifies it",
                 compute_dtype=torch.float32)
    free_card()

    gemma2 = get_config("gemma2-9b")
    capped = ("logits under gemma2's final softcap of 30, before it of std "
              "~60 (a tied table of stddev 1 against a unit-RMS state), "
              "rounded to bf16 (an ulp is 0.25 at 32-64); the few-ulp "
              "differences that move qwen2-7b's logits of std 0.88 by ~0.02 "
              "move these by up to ~1.5 where the cap passes them: a tenth "
              "of the cap")
    parity_phase(gemma2, 2, 3.0, capped)
    parity_phase(gemma2, 2, 0.05,
                 "fp32 compute and cache, bf16 weights: the fp32 kernels and "
                 "the plain versions sum in other orders (~1e-6 relative), "
                 "logits of scale 30", compute_dtype=torch.float32)
    window_phase(gemma2, 3.0, capped)
    free_card()
    t0 = time.monotonic()
    encdec_parity_phase(seamless, internvl)
    print(f"parity encoder-decoder and frontends: phase "
          f"{time.monotonic() - t0:.1f} s")
    free_card()

    by_path = {"grouped_gemm op, dropless MoE experts at "
               + ", ".join(MOE_CONFIGS): gg_path, **train_paths}
    by_path["qwen2-7b"], (params, lone) = serving_phase(
        qwen2, kernels, n_req=24, max_new=32, profile_admits=True,
        record=measured["serving"])
    by_path["qwen2-7b admission A/B"] = admission_ab(
        qwen2, kernels, params, n_req=24, max_new=32)
    free_card()
    by_path["fleet qwen2-7b"] = fleet_phase(qwen2, kernels, params, lone,
                                            n_req=24, max_new=32)
    del params, lone
    free_card()
    by_path["gemma2-9b"], (params, engine) = serving_phase(
        gemma2, kernels, n_req=24, max_new=32)
    del engine
    free_card()
    by_path["gemma2-9b max_len 8192"] = long_window_drain(gemma2, kernels,
                                                          params)
    del params
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
    t0 = time.monotonic()
    by_path["seamless-m4t-large-v2"], (params, engine) = serving_phase(
        seamless, kernels, n_req=24, max_new=32)
    del engine
    free_card()
    print(f"serving seamless-m4t-large-v2: phase "
          f"{time.monotonic() - t0:.1f} s")
    by_path["seamless-m4t-large-v2 speech path"] = speech_phase(
        seamless, kernels, params)
    del params
    free_card()
    t0 = time.monotonic()
    by_path["internvl2-2b"] = serving_phase(internvl, kernels, n_req=24,
                                            max_new=32)[0]
    free_card()
    print(f"serving internvl2-2b: phase {time.monotonic() - t0:.1f} s")
    roofline_phase(measured["serving"], measured["train"])
    t0 = time.monotonic()
    sharded = sharded_step_phase()
    by_path["qwen2-7b sharded (2 layers)"] = {
        k.name: sharded.get(k.name, 0) for k in kernels}
    print(f"sharded_step: phase {time.monotonic() - t0:.1f} s")
    failover_phase()
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
