"""Serving engine: fused batched admission + joint decode over fixed slots
(twin of ``repro.serving.engine``).

``GenerationEngine`` owns a slot cache preallocated once on the device (KV
for attention layers, fp32 states for recurrent ones):

- **fused admission** — all free slots are filled with ONE prefill per
  prompt-length bucket: prompts are right-padded to the bucket length,
  prefilled as a batch, and every leaf of the resulting rows (K/V, and the
  Mamba/RWKV states) is written *in place* into the slot cache with
  ``index_copy_`` at the slot indices (never a copy of the whole cache).
  Right-padding is exact for attention layers: the decode kernel masks by
  ``lengths``, and pad positions are never attended and are progressively
  overwritten. It is exact for Mamba layers too: the prefill hands them
  the true lengths, pad steps get dt = 0 (no decay, no input) and the
  conv state is read at each row's length. RWKV layers would fold pad
  tokens into their state, so patterns with "r" bucket by exact length.
- **fused decode** — one step over all slots that advances every active
  slot and computes done-flags on the device, so the host syncs ONCE per
  step instead of once per slot.

On the card both calls are CUDA graphs, the port of the reference's
``_compiled`` (``jax.jit`` of the admit and of the step, traced once per
shape). The step is ONE graph, captured in ``__init__`` and replayed by
every ``step()``. Admission is one graph per (rows, bucket) shape,
captured lazily after that shape's first call, which runs eagerly and is
the capture's warm-up, and replayed by every later call of the shape; the
graphs of one engine share one memory pool. An admission capture never
waits: where another thread holds ``CAPTURE_LOCK`` (a replica being built,
another engine's capture) the shape stays eager this time and is captured
on a later call, as the reference's lazily traced ``jax.jit`` never waits
on another replica. Engines with "r" layers
admit eagerly: they bucket by exact prompt length, so a graph per length
would be a graph per request. Each graph binds this engine's cache, slot
state and input buffers, so all of them are static buffers that every call
writes in place. The bodies, ``_step`` and ``_admit_staged``, run eagerly
on the CPU (where the tests cover them) and are captured on the card;
``cuda_graph=False`` asks for both calls eagerly on the card. Every
capture holds the process's ``CAPTURE_LOCK`` (``repro_torch.device``), so
engines built or driven on several threads capture one at a time.

Slot state (lengths, token budgets, active mask, last token per slot) lives
on the device between calls; the host keeps only the request objects and a
free-slot map. Each admit call and each step makes exactly one
device-to-host transfer, so ``host_syncs == admit_calls + steps``.
``ContinuousBatcher`` fronts one engine with a thread-safe per-tenant WRR
:class:`~repro_torch.serving.scheduler.SlotScheduler`; ``generate`` routes
batch generation through the same engine path.

Tracing: an engine's ``tracer`` (a :class:`~repro_torch.core.trace.Tracer`,
None by default, and settable at any time) receives the phases of every
call on its span lane: ``engine.step.launch`` / ``.wait`` / ``.book``,
and per bucket group ``engine.admit.stage`` / ``.launch`` / ``.wait`` /
``.book`` / ``.capture``. On the card it also gets the device's side,
from timing CUDA events around each call's device work:
``engine.step.device``, ``engine.admit.device`` and ``engine.step.gap``
(the device idle from one step graph's end to the next one's start, for
consecutive steps with no admit call between). With ``tracer`` None no
event is created or recorded and no span is recorded: the cost is the
``is not None`` checks.
"""
from __future__ import annotations

import threading
import time
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from ..device import CAPTURE_LOCK, DeviceLike, resolve_device
from ..kernels._build import record_launches
from ..models import decode_step, init_cache, prefill
from ..models.config import ModelConfig
from ..models.moe import count_pairs
from .scheduler import SlotScheduler


@dataclass
class Request:
    uid: int
    prompt: np.ndarray                  # [S] int32
    max_new_tokens: int = 16
    tenant: str = "default"
    tokens: List[int] = field(default_factory=list)
    done: bool = False
    submitted_at: float = field(default_factory=time.monotonic)
    dequeued_at: float = 0.0            # WRR dispatch (SlotScheduler.take)
    admit_started_at: float = 0.0       # prefill launch (before device sync)
    admitted_at: float = 0.0
    first_token_at: float = 0.0         # TTFT = first_token_at - submitted_at
    finished_at: float = 0.0


def _same_device(t: torch.Tensor, dev: torch.device) -> bool:
    return t.device.type == dev.type and (dev.index is None
                                          or t.device.index == dev.index)


def _capture_graph(body: Callable[[], Any], stream: "torch.cuda.Stream", *,
                   pool=None, warmup: Optional[Callable[[], Any]] = None
                   ) -> Tuple["torch.cuda.CUDAGraph", Dict[Any, int]]:
    """Capture ``body()`` as one CUDA graph on ``stream``, into ``pool``
    (a ``torch.cuda.graph_pool_handle()``; None: a pool of its own), after
    ``warmup()`` on the same stream. Returns the graph and the kernel
    launches it recorded, which whoever replays it adds at each replay.

    The whole of it holds ``CAPTURE_LOCK``: the allocator's and CUDA's
    capture state allow one capture at a time in a process, and a
    device-wide sync on another thread during a capture is refused. It
    drives ``capture_begin``/``capture_end`` itself, with no sync at all (a
    capture only records), instead of ``torch.cuda.graph``, which begins
    every capture with a device-wide sync and a release of the allocator's
    cached blocks: the sync would wait for every other engine's queued
    work, and the release would drop the blocks that every engine's eager
    calls reuse (each freed segment syncs the device again). The price: a
    graph's pool is new memory, so a capture with the card nearly full
    raises where a release might have made room.
    ``capture_error_mode="thread_local"`` leaves other threads free to
    allocate, launch and sync their own streams meanwhile."""
    with CAPTURE_LOCK:
        current = torch.cuda.current_stream(stream.device)
        stream.wait_stream(current)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.stream(stream):
            if warmup is not None:
                warmup()
            with record_launches() as launches:
                graph.capture_begin(pool=pool,
                                    capture_error_mode="thread_local")
                try:
                    body()
                finally:
                    graph.capture_end()
        current.wait_stream(stream)
    return graph, launches


class GenerationEngine:
    """Slot-based engine: fused bucketed admission, joint decode.

    NOT thread-safe by itself: exactly one drive thread may call
    ``admit_many``/``step``; put a :class:`ContinuousBatcher` in front for
    concurrent submitters. Engines may be built and driven on different
    threads at the same time: their captures take turns. ``device=None``
    means the card; pass ``device="cpu"`` (with CPU parameters) to run on
    the CPU. ``cuda_graph`` (default: on the card, yes) replays the decode
    step, and for attention-only patterns each admission shape, as
    captured CUDA graphs; ``False`` runs both eagerly, and ``True`` off the
    card raises. A capture that fails raises too.
    """

    def __init__(self, cfg: ModelConfig, params: Any, *, slots: int = 4,
                 max_len: int = 512, compute_dtype=torch.bfloat16,
                 device: DeviceLike = None,
                 cuda_graph: Optional[bool] = None):
        self.device = resolve_device(device)
        table = params["embed"]["table"]
        if not _same_device(table, self.device):
            raise ValueError(f"parameters are on {table.device}, the engine "
                             f"on {self.device}")
        on_card = self.device.type == "cuda"
        if cuda_graph and not on_card:
            raise ValueError(f"a CUDA graph needs the card; this engine is "
                             f"on {self.device}")
        self.cfg = cfg
        self.params = params
        self.slots = slots
        self.max_len = max_len
        self.compute_dtype = compute_dtype
        # an encoder-decoder's cross K/V hold max_len rows, zeros until a
        # prefill with frames fills them (the engine passes none, as the
        # reference's): the decoder's cross-attention then adds exactly 0
        self.cache = init_cache(cfg, slots, max_len, enc_len=max_len,
                                device=self.device)
        i32 = dict(dtype=torch.int32, device=self.device)
        # device-resident slot state, updated by every fused call
        self._slot_lengths = torch.zeros((slots,), **i32)
        self._budget = torch.zeros((slots,), **i32)
        self._active = torch.zeros((slots,), dtype=torch.bool,
                                   device=self.device)
        self._last = torch.zeros((slots, 1), **i32)
        self._out = torch.zeros((2, slots), **i32)     # a step's tokens, done
        self._first = torch.zeros((slots,), **i32)     # an admit's first tokens
        # host mirrors (authoritative for slot occupancy)
        self.lengths = np.zeros((slots,), np.int32)
        self.slot_req: List[Optional[Request]] = [None] * slots
        # RWKV's state folds pad tokens in: bucket by exact length there
        self._exact_buckets = "r" in cfg.layer_pattern
        # perf counters (benchmarks read these)
        self.steps = 0
        self.admit_calls = 0            # fused admit invocations
        self.admitted = 0               # requests admitted
        self.host_syncs = 0             # device->host transfers
        self.admit_replays = 0          # admit calls that replayed a graph
        self.admit_captures = 0         # admission graphs captured (lazily)
        self.capture_s = 0.0            # seconds spent in those captures
        self.captures_skipped = 0       # admission captures left for later
        # MoE (token, expert) pairs routed and kept, summed on the device by
        # every admit call and step (graphed ones too), read by counters()
        self._moe_counts = (torch.zeros((2,), dtype=torch.int64,
                                        device=self.device)
                            if cfg.is_moe else None)
        # tracing (module docstring): the span lane's owner, and the timing
        # events, made at the first traced call on the card
        self.tracer: Optional[Any] = None
        self._timed = on_card
        self._events: Optional[List[Any]] = None
        self._event_at = 0
        self._last_step_end: Optional[Tuple[Any, int, int]] = None
        self._graph: Optional[torch.cuda.CUDAGraph] = None
        self._graph_launches: Dict[Any, int] = {}
        # (rows, bucket) -> (static inputs, graph, recorded launches)
        self._admit_graphs: Dict[Tuple[int, int], Tuple[Any, Any, Any]] = {}
        graphed = cuda_graph is not False and on_card
        # exact-length buckets would make a graph per request: eager there
        self._graph_admit = graphed and not self._exact_buckets
        if graphed:
            self._capture_stream = torch.cuda.Stream(self.device)
            self._admit_pool = torch.cuda.graph_pool_handle()
            self._capture()

    # -- slots -------------------------------------------------------------

    def free_slots(self) -> List[int]:
        return [i for i, r in enumerate(self.slot_req) if r is None]

    def _bucket(self, n: int) -> int:
        if self._exact_buckets:
            return n
        b = 8
        while b < n:
            b <<= 1
        return min(b, self.max_len - 1)

    # -- fused device calls ------------------------------------------------

    @torch.inference_mode()
    def _admit(self, prompts: torch.Tensor, slot_idx: torch.Tensor,
               true_len: torch.Tensor, max_new: torch.Tensor) -> torch.Tensor:
        """Prefill ``k`` right-padded prompts and write them into freed
        slots in place. Returns the first generated token per row."""
        cfg = self.cfg
        row_cache = init_cache(cfg, prompts.shape[0], self.max_len,
                               enc_len=self.max_len, device=self.device)
        with count_pairs(self._moe_counts):
            logits, row_cache, _ = prefill(self.params, cfg, prompts,
                                           row_cache, lengths=true_len,
                                           compute_dtype=self.compute_dtype,
                                           exact_states=True)
        first = logits[:, 0, :cfg.vocab].argmax(dim=-1).to(torch.int32)
        for name, sub in self.cache.items():
            for kv, c in sub.items():
                c.index_copy_(1, slot_idx, row_cache[name][kv].to(c.dtype))
        self._slot_lengths.index_copy_(0, slot_idx, true_len)
        # the first token is produced by the prefill itself: one unit of
        # budget is spent on it, and a slot stays active only if budget
        # remains and the cache can hold another token
        self._budget.index_copy_(0, slot_idx, max_new - 1)
        self._active.index_copy_(
            0, slot_idx, (max_new > 1) & (true_len < self.max_len - 1))
        self._last.index_copy_(0, slot_idx, first[:, None])
        return first

    @torch.inference_mode()
    def _admit_staged(self, buf: torch.Tensor, k: int,
                      pad_len: int) -> torch.Tensor:
        """``_admit`` on one flat int32 buffer, as ``admit_many`` stages a
        call with its one host-to-device copy: ``k`` right-padded prompts
        [k, pad_len], then the slot indices, true lengths and token budgets,
        ``k`` each. The first token per row goes into the engine's
        ``_first`` buffer, and a view of it is returned. This is the body
        an admission graph captures: its inputs are the graph's static
        buffer and its result outlives the replay outside the graph's
        memory pool."""
        n = k * pad_len
        first = self._admit(buf[:n].view(k, pad_len), buf[n:n + k].long(),
                            buf[n + k:n + 2 * k], buf[n + 2 * k:n + 3 * k])
        self._first[:k].copy_(first)
        return self._first[:k]

    @torch.inference_mode()
    def _step(self) -> torch.Tensor:
        """One decode step over every slot; inactive slots are masked out.

        Inactive slots still flow through the batched matmuls (their K/V
        and state writes land in the cache, are masked by ``lengths`` and
        are overwritten at the next admission), which keeps the step shape
        static. Every result is written in place into the engine's static
        buffers, which is what lets a CUDA graph replay this body. Returns
        ``self._out``, [2, slots] int32: tokens, done."""
        call_lengths = self._slot_lengths + 1     # new token position + 1
        with count_pairs(self._moe_counts):
            logits, _, _ = decode_step(self.params, self.cfg, self._last,
                                       self.cache, call_lengths,
                                       compute_dtype=self.compute_dtype)
        toks = logits[:, 0, :self.cfg.vocab].argmax(dim=-1).to(torch.int32)
        active = self._active
        self._slot_lengths.copy_(torch.where(active, call_lengths,
                                             self._slot_lengths))
        self._budget.copy_(torch.where(active, self._budget - 1,
                                       self._budget))
        self._last.copy_(torch.where(active[:, None], toks[:, None],
                                     self._last))
        done = active & ((self._budget <= 0)
                         | (self._slot_lengths >= self.max_len - 1))
        self._active.copy_(active & ~done)
        self._out[0].copy_(toks)
        self._out[1].copy_(done)
        return self._out

    def _capture(self) -> None:
        """Capture ``_step`` as this engine's CUDA graph, while every slot
        is inactive. A warm-up step on the capture stream first creates the
        cuBLAS handles and loads every kernel library the step launches;
        with no active slot it changes no slot's length or budget. The
        wrappers' launch counts are recorded, not counted, and ``step()``
        adds them at every replay."""
        self._graph, self._graph_launches = _capture_graph(
            self._step, self._capture_stream, warmup=self._step)

    def _admit_eagerly(self, buf: torch.Tensor, k: int,
                       pad_len: int) -> torch.Tensor:
        """One admit call without a graph. Where this engine graphs its
        admission, the call is a shape's first, and so its capture's
        warm-up: it runs on the capture stream, where the drive thread's
        cuBLAS handle gets its workspace for that stream outside any graph
        pool (the capture itself would otherwise allocate it in the pool,
        to stay there)."""
        if not self._graph_admit:
            return self._admit_staged(buf, k, pad_len)
        current = torch.cuda.current_stream(self.device)
        self._capture_stream.wait_stream(current)
        with torch.cuda.stream(self._capture_stream):
            first = self._admit_staged(buf, k, pad_len)
        current.wait_stream(self._capture_stream)
        return first

    def _capture_admit(self, k: int, pad_len: int) -> None:
        """Capture ``_admit_staged`` for ``k`` rows of ``pad_len`` tokens,
        bound to a static input buffer of its own, into the pool that all
        of this engine's admission graphs share. A capture only records, so
        no slot is touched. Nothing of a replay outlives it in the pool
        (the row cache and activations are dead by its end; the first
        tokens go to ``_first``), so each capture may reuse all of the pool,
        and the pool is the largest graph's working set: at qwen2-7b's
        8 rows x 1023 tokens, 8 slots and max_len 1024, a 0.47 GB row cache
        and about 2 GB of activations, the SwiGLU's at 0.31 GB a bf16 and
        0.62 GB an fp32 intermediate. The graphs are replayed by the one
        drive thread, one at a time.

        The capture takes ``CAPTURE_LOCK`` without blocking. Where another
        thread holds it, this engine does not wait for that capture (a
        replica's whole build, its warm-up step included): it skips the
        capture and counts it in ``captures_skipped``. The shape's next
        call then runs eagerly on the capture stream again, as a new
        warm-up, and captures it."""
        if not CAPTURE_LOCK.acquire(blocking=False):
            self.captures_skipped += 1
            return
        t0 = time.monotonic()
        try:
            inputs = torch.zeros((k * pad_len + 3 * k,), dtype=torch.int32,
                                 device=self.device)
            graph, launches = _capture_graph(
                lambda: self._admit_staged(inputs, k, pad_len),
                self._capture_stream, pool=self._admit_pool)
        finally:
            CAPTURE_LOCK.release()
        self._admit_graphs[(k, pad_len)] = (inputs, graph, launches)
        self.admit_captures += 1
        self.capture_s += time.monotonic() - t0

    # -- device clock (traced engines on the card) ---------------------------

    def _timing_start(self) -> Optional[Tuple[Any, Any]]:
        """The next pair of this engine's timing events, its start
        recorded on the current stream; None off the card. Four events,
        reused in turn, so that a step's end event is intact when the next
        step's start is recorded whatever came between."""
        if not self._timed:
            return None
        if self._events is None:
            self._events = [torch.cuda.Event(enable_timing=True)
                            for _ in range(4)]
        i = self._event_at
        self._event_at = (i + 2) % 4
        pair = self._events[i], self._events[i + 1]
        pair[0].record()
        return pair

    def _read_step_clock(self, tr: Any, ev: Tuple[Any, Any]) -> None:
        """After a step's sync: its graph's device time, and the device's
        idle time since the previous step's graph if that step was the one
        before and no admit call came between."""
        start, end = ev
        tr.lane_add("engine.step.device", start.elapsed_time(end) / 1e3)
        last = self._last_step_end
        if (last is not None and last[1] == self.steps - 1
                and last[2] == self.admit_calls):
            tr.lane_add("engine.step.gap", last[0].elapsed_time(start) / 1e3)
        self._last_step_end = (end, self.steps, self.admit_calls)

    # -- admission ---------------------------------------------------------

    def admit_many(self, reqs: List[Request]) -> List[Request]:
        """Admit up to ``len(free_slots())`` requests, one fused call (and
        one host sync) per prompt-length bucket. Returns the requests
        admitted; those with ``done`` set finished at admission (their
        single-token budget was spent by the prefill). Where admission is
        graphed, a (rows, bucket) shape seen before replays its graph; a
        new one runs eagerly and is captured once its requests are booked,
        unless another thread is capturing (``_capture_admit``)."""
        free = self.free_slots()
        take = list(reqs[:len(free)])
        if not take:
            return []
        groups: Dict[int, List[Request]] = {}
        for r in take:
            n = int(np.asarray(r.prompt).reshape(-1).shape[0])
            if n >= self.max_len:
                raise ValueError(
                    f"prompt length {n} >= engine max_len {self.max_len}")
            groups.setdefault(self._bucket(n), []).append(r)
        tr = self.tracer
        for pad_len, group in sorted(groups.items()):
            k = len(group)
            idx = np.asarray(free[:k], np.int32)
            free = free[k:]
            t_admit = time.monotonic()   # prefill launch, before host sync
            for r in group:
                r.admit_started_at = t_admit
            prompts = np.zeros((k, pad_len), np.int32)
            true_len = np.empty((k,), np.int32)
            max_new = np.empty((k,), np.int32)
            for j, r in enumerate(group):
                p = np.asarray(r.prompt, np.int32).reshape(-1)
                prompts[j, :p.shape[0]] = p
                true_len[j] = p.shape[0]
                max_new[j] = max(1, int(r.max_new_tokens))
            # one host-to-device copy of everything the call needs
            host = torch.from_numpy(np.concatenate(
                [prompts.reshape(-1), idx, true_len, max_new]))
            graphed = (self._admit_graphs.get((k, pad_len))
                       if self._graph_admit else None)
            if graphed is None:
                buf = host.to(self.device)
            else:
                inputs, graph, launches = graphed
                inputs.copy_(host)
            if tr is not None:
                t_launch = time.monotonic()
                tr.lane_span("engine.admit.stage", t_admit, t_launch)
                # on the current stream: an eager call on the capture
                # stream starts after the start event and the end event
                # waits for it
                ev = self._timing_start()
            if graphed is None:
                first = self._admit_eagerly(buf, k, pad_len)
            else:
                graph.replay()
                for kernel, count in launches.items():
                    kernel.add_launches(count)
                self.admit_replays += 1
                first = self._first[:k]
            if tr is not None:
                if ev is not None:
                    ev[1].record()
                t_wait = time.monotonic()
                tr.lane_span("engine.admit.launch", t_launch, t_wait,
                             (k, pad_len,
                              "eager" if graphed is None else "graphed"))
            first_np = first.cpu().numpy()
            self.host_syncs += 1
            self.admit_calls += 1
            self.admitted += k
            now = time.monotonic()
            if tr is not None:
                tr.lane_span("engine.admit.wait", t_wait, now)
            for j, r in enumerate(group):
                slot = int(idx[j])
                r.tokens.append(int(first_np[j]))
                r.admitted_at = now
                r.first_token_at = now
                if max_new[j] <= 1 or true_len[j] >= self.max_len - 1:
                    r.done = True
                    r.finished_at = now          # slot never occupied
                else:
                    self.slot_req[slot] = r
                    self.lengths[slot] = int(true_len[j])
            if tr is not None:
                tr.lane_span("engine.admit.book", now, time.monotonic())
                if ev is not None:
                    tr.lane_add("engine.admit.device",
                                ev[0].elapsed_time(ev[1]) / 1e3)
            if graphed is None and self._graph_admit:
                if tr is None:
                    self._capture_admit(k, pad_len)
                else:
                    skipped = self.captures_skipped
                    t0 = time.monotonic()
                    self._capture_admit(k, pad_len)
                    tr.lane_span("engine.admit.capture", t0, time.monotonic(),
                                 (self.captures_skipped > skipped,))
        return take

    def admit(self, req: Request) -> bool:
        """Single-request admission (compat shim over ``admit_many``)."""
        return bool(self.admit_many([req]))

    # -- decode ------------------------------------------------------------

    def step(self) -> List[Request]:
        """One fused decode step over all slots; returns finished requests.
        One host sync per step regardless of slot count."""
        if not any(r is not None for r in self.slot_req):
            return []
        tr = self.tracer
        if tr is not None:
            t0 = time.monotonic()
            ev = self._timing_start()
        if self._graph is None:
            out = self._step()
        else:
            self._graph.replay()
            for kernel, n in self._graph_launches.items():
                kernel.add_launches(n)
            out = self._out
        if tr is not None:
            if ev is not None:
                ev[1].record()
            t_wait = time.monotonic()
            tr.lane_span("engine.step.launch", t0, t_wait)
        toks_np, done_np = out.cpu().numpy()
        self.host_syncs += 1
        self.steps += 1
        now = time.monotonic()
        if tr is not None:
            tr.lane_span("engine.step.wait", t_wait, now)
        finished: List[Request] = []
        for i, req in enumerate(self.slot_req):
            if req is None:
                continue
            req.tokens.append(int(toks_np[i]))
            self.lengths[i] += 1
            if done_np[i]:
                req.done = True
                req.finished_at = now
                finished.append(req)
                self.slot_req[i] = None
                self.lengths[i] = 0
        if tr is not None:
            tr.lane_span("engine.step.book", now, time.monotonic())
            if ev is not None:
                self._read_step_clock(tr, ev)
        return finished

    # -- introspection -----------------------------------------------------

    def active_slots(self) -> int:
        return sum(1 for r in self.slot_req if r is not None)

    def counters(self) -> Dict[str, float]:
        """The engine's counts. ``moe_pairs`` / ``moe_pairs_dropped``: MoE
        (token, expert) pairs routed through the expert layers by every
        admit call (its pad rows too) and step so far, and those dropped
        past the capacity;
        an MoE engine reads them from the device here (one transfer),
        any other reports 0 without touching the device."""
        pairs = kept = 0
        if self._moe_counts is not None:
            pairs, kept = self._moe_counts.tolist()
        return {"steps": self.steps, "admit_calls": self.admit_calls,
                "admitted": self.admitted,
                "host_syncs": self.host_syncs,
                "admit_replays": self.admit_replays,
                "admit_captures": self.admit_captures,
                "capture_s": self.capture_s,
                "captures_skipped": self.captures_skipped,
                "moe_pairs": pairs, "moe_pairs_dropped": pairs - kept}


class ContinuousBatcher:
    """Thread-safe request front for ONE engine: a per-tenant WRR
    :class:`SlotScheduler` feeds the engine's free slots. ``submit`` is
    safe from any thread; a single drive thread calls ``pump`` /
    ``run_until_drained``."""

    def __init__(self, engine: GenerationEngine,
                 scheduler: Optional[SlotScheduler] = None):
        self.engine = engine
        # NOT ``scheduler or ...``: SlotScheduler.__len__ is the pending
        # count, so a freshly-built (empty) scheduler is falsy and would be
        # silently replaced with a default fair one.
        self.scheduler = (scheduler if scheduler is not None
                          else SlotScheduler())
        self._lock = threading.Lock()
        self._uid = 0
        self.completed: Dict[int, Request] = {}

    def submit(self, prompt: np.ndarray, max_new_tokens: int = 16,
               tenant: str = "default") -> int:
        prompt = np.asarray(prompt, np.int32).reshape(-1)
        if prompt.shape[0] >= self.engine.max_len:
            raise ValueError(f"prompt length {prompt.shape[0]} >= "
                             f"engine max_len {self.engine.max_len}")
        with self._lock:
            self._uid += 1
            uid = self._uid
        self.scheduler.submit(
            tenant, Request(uid, prompt, max_new_tokens, tenant=tenant))
        return uid

    def pump(self) -> List[Request]:
        """One admit+decode round; returns requests finished this round."""
        finished: List[Request] = []
        free = len(self.engine.free_slots())
        if free:
            for req in self.engine.admit_many(self.scheduler.take(free)):
                if req.done:
                    finished.append(req)
        finished.extend(self.engine.step())
        if finished:
            with self._lock:
                for req in finished:
                    self.completed[req.uid] = req
        return finished

    def run_until_drained(self, max_steps: int = 10_000) -> None:
        for _ in range(max_steps):
            self.pump()
            if (self.scheduler.pending() == 0
                    and self.engine.active_slots() == 0):
                return
        raise TimeoutError("batcher did not drain")


def generate(cfg: ModelConfig, params: Any, prompts: np.ndarray,
             max_new_tokens: int = 16, max_len: int = 256,
             compute_dtype=torch.bfloat16,
             device: DeviceLike = None) -> np.ndarray:
    """Batched generation routed through the engine path (ONE decode
    implementation): B prompts admit into B slots in a single fused call,
    then fused-decode to the token budget."""
    prompts = np.asarray(prompts, np.int32)
    B, S = prompts.shape
    if S + max_new_tokens > max_len:
        raise ValueError(f"prompt ({S}) + max_new_tokens ({max_new_tokens}) "
                         f"exceeds max_len ({max_len})")
    engine = GenerationEngine(cfg, params, slots=B, max_len=max_len,
                              compute_dtype=compute_dtype, device=device)
    reqs = [Request(i + 1, prompts[i], max_new_tokens) for i in range(B)]
    engine.admit_many(reqs)   # equal lengths: one bucket, slots 0..B-1
    while engine.active_slots():
        engine.step()
    return np.asarray([r.tokens for r in reqs])
