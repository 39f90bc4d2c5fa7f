"""Synthetic sharded token pipeline with background prefetch and packing
(a copy of ``repro.data.pipeline``, which imports no JAX; the port keeps its
own copy, reading its own ``models.config``). Batches are numpy: the train
step moves them to the parameters' device.

Deterministic per (seed, step, shard): every data-parallel host slices the
same logical global batch without coordination — the standard "index-based"
sharded loader contract, so restarts and elastic re-sharding are exact.
"""
from __future__ import annotations

import queue
import threading
from dataclasses import dataclass
from typing import Any, Dict, Iterator, List, Sequence

import numpy as np

from ..models.config import ModelConfig, ShapeConfig


@dataclass(frozen=True)
class DataConfig:
    seed: int = 0
    pad_id: int = 0
    prefetch: int = 2


class SyntheticTokens:
    """Zipf-ish synthetic LM tokens (deterministic, seekable)."""

    def __init__(self, cfg: ModelConfig, shape: ShapeConfig,
                 data_cfg: DataConfig = DataConfig(),
                 shard_index: int = 0, num_shards: int = 1):
        assert shape.global_batch % num_shards == 0, \
            f"batch {shape.global_batch} % shards {num_shards}"
        self.cfg = cfg
        self.shape = shape
        self.data_cfg = data_cfg
        self.shard_index = shard_index
        self.num_shards = num_shards
        self.local_batch = shape.global_batch // num_shards

    def batch_at(self, step: int) -> Dict[str, np.ndarray]:
        rng = np.random.default_rng(
            (self.data_cfg.seed, step, self.shard_index))
        B, S = self.local_batch, self.shape.seq_len
        # zipf-like marginal over the vocab (heavy head like natural text)
        u = rng.random((B, S))
        toks = np.minimum((u ** -1.3).astype(np.int64), self.cfg.vocab - 1)
        toks = (toks + rng.integers(0, self.cfg.vocab, (B, 1))) % self.cfg.vocab
        batch: Dict[str, np.ndarray] = {
            "tokens": toks.astype(np.int32),
            "mask": np.ones((B, S), np.float32),
        }
        if self.cfg.frontend == "vit_stub":
            batch["patches"] = rng.standard_normal(
                (B, self.cfg.frontend_tokens, self.cfg.frontend_dim),
                dtype=np.float32)
        elif self.cfg.frontend == "speech_stub":
            batch["frames"] = rng.standard_normal(
                (B, S, self.cfg.frontend_dim), dtype=np.float32) * 0.1
        return batch

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        step = 0
        while True:
            yield self.batch_at(step)
            step += 1


def pack_documents(docs: Sequence[np.ndarray], seq_len: int,
                   pad_id: int = 0) -> Dict[str, np.ndarray]:
    """Greedy sequence packing: concatenate docs into fixed-length rows;
    returns tokens + a loss mask that zeroes the padding tail and an example
    segment-id map (for packed-attention-aware losses)."""
    rows: List[np.ndarray] = []
    segs: List[np.ndarray] = []
    cur: List[np.ndarray] = []
    cur_len = 0
    seg_cur: List[np.ndarray] = []
    seg_id = 1
    for doc in docs:
        doc = doc[:seq_len]
        if cur_len + len(doc) > seq_len:
            rows.append(np.concatenate(cur) if cur else np.empty(0, np.int32))
            segs.append(np.concatenate(seg_cur) if seg_cur
                        else np.empty(0, np.int32))
            cur, cur_len, seg_cur = [], 0, []
            seg_id = 1
        cur.append(doc.astype(np.int32))
        seg_cur.append(np.full(len(doc), seg_id, np.int32))
        cur_len += len(doc)
        seg_id += 1
    if cur:
        rows.append(np.concatenate(cur))
        segs.append(np.concatenate(seg_cur))
    B = len(rows)
    tokens = np.full((B, seq_len), pad_id, np.int32)
    segments = np.zeros((B, seq_len), np.int32)
    mask = np.zeros((B, seq_len), np.float32)
    for i, (r, s) in enumerate(zip(rows, segs)):
        tokens[i, :len(r)] = r
        segments[i, :len(s)] = s
        mask[i, :len(r)] = 1.0
    return {"tokens": tokens, "segments": segments, "mask": mask}


class Prefetcher:
    """Background-thread prefetch of a batch iterator."""

    def __init__(self, it: Iterator[Any], depth: int = 2):
        self._it = it
        self._q: "queue.Queue" = queue.Queue(maxsize=depth)
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    def _run(self) -> None:
        try:
            for item in self._it:
                if self._stop.is_set():
                    return
                self._q.put(item)
        finally:
            self._q.put(None)

    def __iter__(self):
        return self

    def __next__(self):
        item = self._q.get()
        if item is None:
            raise StopIteration
        return item

    def close(self) -> None:
        self._stop.set()
        try:
            while True:
                self._q.get_nowait()
        except queue.Empty:
            pass
