"""Local multi-process runs: N ranks on one host sharing a process group.

``spawn(fn, n)`` starts ``n`` processes, each of which joins a process
group of world size ``n`` through a ``file://`` rendezvous in a fresh
temporary directory (so concurrent runs never share one), calls
``fn(rank, n, *args)`` and leaves the group. It returns the ranks' return
values in rank order and raises if any rank fails. The backend is "gloo"
on the CPU and "nccl" on the card, one GPU per rank, and the card needs
``n`` GPUs: ``spawn`` raises rather than run fewer.

The ranks are started fresh (``spawn``), so ``fn`` and its arguments must
pickle (``fn`` by its import path; a script's ``__main__`` is re-imported
without running its ``if __name__ == "__main__":`` block). On the CPU each
rank uses one intra-op thread.
"""
from __future__ import annotations

import os
import queue as queue_mod
import tempfile
import traceback
from typing import Any, Callable, List, Sequence

import torch
import torch.distributed as dist
import torch.multiprocessing as mp


def _rank_main(rank: int, n: int, device: str, init: str, queue,
               fn: Callable, args: Sequence[Any]) -> None:
    try:
        if device == "cuda":
            torch.cuda.set_device(rank)
        else:
            torch.set_num_threads(1)
        dist.init_process_group("nccl" if device == "cuda" else "gloo",
                                init_method=init, rank=rank, world_size=n,
                                **({"device_id": torch.device("cuda", rank)}
                                   if device == "cuda" else {}))
        try:
            out = fn(rank, n, *args)
        finally:
            dist.destroy_process_group()
        queue.put((rank, True, out))
    except BaseException:
        queue.put((rank, False, traceback.format_exc()))
        raise


def spawn(fn: Callable, n: int, *, device: str = "cpu",
          args: Sequence[Any] = ()) -> List[Any]:
    """``fn(rank, n, *args)`` on ``n`` ranks; their return values."""
    if device not in ("cpu", "cuda"):
        raise ValueError(f"device {device!r}: 'cpu' or 'cuda'")
    if device == "cuda":
        have = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if have < n:
            raise RuntimeError(f"{n} ranks on the card need {n} GPUs, this "
                               f"machine has {have}; pass device='cpu' to run "
                               "them on the CPU")
    ctx = mp.get_context("spawn")
    queue = ctx.Queue()
    results: dict = {}
    failed: List[Any] = []
    with tempfile.TemporaryDirectory() as tmp:
        init = "file://" + os.path.join(tmp, "rendezvous")
        procs = [ctx.Process(target=_rank_main,
                             args=(r, n, device, init, queue, fn, tuple(args)))
                 for r in range(n)]
        for p in procs:
            p.start()
        try:
            while len(results) < n and not failed:
                try:
                    rank, ok, out = queue.get(timeout=1.0)
                except queue_mod.Empty:
                    dead = [r for r, p in enumerate(procs)
                            if p.exitcode not in (None, 0) and r not in results]
                    if dead:
                        failed.append((dead[0], f"exit code "
                                       f"{procs[dead[0]].exitcode}"))
                    continue
                if ok:
                    results[rank] = out
                else:
                    failed.append((rank, out))
        finally:
            for p in procs:
                if failed:
                    p.terminate()
                p.join()
    if failed:
        rank, why = failed[0]
        raise RuntimeError(f"rank {rank} failed:\n{why}")
    return [results[r] for r in range(n)]
