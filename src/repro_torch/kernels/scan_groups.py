"""The group checkpoint of the recurrent scans' training form, shared by
``rwkv6_scan.ops.Rwkv6ScanFunction`` and ``mamba_scan.ops.MambaScanFunction``.

Off the TPU the reference trains its chunked scans by autodiff of a
``lax.scan`` over groups of chunks, each group under ``jax.checkpoint``
(``repro/kernels/rwkv6_scan/ops.py:90-105``, ``mamba_scan/ops.py:87-101``):
its backward keeps each group's entry state and recomputes one group at a
time. These helpers write that by hand. The forward runs the groups in
order, through the kernel (one launch a group, the state passed on through
the kernel's state in and out) or through the plain chunked form, and keeps
each group's entry state. The backward walks the groups in reverse,
recomputes each one with the plain chunked form from its entry state under
autograd, and carries the state's gradient to the group before it.

Group boundaries fall on chunk boundaries, so the grouped forward computes
what one pass over the whole sequence computes.
"""
from __future__ import annotations

from typing import Callable, List, Optional, Sequence, Tuple

import torch

GROUP = 16      # chunks a group, halved until it divides the chunk count


def group_bounds(S: int, C: int) -> List[Tuple[int, int]]:
    """[(first step, end step)] of each group of chunks of ``C`` steps over
    a sequence of ``S`` (the reference's rule: 16 chunks a group, halved
    until the group divides the chunk count; only the last group's last
    chunk may be partial)."""
    n = -(-S // C)
    group = GROUP
    while n % group:
        group //= 2
    span = group * C
    return [(a, min(a + span, S)) for a in range(0, S, span)]


def forward_groups(run: Callable[[int, int, torch.Tensor],
                                 Tuple[torch.Tensor, torch.Tensor]],
                   S: int, C: int, state: torch.Tensor
                   ) -> Tuple[torch.Tensor, torch.Tensor, List[torch.Tensor]]:
    """``run(a, b, s)`` gives (out of steps [a, b), state after them) from
    the state ``s`` before step a. Returns (out of every step along dim 1,
    the final state, each group's entry state)."""
    outs, entries = [], []
    s = state
    for a, b in group_bounds(S, C):
        entries.append(s)
        out, s = run(a, b, s)
        outs.append(out)
    return torch.cat(outs, 1), s, entries


def backward_groups(body: Callable[..., Tuple[torch.Tensor, torch.Tensor]],
                    seqs: Sequence[torch.Tensor],
                    params: Sequence[torch.Tensor],
                    entries: Sequence[torch.Tensor], C: int,
                    dout: torch.Tensor, dstate: Optional[torch.Tensor]
                    ) -> Tuple[List[torch.Tensor], List[torch.Tensor],
                               torch.Tensor]:
    """Gradients of a scan that ``forward_groups`` ran. ``body(*seq
    slices, *params, s0)`` is the plain chunked form, giving (out, final
    state); ``seqs`` are the inputs along the sequence (dim 1), ``params``
    the inputs shared by every step, ``entries`` each group's entry state.
    Returns (the gradients of ``seqs`` in their dtypes, those of
    ``params`` in fp32, summed over every group as the reference sums them
    over its scan, and that of the initial state)."""
    S = seqs[0].shape[1]
    dseqs: List[List[torch.Tensor]] = [[] for _ in seqs]
    dparams = [torch.zeros(p.shape, dtype=torch.float32, device=p.device)
               for p in params]
    ds = dstate
    for (a, b), s0 in zip(reversed(group_bounds(S, C)), reversed(entries)):
        with torch.enable_grad():
            xs = [t[:, a:b].detach().requires_grad_(True) for t in seqs]
            ps = [p.detach().float().requires_grad_(True) for p in params]
            s0 = s0.detach().requires_grad_(True)
            out, s1 = body(*xs, *ps, s0)
            got = torch.autograd.grad((out, s1), xs + ps + [s0],
                                      (dout[:, a:b], ds))
        for acc, g in zip(dseqs, got):
            acc.append(g)
        for acc, g in zip(dparams, got[len(xs):-1]):
            acc += g
        ds = got[-1]
    return [torch.cat(d[::-1], 1) for d in dseqs], dparams, ds
