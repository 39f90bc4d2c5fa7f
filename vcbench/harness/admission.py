"""What the served requests themselves say about admission and output,
read from the timestamps ``GenerationEngine`` sets on each ``Request``.

``admit_many`` makes one fused call per prompt-length bucket and stamps
every request of that call with the same ``admit_started_at``; so the
requests that share it are one (rows, bucket) admission shape. A shape
met before (warmed in set-up, or earlier in the run) replays its graph;
the first call of a shape runs eagerly and is then captured. Where the
configuration's reference module says that the engine admits at exact
lengths (``exact_admission``), a call's bucket is its prompts' length
and every call is eager.

A request's first token is made at ``first_token_at``; the rest come one
a decode step until ``finished_at``. Counted over a window, they are
apportioned by time: the first token where it came, the others spread
evenly over (``first_token_at``, ``finished_at``].
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Iterable, List, Sequence, Set, Tuple

import numpy as np


def bucket(n: int, max_len: int, exact: bool = False) -> int:
    """The engine's prompt bucket: the next power of two from 8, capped at
    ``max_len - 1``; with ``exact``, ``n`` itself."""
    if exact:
        return n
    b = 8
    while b < n:
        b <<= 1
    return min(b, max_len - 1)


@dataclass
class Group:
    """One fused admission call: ``rows`` requests padded to ``bucket``."""
    started: float              # time.monotonic seconds
    rows: int
    bucket: int
    eager: bool
    uids: List[int]

    @property
    def shape(self) -> Tuple[int, int]:
        return (self.rows, self.bucket)


def groups(requests: Iterable, max_len: int,
           warmed: Iterable[Tuple[int, int]], exact: bool = False
           ) -> List[Group]:
    """The admission calls of ``requests`` (every request served so far,
    so that a shape's first call is found), in time order; a call is
    eager where its shape was neither warmed nor met before it, and every
    call is with ``exact`` (exact-length admission)."""
    by_start: Dict[float, list] = {}
    for r in requests:
        if r.admit_started_at > 0:
            by_start.setdefault(r.admit_started_at, []).append(r)
    seen: Set[Tuple[int, int]] = set(tuple(s) for s in warmed)
    out = []
    for t in sorted(by_start):
        rs = by_start[t]
        b = bucket(int(np.asarray(rs[0].prompt).reshape(-1).shape[0]),
                   max_len, exact)
        shape = (len(rs), b)
        out.append(Group(t, len(rs), b, exact or shape not in seen,
                         [r.uid for r in rs]))
        seen.add(shape)
    return out


def tokens_between(r, lo: float, hi: float) -> float:
    """The tokens of request ``r`` made in [lo, hi) (monotonic seconds):
    the first at ``first_token_at``, the others spread evenly over
    (``first_token_at``, ``finished_at``]."""
    f, e, n = r.first_token_at, r.finished_at, len(r.tokens)
    if n == 0 or f <= 0:
        return 0.0
    out = 1.0 if lo <= f < hi else 0.0
    if n > 1:
        if e > f:
            overlap = max(0.0, min(e, hi) - max(f, lo))
            out += (n - 1) * overlap / (e - f)
        elif lo <= f < hi:
            out += n - 1
    return out


def live_between(r, lo: float, hi: float) -> float:
    """Seconds of [lo, hi) in which ``r`` held a slot (admitted, not yet
    finished)."""
    if r.admitted_at <= 0 or r.finished_at <= r.admitted_at:
        return 0.0
    return max(0.0, min(r.finished_at, hi) - max(r.admitted_at, lo))


def histogram(gs: Sequence[Group]) -> Dict[str, int]:
    """Calls a (rows, bucket) shape, as "rows x bucket": count."""
    out: Dict[str, int] = {}
    for g in sorted(gs, key=lambda g: (g.bucket, g.rows)):
        key = f"{g.rows}x{g.bucket}"
        out[key] = out.get(key, 0) + 1
    return out
