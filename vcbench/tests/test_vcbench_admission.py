"""What the harness reads from the served requests themselves: the
admission calls and their shapes, the tokens made inside a window, and
the sample that the check compares."""
from dataclasses import dataclass, field
from types import SimpleNamespace
from typing import List

import numpy as np
import pytest

from harness import admission, check


@dataclass
class Req:
    uid: int
    prompt: np.ndarray
    tokens: List[int] = field(default_factory=list)
    admit_started_at: float = 0.0
    admitted_at: float = 0.0
    first_token_at: float = 0.0
    finished_at: float = 0.0


def req(uid, plen, n_tok, start, end):
    return Req(uid, np.zeros(plen, np.int32), list(range(n_tok)), start,
               start + 0.01, start + 0.01, end)


@pytest.mark.parametrize("lo,hi,want", [
    (0.0, 12.0, 11.0),      # all of it
    (0.0, 10.0, 10.0),      # all but the last tenth of the other ten
    (1.0, 6.0, 6.0),        # the first token, then half of the other ten
    (6.0, 11.0, 5.0),       # the other half
    (20.0, 30.0, 0.0),      # none
])
def test_tokens_apportioned_by_time(lo, hi, want):
    r = Req(1, np.zeros(4, np.int32), list(range(11)), 1.0, 1.0, 1.0, 11.0)
    assert admission.tokens_between(r, lo, hi) == pytest.approx(want)


def test_live_seconds_in_a_window():
    r = Req(1, np.zeros(4, np.int32), [0, 1], 1.0, 2.0, 2.0, 6.0)
    assert admission.live_between(r, 0.0, 4.0) == pytest.approx(2.0)
    assert admission.live_between(r, 5.0, 9.0) == pytest.approx(1.0)


def test_groups_shapes_and_first_calls():
    reqs = [req(1, 100, 3, 1.0, 2.0), req(2, 120, 3, 1.0, 2.0),  # 2 x 128
            req(3, 100, 3, 2.0, 3.0),                             # 1 x 128
            req(4, 300, 3, 3.0, 4.0), req(5, 260, 3, 3.0, 4.0),  # 2 x 512
            req(6, 110, 3, 4.0, 5.0), req(7, 90, 3, 4.0, 5.0)]   # 2 x 128
    gs = admission.groups(reqs, 2048, warmed=[(1, 128)])
    assert [(g.shape, g.eager) for g in gs] == [
        ((2, 128), True), ((1, 128), False), ((2, 512), True),
        ((2, 128), False)]
    assert admission.histogram(gs) == {"1x128": 1, "2x128": 2, "2x512": 1}


def test_bucket_is_the_engines():
    assert [admission.bucket(n, 2048) for n in (1, 8, 9, 1500, 2000)] == \
        [8, 8, 16, 2047, 2047]


def test_sample_covers_every_shape_and_distinct_slots():
    reqs, sent = [], []
    t = 100.0
    for i in range(40):
        plen = [20, 100, 300, 700][i % 4]
        rows = 2 if i % 5 == 0 else 1
        start = t + i * 0.5
        for j in range(rows):
            uid = 2 * i + j
            r = req(uid, plen, 6, start, start + 3.0)
            reqs.append(r)
            sent.append(SimpleNamespace(uid=uid, due_ns=int(start * 1e9),
                                        prompt=r.prompt))
    win = SimpleNamespace(sent=sent, done={r.uid: r for r in reqs},
                          served=reqs, t0=int(t * 1e9),
                          t1=int((t + 25.0) * 1e9))
    lim = {"served_tokens": 30, "min_requests": 8, "cross_section": 4}
    picks, info = check.sample(win, 2048, [(1, 32)], 7, lim)
    shapes = {(g.rows, g.bucket, g.eager)
              for g in admission.groups(reqs, 2048, [(1, 32)])}
    assert set(info["shapes"]) == shapes
    assert info["live_at_one_instant"] == 4
    assert len(picks) >= 8 and len({s.uid for s, _ in picks}) == len(picks)
    again, _ = check.sample(win, 2048, [(1, 32)], 7, lim)
    assert [s.uid for s, _ in again] == [s.uid for s, _ in picks]
