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


def test_exact_admission_buckets_by_length_and_is_eager():
    """An engine whose layers keep a recurrent state admits each prompt at
    its length, never graphed: each call is its own shape, eager even
    where the shape was warmed or met before."""
    reqs = [req(1, 100, 3, 1.0, 2.0), req(2, 100, 3, 1.0, 2.0),  # 2 x 100
            req(3, 100, 3, 2.0, 3.0),                             # 1 x 100
            req(4, 300, 3, 3.0, 4.0),                             # 1 x 300
            req(5, 100, 3, 4.0, 5.0), req(6, 100, 3, 4.0, 5.0)]  # 2 x 100
    gs = admission.groups(reqs, 2048, warmed=[(1, 100)], exact=True)
    assert [(g.shape, g.eager) for g in gs] == [
        ((2, 100), True), ((1, 100), True), ((1, 300), True),
        ((2, 100), True)]
    assert [admission.bucket(n, 2048, exact=True) for n in (1, 9, 2000)] \
        == [1, 9, 2000]


@pytest.mark.parametrize("exact,want", [(False, [(2, 128, [100, 120]),
                                                  (1, 512, [300])]),
                                         (True, [(1, 100, [100]),
                                                 (1, 120, [120]),
                                                 (1, 300, [300])])])
def test_probe_groups_an_admit_call_by_the_engines_rule(exact, want):
    from harness.probe import Probe

    class Engine:
        slot_req, lengths = [None] * 4, [0] * 4

        def free_slots(self):
            return [0, 1, 2, 3]

        def admit_many(self, reqs):
            return reqs

        def step(self):
            return None

    probe, engine = Probe(2048, exact), Engine()
    probe.attach(engine)
    engine.admit_many([req(1, 100, 3, 0, 0), req(2, 300, 3, 0, 0),
                       req(3, 120, 3, 0, 0)])
    assert probe.admits[0].groups == want


def test_sample_under_exact_admission_names_every_call_eager():
    reqs, sent = [], []
    for i in range(12):
        r = req(i, [20, 33, 47][i % 3], 6, 100.0 + i, 103.0 + i)
        reqs.append(r)
        sent.append(SimpleNamespace(uid=i, due_ns=int(r.admit_started_at
                                                      * 1e9), prompt=r.prompt))
    win = SimpleNamespace(sent=sent, done={r.uid: r for r in reqs},
                          served=reqs, t0=int(100e9), t1=int(125e9))
    lim = {"served_tokens": 12, "min_requests": 2, "cross_section": 1}
    picks, info = check.sample(win, 2048, [(1, 32)], 7, lim, exact=True)
    assert set(info["shapes"]) == {(1, 20, True), (1, 33, True),
                                   (1, 47, True)}
    assert info["eager"] == len(picks)
