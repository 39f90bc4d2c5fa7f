"""The one traffic generator: the same seed gives the same schedule,
another seed the same work in another order, and the mix's shares and
clips hold."""
import json
from collections import Counter
from pathlib import Path

import numpy as np
import pytest

from harness import traffic
from harness.admission import bucket

MIXES = Path(__file__).resolve().parents[1] / "mixes"


def load(name):
    return json.loads((MIXES / f"{name}.json").read_text())


def lengths(s):
    return sorted((len(a.prompt), a.max_new, a.tenant) for a in s.arrivals)


@pytest.mark.parametrize("mix", ["chat", "flood"])
def test_same_seed_same_schedule(mix):
    a = traffic.schedule(load(mix), 2 ** 33 + 5, 30, 152064)
    b = traffic.schedule(load(mix), 2 ** 33 + 5, 30, 152064)
    assert [(x.tenant, x.due, x.max_new) for x in a.arrivals] == \
        [(x.tenant, x.due, x.max_new) for x in b.arrivals]
    assert all(np.array_equal(x.prompt, y.prompt)
               for x, y in zip(a.arrivals, b.arrivals))


@pytest.mark.parametrize("mix", ["chat", "flood"])
def test_other_seed_same_work_other_order(mix):
    a = traffic.schedule(load(mix), 1, 30, 152064)
    b = traffic.schedule(load(mix), 2, 30, 152064)
    assert lengths(a) == lengths(b)
    assert [x.due for x in a.arrivals] != [x.due for x in b.arrivals]
    for c, d in zip(a.closed, b.closed):
        assert sorted((len(p), o) for p, o in c.pool) == \
            sorted((len(p), o) for p, o in d.pool)


def test_rotate_keeps_the_timeline():
    """Under ``"order": "rotate"`` two seeds share every arrival's gap to
    the next and its lengths; only the offset and the token ids differ."""
    mix = dict(load("flood"), order="rotate")
    a = traffic.schedule(mix, 1, 30, 152064)
    b = traffic.schedule(mix, 2 ** 33 + 7, 30, 152064)

    def ring(s, tenant):
        xs = [x for x in s.arrivals if x.tenant == tenant]
        k = int(np.argmax(np.diff([x.due for x in xs] + [xs[0].due + 30])))
        xs = xs[k + 1:] + xs[:k + 1]        # start after the widest gap
        return ([(len(x.prompt), x.max_new) for x in xs],
                np.diff([x.due for x in xs]) % 30)

    la, ga = ring(a, "tenant-steady")
    lb, gb = ring(b, "tenant-steady")
    assert la == lb
    np.testing.assert_allclose(ga, gb, atol=1e-9)
    assert [x.due for x in a.arrivals] != [x.due for x in b.arrivals]
    assert not np.array_equal(a.arrivals[0].prompt, b.arrivals[0].prompt)
    pa, pb = a.closed[0].pool, b.closed[0].pool
    assert sorted((len(p), o) for p, o in pa) == \
        sorted((len(p), o) for p, o in pb)
    assert all(0 <= x.due < 30 for x in a.arrivals + b.arrivals)
    with pytest.raises(ValueError):
        traffic.schedule(dict(mix, order="sorted"), 1, 30, 152064)


def test_shares_rates_and_clips():
    mix = load("chat")
    s = traffic.schedule(mix, 9, 30, 152064)
    counts = Counter(a.tenant for a in s.arrivals)
    for t in mix["tenants"]:
        assert counts[t["name"]] == round(t["rate"] * 30)
    assert all(0 < a.due < 30 for a in s.arrivals)
    assert all(16 <= len(a.prompt) <= 1500 for a in s.arrivals)
    assert all(16 <= a.max_new <= 500 for a in s.arrivals)
    assert all(a.prompt.max() < 152064 for a in s.arrivals)
    med = np.median([len(a.prompt) for a in s.arrivals])
    assert 150 < med < 400          # lognormal, median 256


def test_closed_loop_and_rate_scale():
    s = traffic.schedule(load("flood"), 3, 20, 152064)
    assert [c.tenant for c in s.closed] == ["tenant-bulk"]
    assert s.closed[0].outstanding == 64
    assert s.foreground == ["tenant-steady"]
    scaled = traffic.schedule(load("flood"), 3, 20, 152064, rate_scale=2.0)
    assert len(scaled.arrivals) == 2 * len(s.arrivals)


def test_uniform_outputs_and_buckets():
    mix = dict(load("chat"), output={"dist": "uniform", "min": 16,
                                     "max": 64},
               prompt={"dist": "lognormal", "median": 1200, "sigma": 0.3,
                       "min": 512, "max": 1900})
    s = traffic.schedule(mix, 4, 120, 152064)
    assert all(16 <= a.max_new <= 64 for a in s.arrivals)
    assert {a.max_new for a in s.arrivals} >= {16, 64}
    assert all(512 <= len(a.prompt) <= 1900 for a in s.arrivals)
    assert {bucket(len(a.prompt), 2048) for a in s.arrivals} == \
        {512, 1024, 2047}
