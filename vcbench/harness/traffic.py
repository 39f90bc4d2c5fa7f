"""The one traffic generator: a mix file of parameters in, a schedule out.

A mix (``vcbench/mixes/<name>.json``) of ``"kind": "serve"`` lists its
tenants, each with a WRR ``weight`` and an arrival process:

- ``"poisson"``: an open loop at ``rate`` requests a second;
- ``"gamma"``: an open loop at ``rate`` with Gamma inter-arrival times of
  coefficient of variation ``cv`` (bursts, as BurstGPT describes);
- ``"closed"``: ``outstanding`` requests kept in flight, the next sent
  when one finishes.

Lengths are lognormal (``median``, ``sigma``, clipped to ``[min, max]``)
or uniform (``"dist": "uniform"`` over ``[min, max]``), given for the
whole mix (``prompt``, ``output``) or per tenant.

Every seed gets the same work in another order: the gaps between
arrivals and the (prompt, output) length pairs are drawn once from the
mix's ``base_seed`` and scaled to the window, and the run's seed only
reorders them and draws the token ids. So two seeds differ in order and
tokens, not in the amount of work. The mix's ``"order"`` says how:

- ``"shuffle"`` (the default): each tenant's gaps, and its length
  pairs, permuted apart;
- ``"rotate"``: the whole timeline drawn from ``base_seed``, every
  tenant's arrivals with their lengths, shifted by one offset drawn from
  the seed and wrapped round the window's end. Which bursts meet which
  long prompts is then the same for every seed, so a tail that those
  meetings set repeats from seed to seed; a closed-loop pool is rotated
  by a drawn index.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, List

import numpy as np


@dataclass
class Arrival:
    """One request of an open-loop tenant: due ``due`` seconds after the
    window opens."""
    tenant: str
    due: float
    prompt: np.ndarray          # int32 token ids
    max_new: int


@dataclass
class ClosedClient:
    """A closed-loop tenant: ``outstanding`` requests in flight, drawn in
    order from ``pool`` (prompt, max_new) as earlier ones finish."""
    tenant: str
    outstanding: int
    pool: List[Any]


@dataclass
class Schedule:
    arrivals: List[Arrival]
    closed: List[ClosedClient]
    foreground: List[str]


def _lengths(spec: Dict[str, Any], n: int, rng: np.random.Generator
             ) -> np.ndarray:
    lo, hi = int(spec["min"]), int(spec["max"])
    if spec.get("dist", "lognormal") == "uniform":
        return rng.integers(lo, hi + 1, n)
    x = np.exp(rng.normal(np.log(spec["median"]), spec["sigma"], n))
    return np.clip(np.rint(x), lo, hi).astype(np.int64)


def _gaps(tenant: Dict[str, Any], n: int, rng: np.random.Generator
          ) -> np.ndarray:
    rate = float(tenant["rate"])
    if tenant["arrival"] == "poisson":
        return rng.exponential(1.0 / rate, n)
    if tenant["arrival"] == "gamma":
        k = 1.0 / float(tenant["cv"]) ** 2
        return rng.gamma(k, 1.0 / (rate * k), n)
    raise ValueError(f"unknown arrival process {tenant['arrival']!r}")


def schedule(mix: Dict[str, Any], seed: int, seconds: float, vocab: int,
             rate_scale: float = 1.0) -> Schedule:
    """The schedule of one window of ``seconds``: open-loop arrivals sorted
    by due time, and the closed-loop clients. ``rate_scale`` multiplies
    every open-loop rate (the knee sweep)."""
    base = np.random.default_rng(int(mix.get("base_seed", 0)))
    run = np.random.default_rng(int(seed))
    order = mix.get("order", "shuffle")
    if order not in ("shuffle", "rotate"):
        raise ValueError(f"unknown order {order!r}")
    offset = run.uniform(0.0, seconds) if order == "rotate" else 0.0
    arrivals: List[Arrival] = []
    closed: List[ClosedClient] = []
    for t in mix["tenants"]:
        name = t["name"]
        p_spec = t.get("prompt", mix.get("prompt"))
        o_spec = t.get("output", mix.get("output"))
        if t["arrival"] == "closed":
            n = int(t.get("pool", 4096))
            lens = np.stack([_lengths(p_spec, n, base),
                             _lengths(o_spec, n, base)], 1)
            lens = (np.roll(lens, -int(run.integers(n)), 0)
                    if order == "rotate" else lens[run.permutation(n)])
            pool = [(run.integers(0, vocab, int(p)).astype(np.int32), int(o))
                    for p, o in lens]
            closed.append(ClosedClient(name, int(t["outstanding"]), pool))
            continue
        n = max(1, int(round(float(t["rate"]) * rate_scale * seconds)))
        gaps = _gaps(dict(t, rate=float(t["rate"]) * rate_scale), n + 1,
                     base)
        gaps *= seconds / gaps.sum()           # n arrivals inside the window
        if order == "shuffle":
            gaps = gaps[run.permutation(n + 1)]
        due = np.cumsum(gaps)[:n]
        lens = np.stack([_lengths(p_spec, n, base),
                         _lengths(o_spec, n, base)], 1)
        if order == "rotate":
            due = (due + offset) % seconds
        else:
            lens = lens[run.permutation(n)]
        for d, (p, o) in zip(due, lens):
            arrivals.append(Arrival(
                name, float(d), run.integers(0, vocab, int(p)).astype(np.int32),
                int(o)))
    arrivals.sort(key=lambda a: a.due)
    foreground = list(mix.get("foreground",
                              [t["name"] for t in mix["tenants"]]))
    return Schedule(arrivals, closed, foreground)
