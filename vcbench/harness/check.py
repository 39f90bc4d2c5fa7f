"""The comparisons that decide ``correct``.

Serving: once the window has closed, a sample drawn from the seed of the
requests the fleet finished, with the longest among them, one of each
admission shape (rows, bucket, eager or graphed) the window met, and a
cross-section of the requests that held distinct slots at one instant.
The reference runs once over each prompt with its served tokens;
the number compared is the widest gap by which a served token's logit
lies below the reference's best at its position (greedy decoding: a
correct token's gap is 0 up to rounding). Every foreground request due in
the window must have come, and every finished request must hold exactly
the tokens it asked for.

Training: the program's loss at each of the first three steps, the norm
of each leaf's first gradient as the optimizer got it, and the norm of
each leaf's change after three steps, against the reference's, each gap
taken against the larger of the reference's norm of that leaf and of the
median leaf.
"""
from __future__ import annotations

import sys
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch


# ---------------------------------------------------------------- serving

def sample(win, max_len: int, warmed, seed: int, lim: Dict[str, int],
           exact: bool = False
           ) -> Tuple[List[Tuple[Any, Any]], Dict[str, Any]]:
    """(Sent, Request) pairs to compare, drawn from the seed among the
    requests due in the window: the longest; one of each admission shape
    (rows, bucket, eager or graphed) that admitted them; up to
    ``lim["cross_section"]`` of the requests that held a slot at one
    instant of the window, so each in a slot of its own; then others,
    until ``lim["served_tokens"]`` tokens and ``lim["min_requests"]``
    requests. ``exact``: the engine admits at exact lengths
    (``admission.groups``). Also returns what the sample covers, for the
    log."""
    from .admission import groups
    pool = [(s, win.done[s.uid]) for s in win.sent
            if s.uid in win.done and win.t0 <= s.due_ns < win.t1]
    if not pool:
        return [], {}
    rng = np.random.default_rng([int(seed) % 2 ** 63, 0x5eed])
    order = [pool[i] for i in rng.permutation(len(pool))]
    by_uid = {s.uid: (s, r) for s, r in order}
    picks = {}

    def add(p):
        picks.setdefault(p[0].uid, p)

    add(max(order, key=lambda p: len(p[1].tokens)))
    shape_of = {}
    for g in groups(win.served, max_len, warmed, exact):
        for u in g.uids:
            shape_of[u] = (g.rows, g.bucket, g.eager)
    covered = set()
    for s, r in order:
        key = shape_of.get(s.uid)
        if key is not None and key not in covered:
            covered.add(key)
            add((s, r))
    t0, t1 = win.t0 / 1e9, win.t1 / 1e9
    at = t0 + (t1 - t0) * float(rng.uniform(0.1, 0.9))
    live = [p for p in order if p[1].admitted_at <= at < p[1].finished_at]
    for p in live[:int(lim["cross_section"])]:
        add(p)
    for p in order:
        if (sum(len(r.tokens) for _, r in picks.values())
                >= int(lim["served_tokens"])
                and len(picks) >= int(lim["min_requests"])):
            break
        add(p)
    out = [by_uid[u] for u in picks]
    info = {"shapes": sorted(covered),
            "live_at_one_instant": min(len(live),
                                       int(lim["cross_section"])),
            "eager": sum(1 for s, _ in out if shape_of.get(
                s.uid, (0, 0, False))[2])}
    return out, info


def seqs_of(picks, device) -> List[torch.Tensor]:
    """Each prompt with its served tokens but the last (teacher forcing)."""
    return [torch.as_tensor(np.concatenate([s.prompt, np.asarray(
        r.tokens[:-1], np.int32)]), device=device) for s, r in picks]


def served_gaps(ref, weights, picks, device, control=None) -> List[float]:
    """The widest gap of each picked request's served tokens below the
    reference's best logit. With ``control`` (a reference in a lower
    precision), the gap of the token the control puts first instead."""
    seqs = seqs_of(picks, device)
    hs = ref.hidden(weights, seqs)
    hc = control.hidden(weights, seqs) if control is not None else None
    hw = ref.head_w(weights)
    out = []
    for i, (s, r) in enumerate(picks):
        P = len(s.prompt)
        rows = hs[i][P - 1:]
        toks = torch.as_tensor(r.tokens, device=device).long()
        crow = None if hc is None else hc[i][P - 1:]
        gaps = []
        for j, lg in enumerate(ref.logits(hw, rows)):
            n = lg.shape[0]
            if crow is None:
                pick = toks[j * 512:j * 512 + n]
            else:
                pick = torch.cat(list(control.logits(
                    hw, crow[j * 512:j * 512 + n]))).argmax(-1)
            gaps.append(lg.amax(-1) - lg.gather(-1, pick[:, None])[:, 0])
        out.append(float(torch.cat(gaps).max()))
        del rows
    return out


# ---------------------------------------------------------------- training

def leaf_gap(prog: Dict[str, float], ref: Dict[str, float],
             keep: Optional[Sequence[str]] = None) -> Tuple[float, str]:
    """The worst leaf's |prog - ref| over max(ref's norm of the leaf, the
    median leaf's norm); (gap, leaf)."""
    names = list(keep) if keep is not None else list(ref)
    med = float(np.median([ref[n] for n in ref]))
    worst, at = 0.0, ""
    for n in names:
        g = abs(prog[n] - ref[n]) / max(ref[n], med, 1e-30)
        if g > worst:
            worst, at = g, n
    return worst, at


def moved_leaves(ref_grad: Dict[str, float], rule: float = 1e-3
                 ) -> List[str]:
    """Leaves whose reference gradient is not nought to rounding: above
    ``rule`` of the median leaf's."""
    med = float(np.median(list(ref_grad.values())))
    return [n for n, v in ref_grad.items() if v >= rule * med]


# ---------------------------------------------------------------- output

def report(checks: Dict[str, Dict[str, float]]) -> bool:
    """Print each number compared beside its limit, as the last lines on
    standard error; True when every one is within it."""
    ok = True
    for name, c in checks.items():
        good = c["value"] <= c["limit"]
        ok = ok and good
        print(f"check {name} {c['value']!r} limit {c['limit']!r} "
              f"{'ok' if good else 'FAIL'}", file=sys.stderr)
    return ok
