"""Percentiles: one definition for every metric."""
from __future__ import annotations

from typing import Sequence

import numpy as np


def pct(values: Sequence[float], q: float) -> float:
    """The ``q``-th percentile, linear between closest ranks (numpy's
    default); NaN for no values."""
    if len(values) == 0:
        return float("nan")
    return float(np.percentile(np.asarray(values, dtype=np.float64), q))
