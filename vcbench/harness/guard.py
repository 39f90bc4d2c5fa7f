"""The run loads no JAX and not the JAX package: compared by the whole
top-level name of each loaded module (``repro_torch`` is not ``repro``)."""
from __future__ import annotations

import sys
from typing import Iterable, List

FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def forbidden_modules(names: Iterable[str] = None) -> List[str]:
    """The loaded modules whose top-level name is forbidden, sorted."""
    names = list(sys.modules) if names is None else list(names)
    return sorted(n for n in names if n.split(".")[0] in FORBIDDEN)
