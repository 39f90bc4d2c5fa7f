"""The chip's peaks, and the counts of operations and bytes that the
per-layer metrics read as ``run.flops``.

The peaks are those of ``src/repro_torch/roofline/analysis.py``
(NVIDIA's H100 SXM data sheet, dense rates). The counts depend on the
architecture, so each configuration's reference module holds them
(``vcbench/reference/model.py`` states the contract); ``counts`` puts
them beside the peaks, with the kernels' bounds bound to ``_bound``.
"""
from __future__ import annotations

from functools import partial
from types import SimpleNamespace
from typing import Any, Dict

from .manifest import reference

PEAK_BF16 = 989e12          # FLOP/s, dense
HBM_BW = 3.35e12            # bytes/s

COUNTS = ("num_params", "matmul_params", "model_flops_for", "prefill_flops",
          "decode_flops")
BOUNDS = ("attention_bound_s", "decode_attention_bound_s")


def _bound(flops: float, nbytes: float) -> float:
    return max(flops / PEAK_BF16, nbytes / HBM_BW)


def counts(config: Dict[str, Any]) -> SimpleNamespace:
    """``PEAK_BF16``, ``HBM_BW`` and the counts of ``config``'s reference
    module, each called as ``count(model, ...)``."""
    mod = reference(config)
    out = SimpleNamespace(PEAK_BF16=PEAK_BF16, HBM_BW=HBM_BW)
    for name in COUNTS:
        setattr(out, name, getattr(mod, name))
    for name in BOUNDS:
        setattr(out, name, partial(getattr(mod, name), bound=_bound))
    return out
