#!/usr/bin/env python3
"""The benchmark of the PyTorch/CUDA port (``src/repro_torch``).

    python3 vcbench/run.py --workload qwen2-7b.chat --seed 7 --seconds 30 \
        --trace 0

Runs one cell of ``BENCHMARK.json`` on this machine's card and prints, as
the last line of standard output, one JSON object: ``correct``,
``attempted``, ``failed``, ``metrics`` (the cell's end-to-end metrics,
or with ``--trace 1`` its per-layer metrics), ``device``, with
``--trace 1`` a ``breakdown``, and last ``checks``, each number compared
with its limit (also the last lines of standard error). Earlier lines
describe the run. Exits non-zero, with no result, without a card (or
with fewer than the cell asks for), without the program beside it, or if
JAX or the JAX package was loaded.

Caches of compiled code stay inside the checkout, at fixed paths:
``.vcbench_cache/`` for Triton, PyTorch extensions and CUDA's JIT
cache, and the program's own ``src/repro_torch/kernels/_build/``.
"""
import argparse
import json
import os
import sys
import time
from pathlib import Path

T_START = time.monotonic()
ROOT = Path(__file__).resolve().parents[1]
CACHE = ROOT / ".vcbench_cache"


def _environment() -> None:
    for var, sub in (("TRITON_CACHE_DIR", "triton"),
                     ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("CUDA_CACHE_PATH", "nv")):
        os.environ[var] = str(CACHE / sub)
    os.environ["USE_FLAX"] = "0"
    sys.path.insert(0, str(ROOT / "vcbench"))
    sys.path.insert(0, str(ROOT / "src"))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    _environment()
    if not (ROOT / "src" / "repro_torch").is_dir():
        print("vcbench: the program (src/repro_torch) is not in this "
              "checkout", file=sys.stderr)
        return 2
    import torch
    from harness.cell import run_cell
    from harness.guard import forbidden_modules
    from harness.manifest import load_cell
    cell = load_cell(args.workload)
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell.chips:
        print(f"vcbench: {args.workload} needs {cell.chips} CUDA device(s); "
              f"this machine has "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2

    def log(msg):
        print(f"vcbench {args.workload}: {msg}", flush=True)

    out = run_cell(cell, args.seed, args.seconds, bool(args.trace),
                   torch.device("cuda"), T_START, log)
    bad = forbidden_modules()
    if bad:
        print(f"vcbench: loaded {bad}: the run must load neither JAX nor the "
              f"JAX package", file=sys.stderr)
        return 3
    sys.stderr.flush()
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
