#!/usr/bin/env python3
"""Plants faults in the bf16 (``wgmma`` + TMA) route of the port's prefill
attention kernel and reports which of ``chip_smoke.py``'s checks see them.

    python3 tools/planted_faults_torch.py

Needs one CUDA card with sm_90a and ``nvcc``, as ``chip_smoke.py`` does.
For each fault it copies ``chip_smoke.py`` and ``src/`` into a temporary
directory, edits the copy of ``flash_attention.cu`` and, in a child
process run in that copy, builds the kernel and runs:

- each of the smoke's ``ENCDEC_SHAPES`` in bf16 against the plain version,
  the error printed beside the smoke's limit (2e-2);
- the smoke's bf16 parity of seamless-m4t-large-v2 (2 layers, 300 frames)
  and internvl2-2b (2 layers, 256 patches) at its limit (0.0625).

The faults, each a mistake the non-causal roles could make:

- ``ragged_tail_unmasked``: the last kv tile's rows past T are not masked,
  so their zero-filled keys enter the softmax at score 0;
- ``last_tile_dropped``: a non-causal call counts its kv tiles rounding
  down, so a ragged last tile is never loaded.

The checked-out tree is never edited. Exits 1 if a fault is seen by no
check, or if a fault's edit no longer applies to the source.
"""
from __future__ import annotations

import os
import shutil
import subprocess
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
SOURCE = Path("src/repro_torch/kernels/flash_attention/csrc/flash_attention.cu")
FAULTS = {
    "ragged_tail_unmasked": (
        "          k1 >= T_len || (causal && k1 > qa) ||",
        "          (causal && k1 > qa) ||"),
    "last_tile_dropped": (
        "const int n_tiles = hi > lo ? (hi + BK - 1) / BK - t0 : 0;",
        "const int n_tiles = hi > lo ? (causal ? (hi + BK - 1) / BK "
        ": hi / BK) - t0 : 0;"),
}
SHAPE_TOL, PARITY_TOL = 2e-2, 0.0625


def child(name: str) -> int:
    """In a faulty copy: the checks, one ``seen`` line for each that the
    fault breaks. Returns 0."""
    sys.path.insert(0, os.getcwd())
    import torch

    import chip_smoke as c
    from repro_torch.configs import get_config

    c.build_all([c.fa_kernel.KERNEL, c.fd_kernel.KERNEL])
    gen = torch.Generator(device="cuda").manual_seed(c.SEED + 9)
    for label, B, S, T, causal in c.ENCDEC_SHAPES:
        q = torch.randn((B, S, 16, 64), generator=gen,
                        device="cuda").bfloat16()
        k, v = (torch.randn((B, T, 16, 64), generator=gen,
                            device="cuda").bfloat16() for _ in range(2))
        ref = c.mha(q, k, v, causal=causal, impl="torch")
        err = c.max_err(c.mha(q, k, v, causal=causal, impl="cuda"), ref)
        print(f"{name} shape {label} bf16: max_abs_err {err!r} (limit "
              f"{SHAPE_TOL}, largest output {float(ref.abs().max())!r})")
        if err > SHAPE_TOL:
            print(f"seen {name} by the kernel check at {label}")
    runs = ((get_config("seamless-m4t-large-v2"), dict(frames=300)),
            (get_config("internvl2-2b"), dict(lens=(320, 290), max_len=512)))
    for cfg, kw in runs:
        try:
            c.parity_phase(cfg, 2, PARITY_TOL, "planted fault", **kw)
        except AssertionError:
            print(f"seen {name} by the bf16 parity of {cfg.name}")
    return 0


def main() -> int:
    missed = []
    for name, (old, new) in FAULTS.items():
        with tempfile.TemporaryDirectory() as tmp:
            copy = Path(tmp)
            shutil.copy2(ROOT / "chip_smoke.py", copy)
            shutil.copytree(ROOT / "src", copy / "src", ignore=(
                shutil.ignore_patterns("_build", "__pycache__")))
            src = (copy / SOURCE).read_text()
            if src.count(old) != 1:
                print(f"{name}: its edit does not apply to {SOURCE}")
                return 1
            (copy / SOURCE).write_text(src.replace(old, new))
            res = subprocess.run(
                [sys.executable, str(Path(__file__).resolve()), "--child",
                 name], cwd=copy, capture_output=True, text=True)
        sys.stdout.write(res.stdout)
        if res.returncode != 0:
            sys.stdout.write(res.stderr[-4000:])
            return 1
        if f"seen {name} " not in res.stdout:
            missed.append(name)
    print(f"planted faults: {len(FAULTS) - len(missed)} of {len(FAULTS)} "
          f"seen" + (f"; missed: {missed}" if missed else ""))
    return 1 if missed else 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--child"]:
        sys.exit(child(sys.argv[2]))
    sys.exit(main())
