"""The benchmark's tests import its harness and reference as top-level
packages, and the program from ``src``, as ``vcbench/run.py`` does."""
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
for p in (ROOT / "vcbench", ROOT / "src"):
    if str(p) not in sys.path:
        sys.path.insert(0, str(p))
