"""The benchmark harness of the PyTorch/CUDA port (``repro_torch``).

Everything that belongs to one configuration, one traffic mix or one
per-layer metric lives in a file of its own, found by the name that
``BENCHMARK.json`` gives it (``manifest.py``), and so does all that
depends on the architecture: the configuration names its reference
module (the weights' layout, the plain reference, the counts of
operations and bytes, the admission rule; the contract is in
``vcbench/reference/model.py``). The modules here are the yardstick:
traffic generation (``traffic.py``), the weights made from the seed
(``weights.py``), the chip's peaks (``flops.py``), the trace readers
(``kineto.py``), the two kinds of cell (``serve.py``, ``train.py``) and
the comparison that decides ``correct`` (``check.py``).
"""
