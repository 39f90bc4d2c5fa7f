"""Device resolution for the port's entry points, and the process's one
CUDA-graph capture lock.

Entry points run on the card unless the caller asks for the CPU: ``None``
means ``"cuda"``, and a missing card is an error, never a quiet fallback.
"""
from __future__ import annotations

import threading
from typing import Union

import torch

DeviceLike = Union[str, torch.device, None]

CAPTURE_LOCK = threading.RLock()
"""Held by every CUDA-graph capture of the port, from its warm-up on the
capture stream to the end of the capture (``serving.engine._capture_graph``),
so that captures in one process take turns.

A device-wide sync, or a release of the allocator's cached blocks, while
another thread's stream captures is refused by CUDA
(``cudaErrorStreamCaptureUnsupported``), and the refusal also invalidates
that capture (``torch.cuda.graph`` makes both at the start of every
capture, which is why two of them at once both fail). Code outside the
port that makes a device-wide sync or releases the cache while engines may
be capturing on other threads (a fleet's replicas are built on pool
threads, and each engine captures its admission graphs lazily on its drive
thread) takes this lock first. Reentrant, so a capture may be started by a
thread that holds it. An engine's admission capture takes it without
blocking and, where another thread holds it, leaves that shape eager for
now (``GenerationEngine._capture_admit``)."""


def resolve_device(device: DeviceLike = None) -> torch.device:
    """``None`` -> ``cuda`` (raises when CUDA is absent); else as given."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "CUDA is not available; pass device='cpu' to run on the CPU")
        return torch.device("cuda")
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {dev} requested but CUDA is not available")
    return dev
