"""Decode attention as a hand-written Hopper kernel
(``csrc/flash_decode.cu``), the port of the Pallas TPU kernel
``repro.kernels.flash_decode.kernel.flash_decode_pallas``.

bf16 q against a bf16 cache runs on the tensor cores (mma.sync, K/V tiles
loaded by TMA); fp32 q or an fp32 cache on the CUDA cores, in full fp32.

The wrapper checks device, dtype, shape and contiguity, chooses the chunk
length from the shapes (``split_len``), allocates the output and the fp32
chunk partials with ``torch.empty``, launches on the current stream and
counts its launches in ``KERNEL.launches``. It takes CUDA tensors only: the
plain version for the CPU is ``flash_attention.ops._decode_partials``.
``lengths`` stays on the device; the kernel reads each row's length itself,
so no host sync happens here. ``flash_decode_partials`` is the library's
second entry: one slice of a sequence-sharded cache at a global position
offset, returning the slice's unnormalised partials for the ranks to
combine (``flash_attention.ops._decode_mha_seq_sharded``).
The kernel has no backward: the wrapper raises when grad mode is on and
an input needs a gradient (``_build.refuse_autograd``).
"""
from __future__ import annotations

import ctypes
from pathlib import Path
from typing import Optional, Tuple

import torch

from .._build import CudaKernel, refuse_autograd, sm_count, stream_ptr

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float

KERNEL = CudaKernel(
    "flash_decode", Path(__file__).resolve().parent / "csrc" / "flash_decode.cu",
    "flash_decode_fwd",
    [_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _I, _F,
     _F, _P])

DTYPES = {torch.float32: 0, torch.bfloat16: 1}
TILE = 64              # cache positions of one tile of the tensor-core kernel
BLOCKS_PER_SM = 2      # chunks enough for this many blocks an SM
MAX_GROUP = 32         # q heads per kv head that fit the shared-memory plan


def split_len(B: int, L: int, KV: int, G: int, sms: int) -> int:
    """Cache positions per block, a multiple of ``TILE``: the fewest that
    still give ``BLOCKS_PER_SM * sms`` blocks, each block one chunk of a
    (row, kv head, 16 q heads), but at least two tiles (shorter chunks cost
    more in partials to combine than their blocks gain). Rows shorter than
    L leave some blocks empty; those exit at once."""
    per_chunk = B * KV * -(-G // 16)
    nsplit = max(1, -(-BLOCKS_PER_SM * sms // per_chunk))
    return max(2 * TILE, -(-L // (nsplit * TILE)) * TILE)


def _check(q, k_cache, v_cache, lengths) -> None:
    for name, t in (("q", q), ("k_cache", k_cache), ("v_cache", v_cache),
                    ("lengths", lengths)):
        if not t.is_cuda or t.device != q.device:
            raise ValueError(f"flash_decode: {name} is on {t.device}; the "
                             "kernel takes CUDA tensors on one device only")
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"flash_decode: {name} must be contiguous and "
                             "16-byte aligned")
    if q.dtype not in DTYPES or k_cache.dtype not in DTYPES \
            or v_cache.dtype != k_cache.dtype:
        raise TypeError(f"flash_decode: q {q.dtype}, caches "
                        f"{k_cache.dtype}/{v_cache.dtype}; each must be "
                        "float32 or bfloat16, the two caches alike")
    if lengths.dtype != torch.int32:
        raise TypeError(f"flash_decode: lengths must be int32, got {lengths.dtype}")
    if q.dim() != 4 or q.shape[1] != 1 or k_cache.dim() != 4:
        raise ValueError(f"flash_decode: q {tuple(q.shape)} must be [B,1,H,D], "
                         f"caches {tuple(k_cache.shape)} [B,L,KV,D]")
    B, _, H, D = q.shape
    if (k_cache.shape != v_cache.shape or k_cache.shape[0] != B
            or k_cache.shape[3] != D or tuple(lengths.shape) != (B,)):
        raise ValueError(f"flash_decode: q {tuple(q.shape)}, caches "
                         f"{tuple(k_cache.shape)}/{tuple(v_cache.shape)}, "
                         f"lengths {tuple(lengths.shape)}")
    KV = k_cache.shape[2]
    if H % KV or H // KV > MAX_GROUP:
        raise ValueError(f"flash_decode: {H} q heads over {KV} kv heads")
    if D % 8 or not 8 <= D <= 256:
        raise ValueError(f"flash_decode: head dim {D} must be a multiple of 8 "
                         "in [8, 256]")


def flash_decode(q: torch.Tensor, k_cache: torch.Tensor,
                 v_cache: torch.Tensor, lengths: torch.Tensor, *,
                 window: int = 0, softcap: float = 0.0,
                 scale: Optional[float] = None) -> torch.Tensor:
    """q: [B,1,H,D]; caches [B,L,KV,D]; lengths [B] int32 -> [B,1,H,D]."""
    refuse_autograd("flash_decode", q, k_cache, v_cache)
    _check(q, k_cache, v_cache, lengths)
    B, _, H, D = q.shape
    L, KV = k_cache.shape[1], k_cache.shape[2]
    G = H // KV
    scale = scale if scale is not None else D ** -0.5
    out = torch.empty_like(q)
    if B == 0 or L == 0:
        return out.zero_()
    split = split_len(B, L, KV, G, sm_count(q.device.index))
    nsplit = -(-L // split)
    f32 = dict(dtype=torch.float32, device=q.device)
    acc = torch.empty((B, KV, nsplit, G, D), **f32)
    m = torch.empty((B, KV, nsplit, G), **f32)
    l = torch.empty((B, KV, nsplit, G), **f32)
    fn = KERNEL.fn()
    KERNEL.count_launch()
    rc = fn(q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(),
            lengths.data_ptr(), acc.data_ptr(), m.data_ptr(), l.data_ptr(),
            out.data_ptr(), B, L, H, KV, D, DTYPES[q.dtype],
            DTYPES[k_cache.dtype], split, int(window), float(softcap),
            float(scale), stream_ptr(q))
    KERNEL.check(rc)
    return out


PARTIALS_ARGS = [_P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I,
                 _I, _I, _I, _I, _I, _F, _F, _P]


def flash_decode_partials(q: torch.Tensor, k_cache: torch.Tensor,
                          v_cache: torch.Tensor, lengths: torch.Tensor, *,
                          pos_offset: int, window: int = 0,
                          softcap: float = 0.0, scale: Optional[float] = None
                          ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The unnormalised partials of one slice of a sequence-sharded cache:
    caches [B, L, KV, D] hold global positions [pos_offset, pos_offset +
    L), ``lengths`` [B] int32 are global. Returns fp32 (acc [B, KV, G, D],
    m [B, KV, G], l [B, KV, G]), masks and window at global positions; a
    row with no valid position in the slice gets acc 0, m -1e30, l 0. The
    plain version is ``flash_attention.ops._decode_partials(...,
    pos_offset=...)``. One launch of the partial kernel and one of the
    merge, counted as one."""
    refuse_autograd("flash_decode_partials", q, k_cache, v_cache)
    _check(q, k_cache, v_cache, lengths)
    if pos_offset < 0:
        raise ValueError(f"flash_decode_partials: pos_offset {pos_offset}")
    B, _, H, D = q.shape
    L, KV = k_cache.shape[1], k_cache.shape[2]
    G = H // KV
    scale = scale if scale is not None else D ** -0.5
    f32 = dict(dtype=torch.float32, device=q.device)
    if B == 0 or L == 0:
        return (torch.zeros((B, KV, G, D), **f32),
                torch.full((B, KV, G), -1e30, **f32),
                torch.zeros((B, KV, G), **f32))
    acc_out = torch.empty((B, KV, G, D), **f32)    # the merge writes all
    m_out = torch.empty((B, KV, G), **f32)
    l_out = torch.empty((B, KV, G), **f32)
    split = split_len(B, L, KV, G, sm_count(q.device.index))
    nsplit = -(-L // split)
    acc = torch.empty((B, KV, nsplit, G, D), **f32)
    m = torch.empty((B, KV, nsplit, G), **f32)
    l = torch.empty((B, KV, nsplit, G), **f32)
    fn = KERNEL.entry("flash_decode_partials", PARTIALS_ARGS)
    KERNEL.count_launch()
    rc = fn(q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(),
            lengths.data_ptr(), acc.data_ptr(), m.data_ptr(), l.data_ptr(),
            acc_out.data_ptr(), m_out.data_ptr(), l_out.data_ptr(), B, L, H,
            KV, D, DTYPES[q.dtype], DTYPES[k_cache.dtype], split,
            int(pos_offset), int(window), float(softcap), float(scale),
            stream_ptr(q))
    KERNEL.check(rc)
    return acc_out, m_out, l_out


def variant(q: torch.Tensor, k_cache: torch.Tensor) -> str:
    """The partial kernel ``flash_decode`` launches for these dtypes and
    head dim, as the C library chooses it."""
    fn = KERNEL.entry("flash_decode_variant", [_I, _I, _I])
    tc = fn(DTYPES[q.dtype], DTYPES[k_cache.dtype], q.shape[-1])
    return "bf16 mma.sync, TMA ring" if tc else "fp32 CUDA cores"
