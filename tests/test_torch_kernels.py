"""Attention kernels of the PyTorch port against the JAX package.

On the CPU: the port's plain versions ("torch") and oracles ("ref") against
the Pallas kernels in interpret mode and the JAX oracles, on the shapes of
``tests/test_kernels.py``, with its tolerances (fp32 2e-5; bf16 2e-2 for
prefill and 3e-2 for decode: one bf16 ulp at |x| ~ 2-4, plus p rounded to
bf16 before the PV product at different running maxima).

On the card (marker ``cuda``; skipped without one): the hand-written CUDA
kernels against the plain versions on the same shapes plus the serving
shapes (qwen2-7b: G = 28/4 = 7; gemma2: D 256; reduced: D 16) and the
edges of the bf16 kernel's tiles. The fp32 cases hold the fp32 path to
2e-5, which TF32 products would miss. These need no JAX, so the file runs
on a machine without it.
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels.flash_attention import ops as t_ops
from repro_torch.kernels.flash_attention.ref import mha_ref as t_mha_ref
from repro_torch.kernels.flash_decode.ops import flash_decode as t_flash_decode

ATTN_CASES = [
    # B, S, T, H, KV, D, causal, window, softcap  (tests/test_kernels.py:27)
    (2, 128, 128, 4, 2, 64, True, 0, 0.0),
    (1, 100, 100, 4, 4, 32, True, 48, 50.0),     # ragged + window + softcap
    (2, 64, 256, 8, 2, 64, True, 0, 0.0),        # cross-size (q_offset)
    (1, 64, 64, 2, 1, 128, False, 0, 0.0),       # bidirectional (encoder)
    (1, 70, 150, 2, 1, 32, True, 0, 0.0),        # ragged S, q_offset 80
    (1, 160, 160, 2, 2, 16, True, 24, 0.0),      # window masks whole tiles
    # non-causal, as the encoder-decoder runs it (seamless: H = KV, D 64)
    (2, 40, 200, 4, 2, 64, False, 0, 0.0),       # cross-attention, S < T
    (1, 150, 70, 4, 4, 32, False, 0, 0.0),       # S > T
    (2, 1, 1024, 4, 4, 64, False, 0, 0.0),       # one-row decode cross query
    (1, 96, 96, 16, 16, 64, False, 0, 0.0),      # encoder heads, G = 1
]
DECODE_CASES = [
    # B, L, H, KV, D, window, softcap  (tests/test_kernels.py:97)
    (2, 256, 8, 2, 64, 0, 0.0),
    (3, 200, 4, 4, 32, 64, 30.0),
    (2, 512, 16, 8, 128, 0, 0.0),
]
DTYPES = ["float32", "bfloat16"]
PREFILL_TOL = {"float32": 2e-5, "bfloat16": 2e-2}
DECODE_TOL = {"float32": 2e-5, "bfloat16": 3e-2}


@pytest.fixture(scope="module")
def jref():
    """The JAX reference kernels (skips where JAX is not installed)."""
    pytest.importorskip("jax")
    import jax.numpy as jnp
    from repro.kernels.flash_attention.kernel import flash_attention
    from repro.kernels.flash_attention.ref import mha_ref
    from repro.kernels.flash_decode.kernel import flash_decode_pallas
    from repro.kernels.flash_decode.ref import flash_decode_ref
    return dict(jnp=jnp, flash_attention=flash_attention, mha_ref=mha_ref,
                flash_decode_pallas=flash_decode_pallas,
                flash_decode_ref=flash_decode_ref)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _attn_inputs(case, seed=0):
    B, S, T, H, KV, D = case[:6]
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s).astype(np.float32)
            for s in ((B, S, H, D), (B, T, KV, D), (B, T, KV, D))]


def _decode_inputs(case, seed=0):
    B, L, H, KV, D = case[:5]
    rng = np.random.default_rng(seed)
    q, k, v = [rng.standard_normal(s).astype(np.float32)
               for s in ((B, 1, H, D), (B, L, KV, D), (B, L, KV, D))]
    lengths = rng.integers(L // 2, L + 1, (B,)).astype(np.int32)
    return q, k, v, lengths


def _t(x, dtype, device="cpu"):
    return torch.from_numpy(x).to(device=device, dtype=getattr(torch, dtype))


def _j(jnp, x, dtype):
    return jnp.asarray(x).astype(getattr(jnp, dtype))


def _close(out, ref, tol):
    np.testing.assert_allclose(np.asarray(out, np.float32),
                               np.asarray(ref, np.float32), atol=tol, rtol=tol)


# ------------------------------------------------------------ CPU: vs JAX

@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("case", ATTN_CASES)
def test_mha_torch_vs_pallas_interpret(jref, case, dtype):
    B, S, T, H, KV, D, causal, window, softcap = case
    q, k, v = _attn_inputs(case)
    qoff = T - S if causal else 0
    jnp = jref["jnp"]
    ref = jref["flash_attention"](
        _j(jnp, q, dtype), _j(jnp, k, dtype), _j(jnp, v, dtype),
        causal=causal, window=window, softcap=softcap, q_offset=qoff,
        block_q=32, block_k=32, interpret=True)
    out = t_ops.mha(_t(q, dtype), _t(k, dtype), _t(v, dtype), causal=causal,
                    window=window, softcap=softcap, q_offset=qoff,
                    q_chunk=32, kv_chunk=32, impl="torch")
    assert out.dtype == getattr(torch, dtype)
    _close(out.float(), ref, PREFILL_TOL[dtype])


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("case", ATTN_CASES)
def test_mha_ref_vs_jax_ref(jref, case, dtype):
    B, S, T, H, KV, D, causal, window, softcap = case
    q, k, v = _attn_inputs(case, seed=1)
    qoff = T - S if causal else 0
    jnp = jref["jnp"]
    ref = jref["mha_ref"](_j(jnp, q, dtype), _j(jnp, k, dtype),
                          _j(jnp, v, dtype), causal=causal, window=window,
                          softcap=softcap, q_offset=qoff)
    out = t_mha_ref(_t(q, dtype), _t(k, dtype), _t(v, dtype), causal=causal,
                    window=window, softcap=softcap, q_offset=qoff)
    _close(out.float(), ref, PREFILL_TOL[dtype])


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("case", DECODE_CASES)
def test_decode_torch_vs_pallas_interpret(jref, case, dtype):
    B, L, H, KV, D, window, softcap = case
    q, k, v, lengths = _decode_inputs(case)
    jnp = jref["jnp"]
    ref = jref["flash_decode_pallas"](
        _j(jnp, q, dtype), _j(jnp, k, dtype), _j(jnp, v, dtype),
        jnp.asarray(lengths), window=window, softcap=softcap, block_k=64,
        interpret=True)
    out = t_ops.decode_mha(_t(q, dtype), _t(k, dtype), _t(v, dtype),
                           torch.from_numpy(lengths), window=window,
                           softcap=softcap, kv_chunk=64, impl="torch")
    assert out.shape == (B, 1, H, D)
    _close(out.float(), ref, DECODE_TOL[dtype])


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("case", DECODE_CASES)
def test_decode_refs_vs_jax_ref(jref, case, dtype):
    B, L, H, KV, D, window, softcap = case
    q, k, v, lengths = _decode_inputs(case, seed=1)
    jnp = jref["jnp"]
    ref = jref["flash_decode_ref"](
        _j(jnp, q, dtype), _j(jnp, k, dtype), _j(jnp, v, dtype),
        jnp.asarray(lengths), window=window, softcap=softcap)
    args = (_t(q, dtype), _t(k, dtype), _t(v, dtype),
            torch.from_numpy(lengths))
    out = t_flash_decode(*args, window=window, softcap=softcap, impl="ref")
    _close(out.float(), ref, DECODE_TOL[dtype])
    out = t_ops.decode_mha(*args, window=window, softcap=softcap, impl="ref")
    _close(out.float(), ref, DECODE_TOL[dtype])


# ------------------------------------------------------------ CPU dispatch

def test_cpu_tensors_take_the_plain_version():
    case = ATTN_CASES[1]
    q, k, v = (torch.from_numpy(x) for x in _attn_inputs(case))
    kw = dict(window=48, softcap=50.0)
    assert torch.equal(t_ops.mha(q, k, v, **kw),
                       t_ops.mha(q, k, v, impl="torch", **kw))
    dq, dk, dv, lengths = (torch.from_numpy(x)
                           for x in _decode_inputs(DECODE_CASES[0]))
    assert torch.equal(t_ops.decode_mha(dq, dk, dv, lengths),
                       t_ops.decode_mha(dq, dk, dv, lengths, impl="torch"))


def test_kernel_wrappers_refuse_cpu_tensors():
    """A wrapper never falls back: on a CPU tensor it raises before any
    build or launch, and its launch count stays put."""
    from repro_torch.kernels.flash_attention import kernel as fa
    from repro_torch.kernels.flash_decode import kernel as fd
    q, k, v = (torch.from_numpy(x) for x in _attn_inputs(ATTN_CASES[0]))
    before = (fa.KERNEL.launches, fd.KERNEL.launches)
    with pytest.raises(ValueError, match="CUDA"):
        t_ops.mha(q, k, v, impl="cuda")
    dq, dk, dv, lengths = (torch.from_numpy(x)
                           for x in _decode_inputs(DECODE_CASES[0]))
    with pytest.raises(ValueError, match="CUDA"):
        t_ops.decode_mha(dq, dk, dv, lengths, impl="cuda")
    with pytest.raises(ValueError, match="unknown"):
        t_ops.mha(q, k, v, impl="xla")
    assert (fa.KERNEL.launches, fd.KERNEL.launches) == before


# ------------------------------------------------------------ card: kernels

CUDA_ATTN_CASES = ATTN_CASES + [
    (2, 200, 200, 28, 4, 128, True, 0, 0.0),      # qwen2-7b heads, G = 7
    (1, 96, 96, 4, 2, 256, True, 32, 50.0),       # gemma2 head dim + window
    (3, 40, 40, 4, 4, 16, True, 0, 0.0),          # reduced configs
    # the bf16 kernel's tile edges (tile shape: Cfg in flash_attention.cu)
    (1, 1023, 1023, 28, 4, 128, True, 0, 0.0),    # served bucket, partial last tiles
    (2, 65, 300, 4, 2, 128, True, 0, 0.0),        # partial on both axes, q_offset 235
    (1, 300, 300, 4, 2, 64, True, 40, 50.0),      # gemma2: window edge inside a kv tile
    (1, 200, 200, 4, 2, 256, True, 40, 50.0),     # the same at D 256
    (2, 600, 600, 4, 1, 128, True, 100, 0.0),     # whole kv tiles masked for some rows
    (3, 130, 130, 8, 2, 64, True, 0, 0.0),        # 3 batch rows: no fill across a row's edge
    # seamless's non-causal shapes: encoder, speech-path cross, decode cross
    (2, 1000, 1000, 16, 16, 64, False, 0, 0.0),   # ragged last kv tile
    (8, 16, 1000, 16, 16, 64, False, 0, 0.0),
    (8, 1, 1000, 16, 16, 64, False, 0, 0.0),
]
CUDA_DECODE_CASES = DECODE_CASES + [
    (4, 1000, 28, 4, 128, 0, 0.0),                # qwen2-7b heads, G = 7
    (2, 600, 16, 8, 256, 100, 30.0),              # gemma2 head dim + window
    (3, 48, 4, 4, 16, 0, 0.0),                    # reduced configs
    # the tensor-core kernel's edges (16 q heads a block, 64-position tiles,
    # chunk length from flash_decode/kernel.py:split_len)
    (2, 300, 4, 4, 64, 0, 0.0),                   # G = 1
    (2, 300, 32, 8, 128, 0, 0.0),                 # G = 4 (jamba's heads)
    (2, 300, 8, 1, 128, 0, 0.0),                  # G = 8
    (2, 300, 16, 1, 128, 0, 0.0),                 # G = 16: all 16 rows of A
    (2, 300, 32, 1, 64, 0, 0.0),                  # G = 32: two blocks of 16 heads
    (1, 1000, 28, 4, 128, 0, 0.0),                # B 1: the split spreads one row
    (2, 600, 8, 2, 64, 100, 30.0),                # D 64 with window and softcap
    (1, 700, 8, 4, 256, 300, 50.0),               # D 256 with window and softcap
    (4, 4096, 32, 4, 128, 0, 0.0),                # chunks longer than the ring
]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("case", CUDA_ATTN_CASES)
def test_flash_attention_kernel_vs_plain(cuda, case, dtype):
    B, S, T, H, KV, D, causal, window, softcap = case
    q, k, v = (_t(x, dtype, cuda) for x in _attn_inputs(case))
    qoff = T - S if causal else 0
    kw = dict(causal=causal, window=window, softcap=softcap, q_offset=qoff)
    out = t_ops.mha(q, k, v, impl="cuda", **kw)
    ref = t_ops.mha(q, k, v, impl="torch", **kw)
    torch.cuda.synchronize()
    _close(out.float().cpu(), ref.float().cpu(), PREFILL_TOL[dtype])


@pytest.mark.cuda
@pytest.mark.parametrize("cache_dtype", DTYPES)
@pytest.mark.parametrize("q_dtype", DTYPES)
@pytest.mark.parametrize("case", CUDA_DECODE_CASES)
def test_flash_decode_kernel_vs_plain(cuda, case, q_dtype, cache_dtype):
    B, L, H, KV, D, window, softcap = case
    q, k, v, lengths = _decode_inputs(case)
    lengths[0], lengths[-1] = 1, L          # the ragged extremes
    q = _t(q, q_dtype, cuda)
    k, v = _t(k, cache_dtype, cuda), _t(v, cache_dtype, cuda)
    lens = torch.from_numpy(lengths).to(cuda)
    kw = dict(window=window, softcap=softcap)
    out = t_ops.decode_mha(q, k, v, lens, impl="cuda", **kw)
    ref = t_ops.decode_mha(q, k, v, lens, impl="torch", **kw)
    torch.cuda.synchronize()
    tol = DECODE_TOL["bfloat16" if "bfloat16" in (q_dtype, cache_dtype)
                     else "float32"]
    _close(out.float().cpu(), ref.float().cpu(), tol)
    from repro_torch.kernels.flash_decode import kernel as fd
    tc = q_dtype == cache_dtype == "bfloat16" and D in (16, 32, 64, 128, 256)
    assert fd.variant(q, k).startswith("bf16 mma.sync" if tc else "fp32")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("window", [0, 100])
def test_flash_decode_kernel_at_split_edges(cuda, dtype, window):
    """Row lengths of 1, at the 64-position tile edges and at the edges of
    the chunk that the host chose for this card (qwen2-7b's heads)."""
    from repro_torch.kernels.flash_decode import kernel as fd
    B, L, H, KV, D = 10, 1024, 28, 4, 128
    split = fd.split_len(B, L, KV, H // KV, fd.sm_count(cuda.index or 0))
    assert split % fd.TILE == 0 and split < L
    lengths = np.array([1, 63, 64, 65, split - 1, split, split + 1,
                        2 * split + 1, L - 1, L], np.int32)
    q, k, v, _ = _decode_inputs((B, L, H, KV, D))
    q, k, v = (_t(x, dtype, cuda) for x in (q, k, v))
    lens = torch.from_numpy(lengths).to(cuda)
    out = t_ops.decode_mha(q, k, v, lens, impl="cuda", window=window)
    ref = t_ops.decode_mha(q, k, v, lens, impl="torch", window=window)
    torch.cuda.synchronize()
    _close(out.float().cpu(), ref.float().cpu(), DECODE_TOL[dtype])


@pytest.mark.cuda
def test_flash_decode_ignores_the_cache_past_each_length(cuda):
    """NaN in the cache past a row's length (memory a real cache never
    wrote) must not reach the output: the kernels never multiply it in."""
    B, L, H, KV, D = 3, 500, 28, 4, 128
    q, k, v, _ = _decode_inputs((B, L, H, KV, D))
    lengths = np.array([1, 130, 437], np.int32)
    for i, n in enumerate(lengths):
        k[i, n:] = np.nan
        v[i, n:] = np.nan
    for dtype in DTYPES:
        qt, kt, vt = (_t(x, dtype, cuda) for x in (q, k, v))
        lens = torch.from_numpy(lengths).to(cuda)
        out = t_ops.decode_mha(qt, kt, vt, lens, impl="cuda")
        want = t_ops.decode_mha(qt, kt, vt, lens, impl="ref")
        torch.cuda.synchronize()
        assert torch.isfinite(out.float()).all(), dtype
        _close(out.float().cpu(), want.float().cpu(), DECODE_TOL[dtype])
