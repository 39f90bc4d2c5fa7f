"""Attention kernels of the PyTorch port against the JAX package.

On the CPU: the port's plain versions ("torch") and oracles ("ref") against
the Pallas kernels in interpret mode and the JAX oracles, on the shapes of
``tests/test_kernels.py``, with its tolerances (fp32 2e-5; bf16 2e-2 for
prefill and 3e-2 for decode: one bf16 ulp at |x| ~ 2-4, plus p rounded to
bf16 before the PV product at different running maxima).

On the card (marker ``cuda``; skipped without one): the hand-written CUDA
kernels against the plain versions on the same shapes plus the serving
shapes (qwen2-7b: G = 28/4 = 7; gemma2: D 256; reduced: D 16) and the
edges of the bf16 kernel's tiles; the attention backward
(``flash_attention_bwd``) against ``_mha_bwd_torch`` on the same inputs,
at the training shapes too, with the tolerances of the attention VJP
(``tests/test_torch_train.py:VJP_TOL``). The fp32 cases hold the fp32
path to 2e-5, which TF32 products would miss. These need no JAX, so the
file runs on a machine without it.
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


def test_flash_attention_bwd_refuses_before_any_launch():
    """The backward's wrapper checks dtypes and shapes before the device,
    so each refusal shows on the CPU: mixed dtypes, a head dim outside
    ``HEAD_DIMS``, then CPU tensors; nothing is built or launched."""
    from repro_torch.kernels.flash_attention import kernel as fa
    B, S, H, KV, D = 1, 8, 4, 2, 16

    def args(dtype=torch.float32, d=D, **change):
        t = dict(q=torch.zeros(B, S, H, d, dtype=dtype),
                 k=torch.zeros(B, S, KV, d, dtype=dtype),
                 v=torch.zeros(B, S, KV, d, dtype=dtype),
                 out=torch.zeros(B, S, H, d, dtype=dtype),
                 lse=torch.zeros(B, S, H),
                 dout=torch.zeros(B, S, H, d, dtype=dtype))
        t.update(change)
        return t
    built, before = fa.BWD_KERNEL._fn, fa.BWD_KERNEL.launches
    with pytest.raises(TypeError, match="float32 or all bfloat16"):
        fa.flash_attention_bwd(**args(dout=torch.zeros(B, S, H, D,
                                                       dtype=torch.bfloat16)))
    with pytest.raises(TypeError, match="float32 or all bfloat16"):
        fa.flash_attention_bwd(**args(torch.float16))
    with pytest.raises(TypeError, match="lse must be float32"):
        fa.flash_attention_bwd(**args(lse=torch.zeros(B, S, H,
                                                      dtype=torch.bfloat16)))
    with pytest.raises(ValueError, match="head dim 48"):
        fa.flash_attention_bwd(**args(d=48))
    with pytest.raises(ValueError, match="must match q"):
        fa.flash_attention_bwd(**args(out=torch.zeros(B, S + 1, H, D)))
    with pytest.raises(ValueError, match="CUDA tensors only"):
        fa.flash_attention_bwd(**args())
    with pytest.raises(ValueError, match="CUDA tensors only"):
        fa.flash_attention_bwd(**args(torch.bfloat16))
    assert fa.BWD_KERNEL._fn is built and fa.BWD_KERNEL.launches == before


def test_mha_function_routes_its_backward_by_impl(monkeypatch):
    """``MhaFunction``'s backward is its forward's impl's: "torch" runs
    ``_mha_bwd_torch`` and never the kernel; "cuda" (the kernels replaced by
    CPU stand-ins that call the plain versions) calls
    ``flash_attention_bwd`` once, with the forward's lse, a contiguous dout
    and the attention's keyword arguments, and never ``_mha_bwd_torch``."""
    from repro_torch.kernels.flash_attention import kernel as fa
    case = (2, 40, 100, 4, 2, 16, True, 16, 30.0)
    B, S, T, H, KV, D, causal, window, softcap = case
    q, k, v = (torch.from_numpy(x) for x in _attn_inputs(case))
    kw = dict(causal=causal, window=window, softcap=softcap, q_offset=T - S,
              q_chunk=16, kv_chunk=32)
    plain_bwd = t_ops._mha_bwd_torch
    calls = {"torch": 0, "kernel": []}

    def counting_bwd(*a, **k):
        calls["torch"] += 1
        return plain_bwd(*a, **k)

    def fake_fwd(q, k, v, return_lse=False, **fkw):   # lse as the kernel's [B, S, H]
        out, lse = t_ops._mha_torch(q, k, v, q_chunk=16, kv_chunk=32, **fkw)
        return (out, lse.view(q.shape[:3])) if return_lse else out

    def fake_bwd(q, k, v, out, lse, dout, **bkw):
        calls["kernel"].append((dout.is_contiguous(), tuple(lse.shape), bkw))
        return plain_bwd(q, k, v, out, lse.view(B, S, KV, H // KV), dout,
                         q_chunk=16, kv_chunk=32, **bkw)

    monkeypatch.setattr(t_ops, "_mha_bwd_torch", counting_bwd)
    monkeypatch.setattr(fa, "flash_attention", fake_fwd)
    monkeypatch.setattr(fa, "flash_attention_bwd", fake_bwd)
    grads = {}
    for impl in ("torch", "cuda"):
        leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
        out = t_ops.mha(*leaves, impl=impl, **kw)
        # a dout laid out [B, H, S, D]: autograd hands it on as it is
        dout = torch.ones(B, H, S, D).transpose(1, 2)
        out.backward(dout)
        grads[impl] = [t.grad for t in leaves]
        assert calls["torch"] == 1
    assert calls["kernel"] == [(True, (B, S, KV, H // KV),
                                dict(causal=causal, window=window,
                                     softcap=softcap, scale=None,
                                     q_offset=T - S))]
    for a, b in zip(grads["torch"], grads["cuda"]):
        torch.testing.assert_close(a, b, atol=2e-5, rtol=2e-5)


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


# ------------------------------------------------------------ card: backward

CUDA_BWD_CASES = ATTN_CASES + [
    # B, S, T, H, KV, D, causal, window, softcap
    (1, 4096, 4096, 16, 8, 128, True, 0, 0.0),    # internvl2-2b's train_4k heads
    (1, 1023, 1023, 28, 4, 128, True, 0, 0.0),    # qwen2-7b's G = 7, ragged last tiles
    (1, 300, 300, 16, 8, 256, True, 100, 50.0),   # gemma2-9b's D 256, window, softcap
    (2, 200, 450, 16, 16, 64, False, 0, 0.0),     # seamless's cross-attention, S < T
    (2, 130, 130, 4, 2, 16, True, 0, 0.0),        # D 16
    (2, 130, 70, 4, 1, 32, False, 0, 0.0),        # D 32, S > T
    (2, 0, 64, 4, 2, 64, True, 0, 0.0),           # S 0: dk and dv are 0
    (2, 64, 0, 4, 2, 64, False, 0, 0.0),          # T 0: dq is 0
]


def _bwd_inputs(case, dtype, device, seed=0):
    """(q, k, v, out, lse [B, S, H], dout): the kernel's forward and its
    lse on seeded inputs."""
    from repro_torch.kernels.flash_attention.kernel import flash_attention
    B, S, T, H, KV, D, causal, window, softcap = case
    g = torch.Generator(device=device).manual_seed(seed)
    td = getattr(torch, dtype)
    q, dout = (torch.randn((B, S, H, D), generator=g, device=device).to(td)
               for _ in range(2))
    k, v = (torch.randn((B, T, KV, D), generator=g, device=device).to(td)
            for _ in range(2))
    out, lse = flash_attention(q, k, v, return_lse=True, **_bwd_kw(case))
    return q, k, v, out, lse, dout


def _bwd_kw(case):
    B, S, T, H, KV, D, causal, window, softcap = case
    return dict(causal=causal, window=window, softcap=softcap,
                q_offset=T - S if causal else 0)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("case", CUDA_BWD_CASES)
def test_flash_attention_bwd_vs_plain(cuda, case, dtype):
    """dq, dk, dv of the kernel against ``_mha_bwd_torch`` on the same (q,
    k, v, out, lse, dout), at the attention VJP's tolerances (bf16 2e-2,
    fp32 2e-5); each in its input's dtype."""
    from repro_torch.kernels.flash_attention.kernel import flash_attention_bwd
    B, S, T, H, KV, D = case[:6]
    q, k, v, out, lse, dout = _bwd_inputs(case, dtype, cuda)
    got = flash_attention_bwd(q, k, v, out, lse, dout, **_bwd_kw(case))
    want = t_ops._mha_bwd_torch(q, k, v, out, lse.view(B, S, KV, H // KV),
                                dout, scale=None, q_chunk=1024,
                                kv_chunk=1024, **_bwd_kw(case))
    torch.cuda.synchronize()
    tol = 2e-2 if dtype == "bfloat16" else 2e-5
    for g, w, ref in zip(got, want, (q, k, v)):
        assert g.dtype == ref.dtype and g.shape == ref.shape
        _close(g.float().cpu(), w.float().cpu(), tol)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
def test_flash_attention_bwd_is_deterministic(cuda, dtype):
    """Two launches on the same inputs give the same bits: the GQA sum over
    a group's heads stays in one block, and no gradient is summed by
    atomics."""
    from repro_torch.kernels.flash_attention.kernel import flash_attention_bwd
    case = (2, 1023, 1023, 28, 4, 128, True, 0, 0.0)
    args = _bwd_inputs(case, dtype, cuda)
    first = flash_attention_bwd(*args, **_bwd_kw(case))
    second = flash_attention_bwd(*args, **_bwd_kw(case))
    torch.cuda.synchronize()
    for a, b in zip(first, second):
        assert torch.equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
def test_mha_backward_takes_a_non_contiguous_dout(cuda, dtype):
    """``mha(...).backward`` with a gradient laid out [B, H, S, D]: the
    kernel's gradients match the plain route's, and the kernel ran."""
    from repro_torch.kernels.flash_attention import kernel as fa
    case = (2, 300, 300, 8, 2, 64, True, 0, 0.0)
    B, S, T, H, KV, D = case[:6]
    q, k, v, _, _, _ = _bwd_inputs(case, dtype, cuda)
    dout = torch.randn((B, H, S, D), device=cuda).to(q.dtype).transpose(1, 2)
    assert not dout.is_contiguous()
    grads = {}
    for impl in ("cuda", "torch"):
        leaves = [t.detach().clone().requires_grad_(True) for t in (q, k, v)]
        before = fa.BWD_KERNEL.launches
        t_ops.mha(*leaves, impl=impl, **_bwd_kw(case)).backward(dout)
        assert fa.BWD_KERNEL.launches - before == (impl == "cuda")
        grads[impl] = [t.grad.float().cpu() for t in leaves]
    tol = 2e-2 if dtype == "bfloat16" else 2e-5
    for a, b in zip(grads["cuda"], grads["torch"]):
        _close(a, b, tol)


@pytest.mark.cuda
def test_train_step_runs_the_backward_kernel(cuda, monkeypatch):
    """One step of a reduced internvl2-2b (2 layers, 2 microbatches, its
    ``vit_stub`` patches, GQA at D 128) on the card: every attention call
    whose backward runs launches the kernel once, and ``_mha_bwd_torch``
    is never entered."""
    from repro_torch.configs import get_config
    from repro_torch.kernels.flash_attention import kernel as fa
    from repro_torch.models import init_params
    from repro_torch.models.config import reduced
    from repro_torch.training import (OptimizerConfig, make_opt_state,
                                      make_train_step)

    def refuse(*a, **k):
        raise AssertionError("_mha_bwd_torch ran on the card")
    monkeypatch.setattr(t_ops, "_mha_bwd_torch", refuse)
    calls = []
    kernel_bwd = fa.flash_attention_bwd

    def counting(*a, **k):
        calls.append(a[0].shape)
        return kernel_bwd(*a, **k)
    monkeypatch.setattr(fa, "flash_attention_bwd", counting)
    cfg = reduced(get_config("internvl2-2b"), n_layers=2, d_model=256,
                  n_heads=4, n_kv_heads=2, head_dim=128)
    params = init_params(cfg, generator=torch.Generator(device=cuda).manual_seed(0),
                         device=cuda, dtype=torch.float32)
    step = make_train_step(cfg, OptimizerConfig(), microbatches=2)
    g = torch.Generator(device=cuda).manual_seed(1)
    batch = {"tokens": torch.randint(0, cfg.vocab, (4, 64), generator=g,
                                     device=cuda, dtype=torch.int32),
             "patches": torch.randn((4, cfg.frontend_tokens, cfg.frontend_dim),
                                    generator=g, device=cuda)}
    before = fa.BWD_KERNEL.launches
    params, _, metrics = step(params, make_opt_state(params), batch)
    torch.cuda.synchronize()
    assert torch.isfinite(torch.as_tensor(float(metrics["loss"])))
    assert len(calls) == cfg.n_layers * 2
    assert all(s == (2, 64, 4, 128) for s in calls)
    assert fa.BWD_KERNEL.launches - before == len(calls)
