"""Recurrent scans of the PyTorch port against the JAX package.

On the CPU: the port's chunked plain versions ("torch") against the Pallas
kernels in interpret mode, and its per-step oracles ("ref") against the JAX
oracles, on the shapes of ``tests/test_kernels_pallas.py`` (ragged S = 33
and S = 17 included), with and without an initial state, and both decode
steps against JAX's. Tolerances are the reference's own: rwkv6 outputs
1e-4 in fp32 and 5e-2 in bf16 (one bf16 ulp of outputs of magnitude ~4),
its state 1e-2 (5e-2 in bf16) with rtol 1e-2; mamba atol 1e-5, rtol 1e-4.
Inputs come from numpy with a seed and go to both frameworks.

On the CPU also: the host-side plans of the kernels (which kernel a dtype
and shape take, the chunk or tile, the v split or lanes per channel).

On the card (marker ``cuda``; skipped without one): the hand-written CUDA
kernels against the plain versions and, for rwkv6, the exact per-step
oracle, at these shapes, at serving shapes (rwkv6-7b heads of 64, jamba's
d_inner 8192 and d_state 16, B 1 and 2), at the edges of the 16-step chunk
and tile (S = 1, 15, 16, 17, 63, 64, 65, 601), at a decay clamped to e^-5
for more than a chunk, at w -> 1, and with mamba dt = 0 runs across a tile
edge. The bf16 rwkv6 kernel runs the chunked form with decays <= 1 on the
tensor cores (bf16 hi + lo operands, fp32 accumulation), the fp32 one and
mamba the exact per-step recurrence; the plain versions run the chunked
cumulative-decay form, whose fp32 exp(+-cumsum) (|cumsum| up to 16 * 5 =
80, fp32 ulp 7.6e-6) leaves ~1e-5 relative error on states of magnitude
~1 summed over 16 to 64 terms. The card tolerance is therefore 1e-3
absolute plus 1e-4 relative in fp32, and one bf16 ulp (5e-2 at |out| ~ 4)
for bf16 outputs.
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels.mamba_scan import kernel as m_kernel
from repro_torch.kernels.mamba_scan import ops as m_ops
from repro_torch.kernels.rwkv6_scan import kernel as r_kernel
from repro_torch.kernels.rwkv6_scan import ops as r_ops

RWKV_SHAPES = [(2, 48, 2, 16), (1, 33, 4, 8), (2, 16, 1, 32)]  # B, S, H, D
MAMBA_SHAPES = [(2, 48, 16, 4), (1, 17, 8, 2)]                 # Bt, S, DI, N
DTYPES = ["float32", "bfloat16"]
RWKV_TOL = {"float32": 1e-4, "bfloat16": 5e-2}
RWKV_STATE_ATOL = {"float32": 1e-2, "bfloat16": 5e-2}
CARD_ATOL, CARD_RTOL = 1e-3, 1e-4       # kernel vs chunked plain, fp32


@pytest.fixture(scope="module")
def jref():
    """The JAX reference scans (skips where JAX is not installed)."""
    pytest.importorskip("jax")
    import jax.numpy as jnp
    from repro.kernels.mamba_scan import ops as jm_ops
    from repro.kernels.mamba_scan.kernel import mamba_scan_pallas
    from repro.kernels.mamba_scan.ref import mamba_scan_ref
    from repro.kernels.rwkv6_scan import ops as jr_ops
    from repro.kernels.rwkv6_scan.kernel import rwkv6_scan_pallas
    from repro.kernels.rwkv6_scan.ref import rwkv6_scan_ref
    return dict(jnp=jnp, rwkv6_scan_pallas=rwkv6_scan_pallas,
                rwkv6_scan_ref=rwkv6_scan_ref,
                rwkv6_decode_step=jr_ops.rwkv6_decode_step,
                mamba_scan_pallas=mamba_scan_pallas,
                mamba_scan_ref=mamba_scan_ref,
                mamba_decode_step=jm_ops.mamba_decode_step)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def rwkv_inputs(shape, with_state, seed=0):
    """r, k, v, w [B,S,H,D], u [H,D], state [B,H,D,D] | None (fp32 numpy),
    distributed as in tests/test_kernels_pallas.py."""
    B, S, H, D = shape
    rng = np.random.default_rng(seed)
    r, k, v = (rng.standard_normal((B, S, H, D)).astype(np.float32) * 0.5
               for _ in range(3))
    w = np.exp(-np.exp(rng.standard_normal((B, S, H, D)) * 0.5)).astype(
        np.float32)
    u = (rng.standard_normal((H, D)) * 0.1).astype(np.float32)
    state = ((rng.standard_normal((B, H, D, D)) * 0.1).astype(np.float32)
             if with_state else None)
    return r, k, v, w, u, state


def mamba_inputs(shape, with_state, seed=0):
    """x, dt [Bt,S,DI], A [DI,N], B, C [Bt,S,N], D [DI], state | None."""
    Bt, S, DI, N = shape
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal((Bt, S, DI)) * 0.5).astype(np.float32)
    dt = np.log1p(np.exp(rng.standard_normal((Bt, S, DI)))).astype(np.float32)
    A = (-np.exp(rng.standard_normal((DI, N)) * 0.3)).astype(np.float32)
    B = (rng.standard_normal((Bt, S, N)) * 0.5).astype(np.float32)
    C = (rng.standard_normal((Bt, S, N)) * 0.5).astype(np.float32)
    D = np.ones((DI,), np.float32)
    state = ((rng.standard_normal((Bt, DI, N)) * 0.5).astype(np.float32)
             if with_state else None)
    return x, dt, A, B, C, D, state


def _t(x, dtype="float32", device="cpu"):
    if x is None:
        return None
    return torch.from_numpy(x).to(device=device, dtype=getattr(torch, dtype))


def _j(jnp, x, dtype="float32"):
    return None if x is None else jnp.asarray(x).astype(getattr(jnp, dtype))


def _close(out, ref, atol, rtol=None):
    np.testing.assert_allclose(np.asarray(out, np.float32),
                               np.asarray(ref, np.float32), atol=atol,
                               rtol=atol if rtol is None else rtol)


def _rwkv_args(inputs, dtype, conv):
    r, k, v, w, u, state = inputs
    return (conv(r, dtype), conv(k, dtype), conv(v, dtype), conv(w, dtype),
            conv(u), conv(state))


# ------------------------------------------------------------ CPU: vs JAX

@pytest.mark.parametrize("with_state", [False, True])
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("shape", RWKV_SHAPES)
def test_rwkv6_torch_vs_pallas_interpret(jref, shape, dtype, with_state):
    jnp = jref["jnp"]
    inputs = rwkv_inputs(shape, with_state)
    o1, s1 = jref["rwkv6_scan_pallas"](
        *_rwkv_args(inputs, dtype, lambda x, dt="float32": _j(jnp, x, dt)),
        chunk=16, interpret=True)
    o2, s2 = r_ops.rwkv6_scan(*_rwkv_args(inputs, dtype, _t), impl="torch")
    assert o2.dtype == getattr(torch, dtype) and s2.dtype == torch.float32
    _close(o2.float(), o1, RWKV_TOL[dtype])
    _close(s2, s1, RWKV_STATE_ATOL[dtype], 1e-2)


@pytest.mark.parametrize("with_state", [False, True])
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("shape", RWKV_SHAPES)
def test_rwkv6_ref_vs_jax_ref(jref, shape, dtype, with_state):
    jnp = jref["jnp"]
    inputs = rwkv_inputs(shape, with_state, seed=1)
    o1, s1 = jref["rwkv6_scan_ref"](
        *_rwkv_args(inputs, dtype, lambda x, dt="float32": _j(jnp, x, dt)))
    o2, s2 = r_ops.rwkv6_scan(*_rwkv_args(inputs, dtype, _t), impl="ref")
    _close(o2.float(), o1, RWKV_TOL[dtype])
    _close(s2, s1, RWKV_STATE_ATOL[dtype], 1e-2)


@pytest.mark.parametrize("dtype", DTYPES)
def test_rwkv6_decode_step_vs_jax(jref, dtype):
    jnp = jref["jnp"]
    r, k, v, w, u, state = rwkv_inputs((3, 1, 4, 16), True, seed=2)
    args = [x[:, 0] for x in (r, k, v, w)]
    o1, s1 = jref["rwkv6_decode_step"](
        *(_j(jnp, x, dtype) for x in args), _j(jnp, u), _j(jnp, state))
    o2, s2 = r_ops.rwkv6_decode_step(*(_t(x, dtype) for x in args), _t(u),
                                     _t(state))
    _close(o2.float(), o1, RWKV_TOL[dtype])
    _close(s2, s1, 1e-5)


@pytest.mark.parametrize("with_state", [False, True])
@pytest.mark.parametrize("shape", MAMBA_SHAPES + [(2, 33, 8, 16)])
def test_mamba_torch_vs_pallas_interpret(jref, shape, with_state):
    jnp = jref["jnp"]
    inputs = mamba_inputs(shape, with_state)
    y1, h1 = jref["mamba_scan_pallas"](*(_j(jnp, x) for x in inputs),
                                       chunk=16, block_d=min(8, shape[2]),
                                       interpret=True)
    y2, h2 = m_ops.mamba_scan(*(_t(x) for x in inputs), impl="torch")
    _close(y2, y1, 1e-5, 1e-4)
    _close(h2, h1, 1e-5, 1e-4)


@pytest.mark.parametrize("with_state", [False, True])
@pytest.mark.parametrize("shape", MAMBA_SHAPES + [(2, 33, 8, 16)])
def test_mamba_ref_vs_jax_ref(jref, shape, with_state):
    jnp = jref["jnp"]
    inputs = mamba_inputs(shape, with_state, seed=1)
    y1, h1 = jref["mamba_scan_ref"](*(_j(jnp, x) for x in inputs))
    y2, h2 = m_ops.mamba_scan(*(_t(x) for x in inputs), impl="ref")
    _close(y2, y1, 1e-5, 1e-4)
    _close(h2, h1, 1e-5, 1e-4)


def test_mamba_decode_step_vs_jax(jref):
    jnp = jref["jnp"]
    x, dt, A, B, C, D, state = mamba_inputs((3, 1, 8, 16), True, seed=2)
    args = (x[:, 0], dt[:, 0], A, B[:, 0], C[:, 0], D, state)
    y1, h1 = jref["mamba_decode_step"](*(_j(jnp, a) for a in args))
    y2, h2 = m_ops.mamba_decode_step(*(_t(a) for a in args))
    _close(y2, y1, 1e-5, 1e-4)
    _close(h2, h1, 1e-5, 1e-4)


# ------------------------------------------------------------ CPU: semantics

def test_mamba_zero_dt_steps_keep_the_state():
    """dt = 0 (the padding of the chunked form): the plain version neither
    decays nor adds there, and the oracle (which clamps dt*A to -1e-8
    without the dt > 0 guard) agrees, since exp(-1e-8) rounds to 1 in fp32
    and dt*B*x is 0."""
    x, dt, A, B, C, D, state = mamba_inputs((2, 20, 8, 16), True, seed=3)
    dt[:, 5:9] = 0.0
    dt[0, 15:] = 0.0
    args = [_t(a) for a in (x, dt, A, B, C, D, state)]
    y1, h1 = m_ops.mamba_scan(*args, impl="torch")
    y2, h2 = m_ops.mamba_scan(*args, impl="ref")
    _close(y1, y2, 1e-5, 1e-4)
    _close(h1, h2, 1e-5, 1e-4)
    # row 0 ends in dt = 0 steps: its state is the state after step 14
    _, h14 = m_ops.mamba_scan(*[a[:, :15] if a.dim() == 3 and a.shape[1] == 20
                                else a for a in args], impl="ref")
    torch.testing.assert_close(h1[0], h14[0], atol=1e-5, rtol=1e-4)


def test_cpu_tensors_take_the_plain_versions():
    rw = [_t(x) for x in rwkv_inputs((1, 20, 2, 16), True)]
    for a, b in zip(r_ops.rwkv6_scan(*rw), r_ops.rwkv6_scan(*rw, impl="torch")):
        assert torch.equal(a, b)
    mb = [_t(x) for x in mamba_inputs((1, 20, 8, 4), True)]
    for a, b in zip(m_ops.mamba_scan(*mb), m_ops.mamba_scan(*mb, impl="torch")):
        assert torch.equal(a, b)


def test_scan_wrappers_refuse_cpu_tensors():
    """The kernel wrappers never fall back: on a CPU tensor they raise
    before any build or launch, and their launch counts stay put."""
    from repro_torch.kernels.mamba_scan import kernel as mk
    from repro_torch.kernels.rwkv6_scan import kernel as rk
    before = (rk.KERNEL.launches, mk.KERNEL.launches)
    rw = [_t(x) for x in rwkv_inputs((1, 20, 2, 16), True)]
    with pytest.raises(ValueError, match="CUDA"):
        r_ops.rwkv6_scan(*rw, impl="cuda")
    mb = [_t(x) for x in mamba_inputs((1, 20, 8, 4), True)]
    with pytest.raises(ValueError, match="CUDA"):
        m_ops.mamba_scan(*mb, impl="cuda")
    with pytest.raises(ValueError, match="unknown"):
        r_ops.rwkv6_scan(*rw, impl="xla")
    with pytest.raises(ValueError, match="unknown"):
        m_ops.mamba_scan(*mb, impl="pallas")
    assert (rk.KERNEL.launches, mk.KERNEL.launches) == before


# ------------------------------------------------------------ CPU: plans

H100_SMS = 132
MAMBA_LANES = {1: 4, 2: 2}      # lanes per channel at jamba's DI 8192, N 16, by Bt


@pytest.mark.parametrize("dtype,B,S,H,D,want", [
    # rwkv6-7b as served (exact-length admission: B 1) and in the smoke (B 2)
    (torch.bfloat16, 1, 601, 64, 64, ("chunked", 16, 2, 32)),
    (torch.bfloat16, 2, 601, 64, 64, ("chunked", 16, 1, 64)),
    (torch.bfloat16, 1, 16, 64, 64, ("chunked", 16, 2, 32)),
    (torch.bfloat16, 1, 1, 4, 16, ("chunked", 16, 1, 16)),       # D 16: one warp
    (torch.bfloat16, 1, 50, 8, 128, ("chunked", 16, 8, 16)),     # 16 columns a warp
    (torch.bfloat16, 1, 50, 2, 32, ("chunked", 16, 2, 16)),
    # fp32, D 8 and S 0 keep the per-step kernel
    (torch.float32, 1, 601, 64, 64, ("per-step", 16, 8, 8)),
    (torch.float32, 2, 601, 64, 64, ("per-step", 16, 4, 16)),
    (torch.bfloat16, 1, 33, 4, 8, ("per-step", 16, 1, 8)),
    (torch.bfloat16, 1, 0, 4, 64, ("per-step", 16, 8, 8)),
])
def test_rwkv6_plan(dtype, B, S, H, D, want):
    p = r_kernel.plan(dtype, B, S, H, D, H100_SMS)
    assert (p["kernel"], p["chunk"], p["vsplit"], p["columns"]) == want
    assert p["columns"] * p["vsplit"] == D


@pytest.mark.parametrize("Bt,S,DI,N,want", [
    # jamba as served (B 1) and in the smoke (B 2)
    (1, 601, 8192, 16, ("tiles", 16, MAMBA_LANES[1], 128 // MAMBA_LANES[1])),
    (2, 601, 8192, 16, ("tiles", 16, MAMBA_LANES[2], 128 // MAMBA_LANES[2])),
    (2, 48, 16, 4, ("tiles", 16, 4, 32)),           # small: the most lanes, at most N
    (1, 20, 64, 32, ("tiles", 16, 4, 32)),
    (1, 17, 8, 2, ("per-step", 16, 2, 128)),        # N 2: 8-byte rows, no TMA map
    (2, 33, 42, 16, ("per-step", 16, 16, 16)),      # DI not a multiple of 4
    (1, 0, 64, 16, ("per-step", 16, 16, 16)),
])
def test_mamba_plan(Bt, S, DI, N, want):
    p = m_kernel.plan(Bt, S, DI, N, H100_SMS)
    assert (p["kernel"], p["tile"], p["lanes"], p["channels"]) == want


# ------------------------------------------------------------ card: kernels

CUDA_RWKV_SHAPES = RWKV_SHAPES + [
    (1, 601, 64, 64),          # rwkv6-7b heads, B = 1: v split over blocks
    (2, 77, 8, 128),           # the largest head size the kernel takes
    (3, 40, 4, 16),            # reduced configs
    (1, 70, 40, 128),          # v split in 2 (a cluster of two blocks)
    (1, 50, 40, 32),           # the same at one warp of v columns a block
]
CUDA_MAMBA_SHAPES = MAMBA_SHAPES + [
    (1, 601, 8192, 16),        # jamba d_inner / d_state, B = 1
    (2, 33, 40, 16),           # d_inner not a multiple of 16 channels
    (1, 20, 64, 32),           # a whole warp of states
]


@pytest.mark.cuda
@pytest.mark.parametrize("with_state", [False, True])
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("shape", CUDA_RWKV_SHAPES)
def test_rwkv6_kernel_vs_plain(cuda, shape, dtype, with_state):
    r, k, v, w, u, state = rwkv_inputs(shape, with_state)
    args = (_t(r, dtype, cuda), _t(k, dtype, cuda), _t(v, dtype, cuda),
            _t(w, "float32", cuda), _t(u, "float32", cuda),
            _t(state, "float32", cuda))
    o1, s1 = r_ops.rwkv6_scan(*args, impl="cuda")
    o2, s2 = r_ops.rwkv6_scan(*args, impl="torch")
    torch.cuda.synchronize()
    assert o1.dtype == getattr(torch, dtype) and o1.shape == r.shape
    tol = CARD_ATOL if dtype == "float32" else 5e-2
    _close(o1.float().cpu(), o2.float().cpu(), tol, CARD_RTOL)
    _close(s1.cpu(), s2.cpu(), CARD_ATOL, CARD_RTOL)


@pytest.mark.cuda
@pytest.mark.parametrize("with_state", [False, True])
@pytest.mark.parametrize("shape", CUDA_MAMBA_SHAPES)
def test_mamba_kernel_vs_plain(cuda, shape, with_state):
    inputs = [_t(x, "float32", cuda) for x in mamba_inputs(shape, with_state)]
    y1, h1 = m_ops.mamba_scan(*inputs, impl="cuda")
    y2, h2 = m_ops.mamba_scan(*inputs, impl="torch")
    torch.cuda.synchronize()
    _close(y1.cpu(), y2.cpu(), CARD_ATOL, CARD_RTOL)
    _close(h1.cpu(), h2.cpu(), CARD_ATOL, CARD_RTOL)


@pytest.mark.cuda
def test_mamba_kernel_zero_dt(cuda):
    """What the kernel does at dt = 0: the state neither decays nor grows
    (the ``dt > 0`` guard of the TPU kernel), as in the plain version."""
    x, dt, A, B, C, D, state = mamba_inputs((2, 40, 48, 16), True, seed=3)
    dt[:, 5:9] = 0.0
    dt[0, 30:] = 0.0
    args = [_t(a, "float32", cuda) for a in (x, dt, A, B, C, D, state)]
    y1, h1 = m_ops.mamba_scan(*args, impl="cuda")
    y2, h2 = m_ops.mamba_scan(*args, impl="torch")
    _, h30 = m_ops.mamba_scan(*[a[:, :30].contiguous() if a.dim() == 3
                                and a.shape[1] == 40 else a for a in args],
                              impl="cuda")
    torch.cuda.synchronize()
    _close(y1.cpu(), y2.cpu(), CARD_ATOL, CARD_RTOL)
    _close(h1.cpu(), h2.cpu(), CARD_ATOL, CARD_RTOL)
    torch.testing.assert_close(h1[0], h30[0], atol=0, rtol=0)


# ------------------------------------------------------------ card: edges

EDGE_S = [1, 15, 16, 17, 63, 64, 65, 601]     # the 16-step chunk and tile


def _rwkv_card(inputs, dtype, cuda):
    r, k, v, w, u, state = inputs
    return (_t(r, dtype, cuda), _t(k, dtype, cuda), _t(v, dtype, cuda),
            _t(w, "float32", cuda), _t(u, "float32", cuda),
            _t(state, "float32", cuda))


def _rwkv_check(args, dtype):
    """The kernel against the chunked plain version and the per-step
    oracle, at the card tolerances. The oracle (like the JAX one) takes w
    as it is, so it gets w clamped to the kernels' band [e^-5, e^-1e-6]."""
    o1, s1 = r_ops.rwkv6_scan(*args, impl="cuda")
    torch.cuda.synchronize()
    assert torch.isfinite(o1.float()).all() and torch.isfinite(s1).all()
    tol = CARD_ATOL if dtype == "float32" else 5e-2
    r, k, v, w, u, state = args
    clamp = float(np.exp(-r_ops.LOG_DECAY_CLAMP)), float(np.exp(-1e-6))
    for impl, ww in (("torch", w), ("ref", w.clamp(*clamp))):
        o2, s2 = r_ops.rwkv6_scan(r, k, v, ww, u, state, impl=impl)
        _close(o1.float().cpu(), o2.float().cpu(), tol, CARD_RTOL)
        _close(s1.cpu(), s2.cpu(), CARD_ATOL, CARD_RTOL)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("B", [1, 2])
@pytest.mark.parametrize("S", EDGE_S)
def test_rwkv6_kernel_chunk_edges(cuda, S, B, dtype):
    """rwkv6-7b's heads: B 1 splits v over a cluster of two blocks, B 2
    does not."""
    inputs = rwkv_inputs((B, S, 64, 64), True, seed=S)
    _rwkv_check(_rwkv_card(inputs, dtype, cuda), dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("case", ["clamp", "one"])
def test_rwkv6_kernel_extreme_decay(cuda, case, dtype):
    """clamp: w = e^-8, clamped to e^-5, for 40 steps (more than two
    chunks), where the TPU form's k / A_j reaches e^80 within a chunk; one:
    w = 1 (clamped to e^-1e-6) everywhere, the longest memory, with r, k, v
    scaled so that |out| stays ~1, where the bf16 tolerance applies."""
    r, k, v, w, u, state = rwkv_inputs((2, 150, 8, 64), True, seed=7)
    if case == "clamp":
        w[:, 20:60] = np.exp(-8.0)
    else:
        w[:] = 1.0
        r, k, v = r * 0.2, k * 0.2, v * 0.2
    _rwkv_check(_rwkv_card((r, k, v, w, u, state), dtype, cuda), dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("B", [1, 2])
@pytest.mark.parametrize("S", EDGE_S)
def test_mamba_kernel_tile_edges(cuda, S, B):
    inputs = [_t(x, "float32", cuda)
              for x in mamba_inputs((B, S, 8192, 16), True, seed=S)]
    y1, h1 = m_ops.mamba_scan(*inputs, impl="cuda")
    y2, h2 = m_ops.mamba_scan(*inputs, impl="torch")
    torch.cuda.synchronize()
    _close(y1.cpu(), y2.cpu(), CARD_ATOL, CARD_RTOL)
    _close(h1.cpu(), h2.cpu(), CARD_ATOL, CARD_RTOL)


@pytest.mark.cuda
@pytest.mark.parametrize("N", [2, 4, 8, 16, 32])
@pytest.mark.parametrize("DI", [40, 42, 200])
def test_mamba_kernel_state_sizes(cuda, DI, N):
    """Every state size, at a d_inner that is not a multiple of the
    channel block (40, 200) or of 4 (42: the per-step kernel); dt = 0
    for steps 10-39, a run across the tile edges at 16 and 32."""
    x, dt, A, B, C, D, state = mamba_inputs((2, 70, DI, N), True, seed=N)
    dt[:, 10:40] = 0.0
    args = [_t(a, "float32", cuda) for a in (x, dt, A, B, C, D, state)]
    y1, h1 = m_ops.mamba_scan(*args, impl="cuda")
    y2, h2 = m_ops.mamba_scan(*args, impl="torch")
    torch.cuda.synchronize()
    _close(y1.cpu(), y2.cpu(), CARD_ATOL, CARD_RTOL)
    _close(h1.cpu(), h2.cpu(), CARD_ATOL, CARD_RTOL)


@pytest.mark.cuda
def test_scan_plans_match_the_library(cuda):
    """The kernel each plan names is the one the C library launches."""
    for dtype in (torch.float32, torch.bfloat16):
        for D in r_kernel.HEAD_DIMS:
            for S in (0, 1, 601):
                r = torch.empty((1, S, 2, D), dtype=dtype, device=cuda)
                chunked = r_kernel.plan(dtype, 1, S, 2, D, H100_SMS)["kernel"] == "chunked"
                assert r_kernel.variant(r).startswith("chunked") == chunked
    for N in m_kernel.STATE_SIZES:
        for DI, S in ((64, 20), (42, 20), (64, 0)):
            x = torch.empty((1, S, DI), device=cuda)
            tiles = m_kernel.plan(1, S, DI, N, H100_SMS)["kernel"] == "tiles"
            assert m_kernel.variant(x, N).startswith("TMA") == tiles
