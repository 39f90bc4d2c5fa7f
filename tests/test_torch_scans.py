"""Recurrent scans of the PyTorch port against the JAX package.

On the CPU: the port's chunked plain versions ("torch") against the Pallas
kernels in interpret mode, and its per-step oracles ("ref") against the JAX
oracles, on the shapes of ``tests/test_kernels_pallas.py`` (ragged S = 33
and S = 17 included), with and without an initial state, and both decode
steps against JAX's. Tolerances are the reference's own: rwkv6 outputs
1e-4 in fp32 and 5e-2 in bf16 (one bf16 ulp of outputs of magnitude ~4),
its state 1e-2 (5e-2 in bf16) with rtol 1e-2; mamba atol 1e-5, rtol 1e-4.
Inputs come from numpy with a seed and go to both frameworks.

On the card (marker ``cuda``; skipped without one): the hand-written CUDA
kernels against the plain versions, at these shapes and at serving shapes
(rwkv6-7b heads of 64, jamba's d_inner 8192 and d_state 16). The kernels
run the exact per-step recurrence and the plain versions the chunked
cumulative-decay form; their fp32 difference comes from the chunked form's
exp(+-cumsum): |cumsum| reaches 16 * 5 = 80, whose fp32 ulp is 7.6e-6, so
a decay product exp(cs_t - cs_j) carries ~1e-5 relative error on states of
magnitude ~1 summed over 16 to 64 terms. The card tolerance is therefore
1e-3 absolute plus 1e-4 relative in fp32, and one bf16 ulp (5e-2 at
|out| ~ 4) for bf16 outputs.
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels.mamba_scan import ops as m_ops
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


# ------------------------------------------------------------ card: kernels

CUDA_RWKV_SHAPES = RWKV_SHAPES + [
    (1, 601, 64, 64),          # rwkv6-7b heads, B = 1: v split over blocks
    (2, 77, 8, 128),           # the largest head size the kernel takes
    (3, 40, 4, 16),            # reduced configs
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
