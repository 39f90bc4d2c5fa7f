"""The recurrent scans' training form (``Rwkv6ScanFunction``,
``MambaScanFunction``) against the JAX package.

On the CPU, inputs drawn with a seed by numpy (distributed as in
``tests/test_kernels_pallas.py``) go to both frameworks. Each Function's
gradients, of a loss on its output and, where asked, on its final state,
are held to two oracles: ``jax.vjp`` of the reference's ``rwkv6_scan`` /
``mamba_scan`` with ``impl="xla"`` (the chunked form in groups under
``jax.checkpoint``, what the reference trains through off the TPU) and
with ``impl="ref"`` (the exact per-step recurrence; rwkv6's takes w
unclamped, so against it w stays inside the clamp's band); and to plain
autograd through the port's chunked forms ``_rwkv6_torch`` /
``_mamba_torch``. S is
16 (one chunk), 17 (a ragged second chunk) and 512 (two groups of 16
chunks), with and without an initial state; r/k/v (and u) in fp32 and
bf16; A and D in fp32 and bf16, as the train step hands them over.

Tolerances are the reference's scan tests' (``tests/test_kernels_pallas.py``
:32-37, 55-58): rwkv6 1e-4 in fp32 and 5e-2 in bf16 (atol and rtol), mamba
atol 1e-5 and rtol 1e-4. A gradient sums over up to 512 steps, so its atol
is taken relative to the leaf's largest magnitude; against the port's own
plain autograd, where the arithmetic is the same and only du, dA and dD
sum their groups in another order, 1e-6.

On the card (marker ``cuda``; skipped without one): each Function through
the kernel against through "torch" on the card at S 601 and 4096 with a
state, and the kernel's grouped forward against one launch.
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels import scan_groups
from repro_torch.kernels.mamba_scan import ops as m_ops
from repro_torch.kernels.rwkv6_scan import ops as r_ops

RWKV_TOL = {"float32": 1e-4, "bfloat16": 5e-2}
MAMBA_ATOL, MAMBA_RTOL = 1e-5, 1e-4
SEQS = [16, 17, 512]
STATES = [(False, False), (True, True), (True, False), (False, True)]
# (initial state given, loss on the final state); all four at S 17


@pytest.fixture(scope="module")
def jref():
    """The JAX reference scans (skips where JAX is not installed)."""
    jax = pytest.importorskip("jax")
    import jax.numpy as jnp
    from repro.kernels.mamba_scan.ops import mamba_scan
    from repro.kernels.rwkv6_scan.ops import rwkv6_scan
    return dict(jax=jax, jnp=jnp, rwkv6=rwkv6_scan, mamba=mamba_scan)


def _cases():
    for S in SEQS:
        for given, final in STATES if S == 17 else STATES[:2]:
            yield S, given, final


def rwkv_inputs(B, S, H, D, seed=0):
    rng = np.random.default_rng(seed)
    r, k, v = (rng.standard_normal((B, S, H, D)).astype(np.float32) * 0.5
               for _ in range(3))
    w = np.exp(-np.exp(rng.standard_normal((B, S, H, D)) * 0.5)).astype(
        np.float32)
    u = (rng.standard_normal((H, D)) * 0.1).astype(np.float32)
    state = (rng.standard_normal((B, H, D, D)) * 0.1).astype(np.float32)
    dout = rng.standard_normal((B, S, H, D)).astype(np.float32)
    dstate = rng.standard_normal((B, H, D, D)).astype(np.float32)
    return [r, k, v, w, u, state], dout, dstate


def mamba_inputs(Bt, S, DI, N, seed=0):
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal((Bt, S, DI)) * 0.5).astype(np.float32)
    dt = np.log1p(np.exp(rng.standard_normal((Bt, S, DI)))).astype(np.float32)
    A = (-np.exp(rng.standard_normal((DI, N)) * 0.3)).astype(np.float32)
    B = (rng.standard_normal((Bt, S, N)) * 0.5).astype(np.float32)
    C = (rng.standard_normal((Bt, S, N)) * 0.5).astype(np.float32)
    D = (1.0 + 0.1 * rng.standard_normal((DI,))).astype(np.float32)
    state = (rng.standard_normal((Bt, DI, N)) * 0.5).astype(np.float32)
    dy = rng.standard_normal((Bt, S, DI)).astype(np.float32)
    dstate = rng.standard_normal((Bt, DI, N)).astype(np.float32)
    return [x, dt, A, B, C, D, state], dy, dstate


def _torch_grads(fn, arrays, dtypes, dout, dstate, given, final,
                 device="cpu"):
    """(out, final state, gradients of every input that is given) of
    ``fn(*tensors)`` for the loss <out, dout> (+ <state, dstate>)."""
    ts = [torch.from_numpy(a).to(device=device, dtype=getattr(torch, d))
          .requires_grad_(True) for a, d in zip(arrays, dtypes)]
    if not given:
        ts[-1] = None
    out, s = fn(*ts)
    outs, cots = [out], [torch.from_numpy(dout).to(device, out.dtype)]
    if final:
        outs.append(s)
        cots.append(torch.from_numpy(dstate).to(device))
    leaves = [t for t in ts if t is not None]
    grads = torch.autograd.grad(outs, leaves, cots)
    for t, g in zip(leaves, grads):
        assert g.dtype == t.dtype and g.shape == t.shape
    return out.detach(), s.detach(), grads


def _jax_grads(jref, scan, arrays, dtypes, dout, dstate, given, impl):
    jax, jnp = jref["jax"], jref["jnp"]
    xs = [jnp.asarray(a).astype(getattr(jnp, d))
          for a, d in zip(arrays, dtypes)]
    if not given:
        xs = xs[:-1]

    def f(*xs):
        args = list(xs) + ([] if given else [None])
        return scan(*args, impl=impl)

    (out, s), vjp = jax.vjp(f, *xs)
    return vjp((jnp.asarray(dout).astype(out.dtype), jnp.asarray(dstate)))


def _close_grads(got, want, names, atol, rtol, what):
    for name, g, w in zip(names, got, want):
        w = (w.float().cpu().numpy() if torch.is_tensor(w)
             else np.asarray(w, np.float32))
        scale = max(float(np.abs(w).max()), 1e-30)
        np.testing.assert_allclose(g.float().numpy(), w, atol=atol * scale,
                                   rtol=rtol, err_msg=f"{what} d{name}")


RWKV_NAMES = ("r", "k", "v", "w", "u", "state")
MAMBA_NAMES = ("x", "dt", "A", "B", "C", "D", "state")


@pytest.mark.parametrize("oracle", ["xla", "ref"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("S,given,final", list(_cases()))
def test_rwkv6_function_matches_jax_grads(jref, S, given, final, dtype,
                                          oracle):
    """dr, dk, dv, dw, du (and the initial state's) of the Function ("torch")
    against ``jax.vjp`` of the reference's ``oracle`` scan and against
    plain autograd through ``_rwkv6_torch``; bf16 r/k/v/u come back bf16.
    B 2, H 2, D 16; a loss on the final state when ``final``. Against "xla"
    the decays are the reference tests' own, so the log-decay clamp at -5
    binds for a few of them (at S 512 surely): there dw is 0 in both. The
    exact recurrence ("ref") takes w unclamped (``rwkv6_scan/ref.py``; up to
    0.2 of dw's scale apart from "xla" at S 512), so against it w is kept
    inside the clamp's band, where the two forms agree to ~1e-5."""
    arrays, dout, dstate = rwkv_inputs(2, S, 2, 16)
    if oracle == "ref":
        arrays[3] = np.clip(arrays[3], np.exp(-4.9), 1.0).astype(np.float32)
    elif S == 512:
        assert (arrays[3] < np.exp(-r_ops.LOG_DECAY_CLAMP)).any()
    dtypes = [dtype] * 3 + ["float32", dtype, "float32"]
    _, _, got = _torch_grads(
        lambda *t: r_ops.rwkv6_scan(*t, impl="torch"), arrays, dtypes, dout,
        dstate, given, final)
    names = RWKV_NAMES if given else RWKV_NAMES[:-1]
    tol = RWKV_TOL[dtype]
    want = _jax_grads(jref, jref["rwkv6"], arrays, dtypes, dout,
                      dstate if final else np.zeros_like(dstate), given,
                      oracle)
    _close_grads(got, want, names, tol, tol, oracle)
    _, _, plain = _torch_grads(
        lambda *t: r_ops._rwkv6_torch(*t, chunk=16), arrays, dtypes, dout,
        dstate, given, final)
    _close_grads(got, plain, names, 1e-6, 1e-6, "plain autograd")


@pytest.mark.parametrize("oracle", ["xla", "ref"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("S,given,final", list(_cases()))
def test_mamba_function_matches_jax_grads(jref, S, given, final, dtype,
                                          oracle):
    """dx, ddt, dA, dB, dC, dD (and the initial state's) of the Function
    ("torch") against ``jax.vjp`` of the reference's ``oracle`` scan and
    plain autograd through ``_mamba_torch``; ``dtype`` is A's and D's (the
    train step's bf16 copies), and their gradients come back in it. Bt 2,
    DI 8, N 4; a loss on the final state when ``final``."""
    arrays, dy, dstate = mamba_inputs(2, S, 8, 4)
    dtypes = ["float32"] * 2 + [dtype] + ["float32"] * 2 + [dtype, "float32"]
    _, _, got = _torch_grads(
        lambda *t: m_ops.mamba_scan(*t, impl="torch"), arrays, dtypes, dy,
        dstate, given, final)
    names = MAMBA_NAMES if given else MAMBA_NAMES[:-1]
    want = _jax_grads(jref, jref["mamba"], arrays, dtypes, dy,
                      dstate if final else np.zeros_like(dstate), given,
                      oracle)
    _close_grads(got, want, names, MAMBA_ATOL, MAMBA_RTOL, oracle)
    _, _, plain = _torch_grads(
        lambda *t: m_ops._mamba_torch(*t, chunk=16), arrays, dtypes, dy,
        dstate, given, final)
    _close_grads(got, plain, names, 1e-6, 1e-6, "plain autograd")


@pytest.mark.parametrize("S,want", [
    (5, [(0, 5)]), (16, [(0, 16)]), (17, [(0, 17)]),
    (33, [(0, 16), (16, 32), (32, 33)]), (512, [(0, 256), (256, 512)]),
    (601, [(a, min(a + 32, 601)) for a in range(0, 601, 32)]),
    (4096, [(a, a + 256) for a in range(0, 4096, 256)])])
def test_group_bounds_follow_the_reference(S, want):
    """16 chunks of 16 steps a group, halved until the group divides the
    chunk count (``repro/kernels/rwkv6_scan/ops.py:92-95``); the short
    sequence is one chunk of its own length."""
    assert scan_groups.group_bounds(S, min(16, S)) == want


@pytest.mark.parametrize("scan", ["rwkv6", "mamba"])
def test_grouped_forward_is_the_one_pass_forward(scan):
    """The Function's forward, two groups of 16 chunks at S 512 from an
    initial state, gives the one-pass chunked form's out and final state
    bit for bit: its groups end on chunk boundaries."""
    if scan == "rwkv6":
        arrays, _, _ = rwkv_inputs(2, 512, 2, 16, seed=3)
        fn, plain = r_ops.rwkv6_scan, r_ops._rwkv6_torch
    else:
        arrays, _, _ = mamba_inputs(2, 512, 8, 4, seed=3)
        fn, plain = m_ops.mamba_scan, m_ops._mamba_torch
    ts = [torch.from_numpy(a) for a in arrays]
    out, s = fn(*[t.clone().requires_grad_(True) for t in ts], impl="torch")
    assert "ScanFunction" in type(out.grad_fn).__name__
    want_out, want_s = plain(*ts, chunk=16)
    assert torch.equal(out.detach(), want_out)
    assert torch.equal(s.detach(), want_s)


def test_scans_without_grad_take_no_function():
    """Grad mode off, or no input that needs a gradient: the plain call, as
    before (serving never builds a graph)."""
    arrays, _, _ = rwkv_inputs(1, 20, 2, 16)
    ts = [torch.from_numpy(a).requires_grad_(True) for a in arrays]
    with torch.no_grad():
        out, _ = r_ops.rwkv6_scan(*ts)
    assert out.grad_fn is None
    out, _ = m_ops.mamba_scan(*[torch.from_numpy(a) for a in
                                mamba_inputs(1, 20, 8, 4)[0]])
    assert out.grad_fn is None


# ------------------------------------------------------------ on the card

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


CARD_SEQS = [601, 4096]


@pytest.mark.cuda
@pytest.mark.parametrize("S", CARD_SEQS)
def test_rwkv6_function_through_the_kernel(cuda, S):
    """bf16 r/k/v/u (the train step's), an initial state and a loss on the
    final state, B 2, H 4, D 64: out, state and every gradient through the
    kernel's forward against through the plain forward on the card. The
    backward is the same PyTorch on both; the forwards differ by the
    kernel's tolerance (``tests/test_torch_scans.py``: one bf16 ulp of the
    output, 1e-3 on the fp32 state), which moves a bf16 gradient by an ulp
    or two: 2e-2 of each leaf's largest magnitude."""
    arrays, dout, dstate = rwkv_inputs(2, S, 4, 64, seed=5)
    dtypes = ["bfloat16"] * 3 + ["float32", "bfloat16", "float32"]
    got = {impl: _torch_grads(
        lambda *t: r_ops.rwkv6_scan(*t, impl=impl), arrays, dtypes, dout,
        dstate, True, True, device=cuda) for impl in ("cuda", "torch")}
    torch.cuda.synchronize()
    (o1, s1, g1), (o2, s2, g2) = got["cuda"], got["torch"]
    np.testing.assert_allclose(o1.float().cpu(), o2.float().cpu(),
                               atol=5e-2, rtol=5e-2)
    np.testing.assert_allclose(s1.cpu(), s2.cpu(), atol=1e-3, rtol=1e-4)
    _close_grads([g.cpu() for g in g1], g2, RWKV_NAMES, 2e-2, 2e-2,
                 "cuda vs torch")


@pytest.mark.cuda
@pytest.mark.parametrize("S", CARD_SEQS)
def test_mamba_function_through_the_kernel(cuda, S):
    """fp32 x/dt/B/C, bf16 A and D (the train step's), an initial state and
    a loss on the final state, Bt 2, DI 256, N 16: y, state and every
    gradient through the kernel's forward against through the plain
    forward on the card (the kernel's tolerance, 1e-3 absolute and 1e-4
    relative, on y and the state; the gradients then to 1e-3 of each
    leaf's largest magnitude)."""
    arrays, dy, dstate = mamba_inputs(2, S, 256, 16, seed=5)
    dtypes = ["float32"] * 2 + ["bfloat16"] + ["float32"] * 2 + [
        "bfloat16", "float32"]
    got = {impl: _torch_grads(
        lambda *t: m_ops.mamba_scan(*t, impl=impl), arrays, dtypes, dy,
        dstate, True, True, device=cuda) for impl in ("cuda", "torch")}
    torch.cuda.synchronize()
    (y1, h1, g1), (y2, h2, g2) = got["cuda"], got["torch"]
    np.testing.assert_allclose(y1.cpu(), y2.cpu(), atol=1e-3, rtol=1e-4)
    np.testing.assert_allclose(h1.cpu(), h2.cpu(), atol=1e-3, rtol=1e-4)
    _close_grads([g.cpu() for g in g1], g2, MAMBA_NAMES, 1e-3, 1e-3,
                 "cuda vs torch")


@pytest.mark.cuda
@pytest.mark.parametrize("scan", ["rwkv6", "mamba"])
@pytest.mark.parametrize("S", CARD_SEQS)
def test_grouped_kernel_forward_is_one_launch(cuda, scan, S):
    """The Function's forward through the kernel, one launch a group (19
    at S 601, 16 at S 4096), gives one launch's out and final state bit
    for bit: each group starts from the state the previous one ended in,
    on a chunk boundary."""
    from repro_torch.kernels.mamba_scan import kernel as m_kernel
    from repro_torch.kernels.rwkv6_scan import kernel as r_kernel
    if scan == "rwkv6":
        arrays, _, _ = rwkv_inputs(2, S, 4, 64, seed=6)
        dtypes = ["bfloat16"] * 3 + ["float32"] * 3
        fn, kernel = r_ops.rwkv6_scan, r_kernel.KERNEL
    else:
        arrays, _, _ = mamba_inputs(2, S, 256, 16, seed=6)
        dtypes = ["float32"] * 7
        fn, kernel = m_ops.mamba_scan, m_kernel.KERNEL
    ts = [torch.from_numpy(a).to(cuda, getattr(torch, d))
          for a, d in zip(arrays, dtypes)]
    kernel.launches = 0
    out, s = fn(*ts, impl="cuda")
    assert kernel.launches == 1
    grouped, gs = fn(*[t.clone().requires_grad_(True) for t in ts],
                     impl="cuda")
    torch.cuda.synchronize()
    assert kernel.launches == 1 + len(scan_groups.group_bounds(S, 16))
    assert torch.equal(grouped.detach(), out)
    assert torch.equal(gs.detach(), s)
