"""Ragged grouped GEMM of the PyTorch port against the JAX package.

On the CPU: the port's plain version ("torch") and oracle ("ref") against
the reference's three paths, ``grouped_gemm(..., block_m=16)`` (the Pallas
kernel in interpret mode, as ``tests/test_kernels_pallas.py`` runs it),
``impl="xla"`` (``jax.lax.ragged_dot``) and ``grouped_gemm_ref``, on the
shapes of ``tests/test_kernels_pallas.py`` (D 32, F 48) with empty groups,
a single group and all groups but one empty. Tolerances are the
reference's own: 1e-5 in fp32 and 3e-2 in bf16 (one bf16 rounding of
outputs of magnitude ~1), atol and rtol alike. Inputs come from numpy with
a seed and go to both frameworks.

Rows past ``sum(group_sizes)`` are zero in the port, as in ``ragged_dot``
and the reference oracle; the reference's Pallas path leaves them
unwritten, so that case is held against "xla" and "ref" only.

On the card (marker ``cuda``; skipped without one): the hand-written CUDA
kernels against the plain version over the same sweep, with D and F off
the tile (TMA-mappable widths take the wgmma kernel, the others the
mma.sync kernel), the edges of the wgmma kernel's 128- and 64-row tiles,
the tail, int64 sizes, more groups than one scan block and the
olmoe-1b-7b expert width. Both accumulate in fp32 in another order: fp32
within 1e-5 at these depths, bf16 within one output rounding (3e-2).
"""
import numpy as np
import pytest
import torch

from repro_torch.configs import get_config, reduced
from repro_torch.kernels.grouped_gemm import ops

SIZES = [[40, 0, 26, 30], [16, 16, 16, 16], [1, 2, 3, 90], [96],
         [0, 0, 77, 0]]
DTYPES = ["float32", "bfloat16"]
TOL = {"float32": 1e-5, "bfloat16": 3e-2}
D, F = 32, 48


@pytest.fixture(scope="module")
def jref():
    """The reference's grouped GEMM paths (skips where JAX is not
    installed), each returning fp32 numpy; results are cached per case."""
    pytest.importorskip("jax")
    import jax.numpy as jnp
    from repro.kernels.grouped_gemm.ops import grouped_gemm
    from repro.kernels.grouped_gemm.ref import grouped_gemm_ref
    paths = {
        "pallas": lambda x, s, w: grouped_gemm(x, s, w, block_m=16),
        "xla": lambda x, s, w: grouped_gemm(x, s, w, impl="xla"),
        "ref": grouped_gemm_ref,
    }
    cache = {}

    def run(path, sizes, dtype, T=None):
        key = (path, tuple(sizes), dtype, T)
        if key not in cache:
            x, s, w = inputs(sizes, T=T)
            jt = getattr(jnp, dtype)
            out = paths[path](jnp.asarray(x).astype(jt), jnp.asarray(s),
                              jnp.asarray(w).astype(jt))
            assert out.dtype == jt
            cache[key] = np.asarray(out, np.float32)
        return cache[key]
    return run


def inputs(sizes, *, T=None, d=D, f=F, seed=0):
    """x [T, d], sizes [E] int32, W [E, d, f] fp32 numpy, distributed as in
    tests/test_kernels_pallas.py (x standard normal, W scaled by 0.1)."""
    rng = np.random.default_rng(seed)
    T = sum(sizes) if T is None else T
    x = rng.standard_normal((T, d)).astype(np.float32)
    w = (rng.standard_normal((len(sizes), d, f)) * 0.1).astype(np.float32)
    return x, np.asarray(sizes, np.int32), w


def _port(impl, sizes, dtype, T=None, device="cpu"):
    x, s, w = inputs(sizes, T=T)
    tt = getattr(torch, dtype)
    out = ops.grouped_gemm(torch.from_numpy(x).to(device, tt),
                           torch.from_numpy(s).to(device),
                           torch.from_numpy(w).to(device, tt), impl=impl)
    assert out.dtype == tt and out.shape == (x.shape[0], w.shape[2])
    return out


def _close(a, b, tol):
    np.testing.assert_allclose(np.asarray(a, np.float32),
                               np.asarray(b, np.float32), atol=tol, rtol=tol)


# ------------------------------------------------------------ CPU vs JAX

@pytest.mark.parametrize("jax_path", ["pallas", "xla", "ref"])
@pytest.mark.parametrize("impl", ["torch", "ref"])
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("sizes", SIZES, ids=str)
def test_port_vs_jax(jref, sizes, dtype, impl, jax_path):
    out = _port(impl, sizes, dtype)
    _close(out.float().numpy(), jref(jax_path, sizes, dtype), TOL[dtype])


@pytest.mark.parametrize("jax_path", ["xla", "ref"])
@pytest.mark.parametrize("impl", ["torch", "ref"])
@pytest.mark.parametrize("dtype", DTYPES)
def test_rows_past_the_groups_are_zero(jref, dtype, impl, jax_path):
    """sum(sizes) = 30 < T = 40: rows 30-39 are exactly zero, as
    ``ragged_dot`` and the reference oracle give them."""
    sizes = [10, 0, 20]
    out = _port(impl, sizes, dtype, T=40)
    assert torch.count_nonzero(out[30:]) == 0
    _close(out.float().numpy(), jref(jax_path, sizes, dtype, T=40), TOL[dtype])


@pytest.mark.parametrize("dtype", DTYPES)
def test_uniform_groups_match_the_capacity_einsum(monkeypatch, dtype):
    """With every group of the capacity C, the grouped GEMM over the
    flattened [E, C, D] dispatch buffer of ``moe._moe_local`` is that
    function's own ``einsum("ecd,edf->ecf")`` (reduced olmoe-1b-7b width)."""
    from repro_torch.models import moe
    cfg = reduced(get_config("olmoe-1b-7b"))
    tt = getattr(torch, dtype)
    rng = np.random.default_rng(3)
    d, f, E = cfg.d_model, cfg.d_ff_expert, cfg.n_experts
    x = torch.from_numpy(rng.standard_normal((2, 16, d)).astype(np.float32))
    router = torch.from_numpy(rng.standard_normal((d, E)).astype(np.float32))
    w1, wg, w2 = (torch.from_numpy((rng.standard_normal(s) * 0.1).astype(
        np.float32)).to(tt) for s in ((E, d, f), (E, d, f), (E, f, d)))
    calls = []
    real = torch.einsum

    def spy(eq, *operands):
        out = real(eq, *operands)
        calls.append((eq, operands, out))
        return out

    monkeypatch.setattr(torch, "einsum", spy)
    moe._moe_local(x, router, w1, wg, w2, cfg, compute_dtype=tt)
    monkeypatch.undo()
    eq, (dispatch, w), want = calls[0]
    assert eq == "ecd,edf->ecf" and w.shape == w1.shape
    _, C, _ = dispatch.shape
    sizes = torch.full((E,), C, dtype=torch.int32)
    for impl in ("torch", "ref"):
        got = ops.grouped_gemm(dispatch.reshape(E * C, d), sizes, w, impl=impl)
        _close(got.float().reshape(E, C, f).numpy(), want.float().numpy(),
               TOL[dtype])


def test_cpu_tensors_take_the_plain_version():
    from repro_torch.kernels.grouped_gemm import kernel
    before = kernel.KERNEL.launches
    for sizes in SIZES:
        assert torch.equal(_port(None, sizes, "float32"),
                           _port("torch", sizes, "float32"))
    assert kernel.KERNEL.launches == before


def test_int64_sizes_and_oversized_groups():
    """int64 sizes give the int32 result; sizes summing past T are cut at
    T, as the reference oracle cuts its slices."""
    x, s, w = (torch.from_numpy(a) for a in inputs([40, 0, 26, 30]))
    out = ops.grouped_gemm(x, s, w)
    assert torch.equal(ops.grouped_gemm(x, s.long(), w), out)
    big = torch.tensor([40, 0, 26, 50])
    for impl in ("torch", "ref"):
        assert torch.equal(ops.grouped_gemm(x, big, w, impl=impl), out)


def test_cuda_impl_refuses_cpu_tensors():
    """The kernel wrapper never falls back: on a CPU tensor it raises
    before any build or launch, and its launch count stays put."""
    from repro_torch.kernels.grouped_gemm import kernel
    before = kernel.KERNEL.launches
    x, s, w = (torch.from_numpy(a) for a in inputs([40, 0, 26, 30]))
    with pytest.raises(ValueError, match="CUDA"):
        ops.grouped_gemm(x, s, w, impl="cuda")
    with pytest.raises(ValueError, match="unknown"):
        ops.grouped_gemm(x, s, w, impl="pallas")
    assert kernel.KERNEL.launches == before


def test_bad_arguments_raise():
    x, s, w = (torch.from_numpy(a) for a in inputs([40, 0, 26, 30]))
    with pytest.raises(TypeError, match="one dtype"):
        ops.grouped_gemm(x.bfloat16(), s, w)
    with pytest.raises(ValueError, match="integers"):
        ops.grouped_gemm(x, s.float(), w)
    with pytest.raises(ValueError, match=r"\[E"):
        ops.grouped_gemm(x, s[:3], w)
    with pytest.raises(ValueError, match=r"\[T, D\]"):
        ops.grouped_gemm(x[:, :5], s, w)


# ------------------------------------------------------------ card: kernel

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _kernel_vs_plain(sizes, dtype, *, T=None, d=D, f=F, sizes_dtype=torch.int32,
                     seed=0, variant=None):
    """The kernel against the plain version; ``variant`` (for bf16) is the
    kernel the call must take."""
    from repro_torch.kernels.grouped_gemm import kernel
    x, s, w = inputs(sizes, T=T, d=d, f=f, seed=seed)
    tt = getattr(torch, dtype)
    x, w = (torch.from_numpy(a).cuda().to(tt) for a in (x, w))
    s = torch.from_numpy(s).cuda().to(sizes_dtype)
    expect = variant if dtype == "bfloat16" else "fp32 CUDA cores"
    if expect is not None:
        assert kernel.variant(x, s, w) == expect
    before = kernel.KERNEL.launches
    got = ops.grouped_gemm(x, s, w)
    want = ops.grouped_gemm(x, s, w, impl="torch")
    torch.cuda.synchronize()
    assert kernel.KERNEL.launches == before + 1
    assert got.dtype == tt and got.shape == want.shape
    _close(got.float().cpu().numpy(), want.float().cpu().numpy(), TOL[dtype])
    return got


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("sizes", SIZES, ids=str)
def test_kernel_vs_plain(cuda, sizes, dtype):
    _kernel_vs_plain(sizes, dtype)


WGMMA_128, WGMMA_256 = "bf16 wgmma 128x256", "bf16 wgmma 256x128"
MMA_SYNC = "bf16 mma.sync 64x128"


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("d, f, variant", [(40, 72, WGMMA_128), (33, 50, MMA_SYNC),
                                           (136, 136, WGMMA_128), (7, 3, MMA_SYNC)])
def test_kernel_off_the_tile(cuda, d, f, variant, dtype):
    """D and F not multiples of the tile: multiples of 8 take the TMA-fed
    wgmma kernel, the others the mma.sync kernel's element path."""
    _kernel_vs_plain([40, 0, 26, 30, 70, 1], dtype, d=d, f=f, variant=variant)


def _ragged(total, groups, seed):
    rng = np.random.default_rng(seed)
    return rng.multinomial(total, np.full(groups, 1.0 / groups)).tolist()


TILE_EDGE_CASES = {
    # name: (sizes, T, d, f, the bf16 kernel); 256-row tiles where groups
    # average 128 rows or more and D >= 8192
    "groups of 1 to 257 rows": ([1, 63, 64, 65, 127, 128, 129, 257], None, 128, 256, WGMMA_128),
    "T and F off the tile": ([100, 0, 157], 300, 96, 200, WGMMA_128),
    "128 groups of ~75 rows": (_ragged(9600, 128, 11), None, 128, 128, WGMMA_128),
    "one group of 5 row tiles": ([600], None, 64, 136, WGMMA_128),
    "one group of 5 256-row tiles": ([1100], None, 8192, 136, WGMMA_256),
    "groups of 1 to 513 rows, 256-row tiles": (
        [1, 127, 128, 129, 255, 256, 257, 511, 513], 2214, 8192, 264, WGMMA_256),
}
# fp32 sums over D 8192 drift past the reference's 1e-5 (its depth is 32),
# so the 256-row cases, which need that depth, run in bf16 only
TILE_EDGE_PARAMS = [(case, dtype) for case, (_, _, d, _, _) in TILE_EDGE_CASES.items()
                    for dtype in DTYPES if d < 8192 or dtype == "bfloat16"]


@pytest.mark.cuda
@pytest.mark.parametrize("case, dtype", TILE_EDGE_PARAMS)
def test_kernel_tile_edges(cuda, case, dtype):
    """The wgmma kernel's tiles (128 x 256, or 256 x 128 where groups
    average 128 rows or more at D >= 8192) against groups that end on,
    before and after a tile edge, a tail past the last group, F off the
    column block, and a group of many row tiles; fp32 runs the same shapes
    on the CUDA cores."""
    sizes, T, d, f, variant = TILE_EDGE_CASES[case]
    out = _kernel_vs_plain(sizes, dtype, T=T, d=d, f=f, variant=variant)
    if T is not None and T > sum(sizes):
        assert int(torch.count_nonzero(out[sum(sizes):])) == 0


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
def test_kernel_tail_rows_are_zero(cuda, dtype):
    out = _kernel_vs_plain([10, 0, 20], dtype, T=200)
    assert int(torch.count_nonzero(out[30:])) == 0


@pytest.mark.cuda
def test_kernel_int64_sizes_and_many_groups(cuda):
    """int64 sizes; 1,500 groups, more than one block of the schedule's
    scan (1,024), most of them empty or short."""
    _kernel_vs_plain([40, 0, 26, 30], "bfloat16", sizes_dtype=torch.int64)
    sizes = np.random.default_rng(5).integers(0, 4, 1500)
    sizes[::7] = 0
    _kernel_vs_plain(sizes.tolist(), "float32", d=16, f=24)


@pytest.mark.cuda
def test_kernel_at_olmoe_width(cuda):
    """olmoe-1b-7b's experts (64 of 2048 x 1024) in bf16, 9,616 rows in
    ragged groups."""
    rng = np.random.default_rng(7)
    sizes = rng.multinomial(9616, rng.dirichlet(np.ones(64)))
    sizes[[3, 17]] = 0
    sizes[0] += 9616 - sizes.sum()
    _kernel_vs_plain(sizes.tolist(), "bfloat16", d=2048, f=1024, variant=WGMMA_128)
