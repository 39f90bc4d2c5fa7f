"""The port's roofline (``repro_torch.roofline``) against the JAX package's
(``repro.roofline``), on the CPU.

- ``model_flops_for`` and ``kernel_region_traffic`` are copies of the
  reference's arithmetic on the config and the shape: equal, exactly, for
  every assigned arch and each of the four production shapes.
- The collective charge (``collective_stats``, from recorded collectives)
  equals the reference's ``parse_collectives`` on HLO lines written here,
  for each op kind, groups of 1, 2, 4 and 16, in the brace and the iota
  ``replica_groups`` forms.
- ``Roofline``'s properties follow the reference's once the test sets the
  constants equal (both links at the reference's ICI rate).
- The link rule: a group inside one node of 8 consecutive ranks is charged
  at NVLink, a group across nodes at the NIC.
- ``trace_cost`` on a small function: a product's 2 M N K FLOPs, a view
  free, a gather and a cache write charged by the rows they touch, and
  the regions by the function on the stack.
"""
import pytest
import torch

jax = pytest.importorskip("jax")   # the reference; absent on the card's machine

import repro.roofline.analysis as ja
from repro.configs import ASSIGNED as J_ASSIGNED
from repro.configs import get_config as j_get_config
from repro.configs import get_shape as j_get_shape

import repro_torch.roofline.analysis as pa
from repro_torch.configs import ASSIGNED, get_config, get_shape
from repro_torch.roofline.trace_cost import trace_cost

SHAPES = ["train_4k", "prefill_32k", "decode_32k", "long_500k"]
OPS = ["all-reduce", "all-gather", "reduce-scatter", "all-to-all",
       "collective-permute"]


def test_same_archs():
    assert list(ASSIGNED) == list(J_ASSIGNED)


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("arch", ASSIGNED)
def test_model_flops_and_region_traffic_match_reference(arch, shape):
    cfg, sh = get_config(arch), get_shape(shape)
    jcfg, jsh = j_get_config(arch), j_get_shape(shape)
    assert pa.model_flops_for(cfg, sh, sh.kind) == \
        ja.model_flops_for(jcfg, jsh, jsh.kind)
    assert pa.kernel_region_traffic(cfg, sh) == \
        ja.kernel_region_traffic(jcfg, jsh)


def _hlo_line(op, n, form):
    groups = (f"replica_groups={{{{{','.join(str(i) for i in range(n))}}}}}"
              if form == "brace" else f"replica_groups=[{64 // n},{n}]<=[64]")
    return (f"  %x.1 = bf16[1024,16]{{1,0}} {op}(bf16[1024,16]{{1,0}} %p.0), "
            f"channel_id=1, {groups}, use_global_device_ids=true")


@pytest.mark.parametrize("form", ["brace", "iota"])
@pytest.mark.parametrize("n", [1, 2, 4, 16])
@pytest.mark.parametrize("op", OPS)
def test_collective_charge_matches_parse_collectives(op, n, form):
    want = ja.parse_collectives(_hlo_line(op, n, form) + "\n"
                                + _hlo_line(op, n, form))
    out_bytes = 1024 * 16 * 2
    got = pa.collective_stats([(op, out_bytes, range(n))] * 2)
    assert got.counts == want.counts
    assert got.bytes_by_op == pytest.approx(want.bytes_by_op, rel=1e-12)
    assert got.total_bytes == pytest.approx(want.total_bytes, rel=1e-12)
    assert (got.total_bytes > 0) == (n > 1)


def test_roofline_properties_follow_reference(monkeypatch):
    for name in ("PEAK_FLOPS", "HBM_BW"):
        monkeypatch.setattr(pa, name, getattr(ja, name))
    monkeypatch.setattr(pa, "NVLINK_BW", ja.ICI_BW)
    monkeypatch.setattr(pa, "NIC_BW", ja.ICI_BW)
    cases = [(3.2e15, 1.1e13, 4.0e9, 2.5e15), (1e12, 9e14, 1e6, 2e11),
             (5e14, 1e10, 8e11, 4e14), (0.0, 0.0, 0.0, 1.0)]
    for flops, nbytes, coll, model in cases:
        common = dict(arch="a", shape="s", mesh="16x16", chips=256,
                      hlo_flops=flops, hlo_bytes=nbytes,
                      collective_bytes=coll, model_flops=model,
                      collectives={"all-gather": coll},
                      collective_counts={"all-gather": 3},
                      bytes_per_device=1e9, hlo_bytes_raw=2 * nbytes,
                      bytes_by_region={"attention": nbytes / 2})
        want = ja.Roofline(**common)
        got = pa.Roofline(**common, collective_bytes_by_link={"nic": coll})
        for prop in ("t_compute", "t_memory", "t_collective", "bottleneck",
                     "step_time_lower_bound", "useful_flops_ratio",
                     "mfu_bound"):
            assert getattr(got, prop) == getattr(want, prop), prop
        gd, wd = got.to_dict(), want.to_dict()
        assert set(wd) <= set(gd)
        assert {k: gd[k] for k in wd} == wd


def test_link_rule():
    assert pa.link_of(range(8)) == "nvlink"
    assert pa.link_of(range(8, 16)) == "nvlink"
    assert pa.link_of([0, 4]) == "nvlink"             # (2, 4) data axis
    assert pa.link_of(range(16)) == "nic"             # 16 x 16 model axis
    assert pa.link_of(range(0, 256, 16)) == "nic"     # 16 x 16 data axis
    assert pa.link_of([7, 8]) == "nic"
    s = pa.collective_stats([("all-reduce", 1000.0, range(8)),
                             ("all-reduce", 1000.0, range(16)),
                             ("all-gather", 1000.0, [3])])
    inside, across = 2 * 1000 * 7 / 8, 2 * 1000 * 15 / 16
    assert s.bytes_by_link == pytest.approx({"nvlink": inside,
                                             "nic": across})
    assert s.counts == {"all-reduce": 2}
    rl = pa.Roofline(arch="a", shape="s", mesh="16x16", chips=256,
                     hlo_flops=0.0, hlo_bytes=0.0,
                     collective_bytes=s.total_bytes, model_flops=1.0,
                     collective_bytes_by_link=s.bytes_by_link)
    assert rl.t_collective == pytest.approx(inside / 450e9 + across / 50e9)
    assert rl.bottleneck == "collective"


def mha(x, w):
    """Named like the port's attention entry: its ops are "attention"."""
    return torch.softmax(x @ w, dim=-1)


def test_trace_cost_counts_a_small_function():
    M, K, N, V = 32, 64, 16, 100
    x, w = torch.randn(M, K), torch.randn(K, N)
    table, ids = torch.randn(V, K), torch.randint(0, V, (M,))
    cache, row = torch.zeros(8, 1024, K), torch.randn(8, K)

    def step(x, w, table, ids, cache, row):
        y = x @ w                                  # 2 M N K FLOPs
        yt = y.t()                                 # a view: free
        e = torch.nn.functional.embedding(ids, table)   # a gather
        cache[torch.arange(8), torch.full((8,), 5)] = row   # a cache write
        a = mha(x, w)
        return yt, e, a

    _, cost = trace_cost(step, x, w, table, ids, cache, row)
    fl = 4 * (M * N + K * N + M * K)       # the two products' operands
    assert cost.matmul_flops == 2 * (2 * M * N * K)
    assert cost.flops == cost.matmul_flops + M * N    # softmax: one a row
    assert cost.bytes_by_region["attention"] == fl + 2 * 4 * M * N
    row_b = 8 * K * 4
    assert cost.bytes_by_region["other"] == (
        fl + 2 * M * K * 4                 # the product, the gather
        + 2 * row_b + 2 * row_b)           # the write: the rows only
    assert cost.peak_bytes > 0
