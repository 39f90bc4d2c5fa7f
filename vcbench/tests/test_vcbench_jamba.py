"""The Jamba2 reference module (``vcbench/reference/jamba.py``) and its
cell's check, on the CPU: its leaves are the program's tree, its counts
are worked out by hand at jamba2-mini's widths, it admits padded to
the engine's buckets; a tiny Jamba2 cell run through the harness is ``correct``, and
the fp8 control and three faults planted in the program
(``tools/faults.py``: one routed pair dropped a call, the gates
renormalised, the mixer's inner norms left out) are not. The last two
are what tells the published block from jamba-v0.1's, which the JAX
package copies."""
import sys
import time
from pathlib import Path

import pytest
import torch

from harness import cell as cell_mod
from harness import serve
from harness.manifest import Cell, Metric, load_json, reference
from reference import jamba

BENCH = Path(__file__).resolve().parents[1]
DATA = Path(__file__).resolve().parent / "data"
sys.path.insert(0, str(BENCH / "tools"))
import faults  # noqa: E402

CONFIG = load_json(BENCH / "configs" / "jamba2-mini.json")
MINI = CONFIG["model"]
CPU = torch.device("cpu")
SEED = 2 ** 31 + 4099
TINY = {"name": "tiny-jamba2", "family": "hybrid", "n_layers": 8,
        "d_model": 64, "n_heads": 4, "n_kv_heads": 2, "head_dim": 16,
        "d_ff": 96, "vocab": 256, "act": "silu", "norm_eps": 1e-6,
        "use_rope": False, "layer_pattern": "mmmmgmmm", "n_experts": 4,
        "top_k": 2, "d_ff_expert": 32, "moe_every": 2, "moe_offset": 1,
        "capacity_factor": 2.0, "router_renorm": False,
        "mamba_d_state": 8, "mamba_d_conv": 4, "mamba_expand": 2,
        "mamba_dt_rank": 8, "mamba_inner_norms": True}
# served_gap at SEED (CPU, 1.5-s windows, 6 runs each; the sample is the
# whole window, ~25 requests, as the cell's check reads most of its
# window): sound 0.190; the faults 1.33-5.18 (renormalised 1.33, dropped
# pair 1.58-2.54, no inner norms 4.29-5.18); the control 1.32-2.37 (1.32
# with the engine's padded admission). Over 10 other seeds the sound
# runs read 0.0-0.54 and the faults from 0.61: the tiny model in bf16 is
# noisy (hidden states 4-5% off float32 over its 8 layers), so the limit
# is this seed's
LIMIT = 0.5


def tiny_cell():
    config = {"name": "tiny-jamba2", "source": "test only", "reduced": [],
              "reference": "vcbench/reference/jamba.py", "dtype": "bfloat16",
              "model": TINY,
              "deployment": {"replicas": 1, "slots": 4, "max_len": 128}}
    e2e = [Metric("ttft_p95_ms", "ms", "lower", "host_clock", bound=0.05),
           Metric("tpot_p95_ms", "ms", "lower", "host_clock", bound=0.05),
           Metric("setup_s", "s", "lower", "host_clock", bound=0.25)]
    return Cell("tiny-jamba2.chat_tiny", "tiny-jamba2", "chat_tiny", 1,
                config, load_json(DATA / "mixes" / "chat_tiny.json"),
                {"sample": {"served_tokens": 400, "min_requests": 40,
                            "cross_section": 3},
                 "served_gap": {"limit": LIMIT},
                 "unfinished": {"limit": 0}, "wrong_length": {"limit": 0}},
                e2e, [])


@pytest.fixture(autouse=True)
def short_wait(monkeypatch):
    monkeypatch.setattr(serve, "WAIT_S", 30)


# ---------------------------------------------------------------- the module

def test_configuration_names_the_module_and_the_published_keys():
    assert reference(CONFIG) is reference(CONFIG)
    assert reference(CONFIG).__file__.endswith("vcbench/reference/jamba.py")
    catalog = {"attn_layer_offset": 4, "attn_layer_period": 8,
               "expert_layer_offset": 1, "expert_layer_period": 2,
               "hidden_size": 4096, "intermediate_size": 14336,
               "mamba_d_conv": 4, "mamba_d_state": 16, "mamba_dt_rank": 256,
               "mamba_expand": 2, "num_attention_heads": 32,
               "num_experts": 16, "num_experts_per_tok": 2,
               "num_key_value_heads": 8, "vocab_size": 65536,
               "rms_norm_eps": 1e-06, "tie_word_embeddings": False}
    assert {k: CONFIG[k] for k in catalog} == catalog
    assert CONFIG["reduced"] == ["num_hidden_layers"]
    assert CONFIG["num_hidden_layers"] == MINI["n_layers"] == 8
    assert MINI["capacity_factor"] * MINI["top_k"] == MINI["n_experts"]


def test_leaves_are_the_programs_tree():
    from repro_torch.models.config import ModelConfig
    from repro_torch.models.transformer import param_specs
    for model in (TINY, MINI):
        cfg = ModelConfig(**model)

        def walk(tree, path=()):
            for k, v in tree.items():
                if isinstance(v, dict):
                    yield from walk(v, path + (k,))
                else:
                    yield path + (k,), v
        specs = dict(walk(param_specs(cfg)))
        ours = {p: (s, kind) for p, s, kind, _ in jamba.leaves(model)}
        assert ours.keys() == specs.keys()
        for path, (shape, kind) in ours.items():
            p = specs[path]
            lead = (cfg.n_blocks,) if path[0] == "blocks" else ()
            assert shape == lead + p.shape, path
            assert (kind == "matrix") == p.compute, path


def test_counts_by_hand():
    d, di, dtr, n, f, V = 4096, 8192, 256, 16, 14336, 65536
    mixer = d * 2 * di + di * (dtr + 2 * n) + dtr * di + di * d
    attn = d * 128 * (32 + 2 * 8) + 32 * 128 * d
    routed = d * 16 + 2 * 3 * d * f           # router and the top-2
    dense = 3 * d * f
    # layers 0-7: m m m m g m m m, experts on the odd ones
    matmul = 7 * mixer + attn + 4 * routed + 4 * dense
    assert jamba.matmul_params(MINI) == matmul == 2_891_972_608
    every = (7 * (mixer + di * (4 + 1 + 1 + n + 1) + dtr + 2 * n) + attn
             + 4 * (d * 16 + 16 * 3 * d * f) + 4 * dense + 8 * 2 * d
             + 2 * V * d + d)
    assert jamba.num_params(MINI) == every
    assert sum(torch.Size(s).numel() for _, s, _, _ in
               jamba.leaves(MINI)) == every
    extra = 7 * (2 * 4 * di + di * (7 * n + 3))
    pairs = 256 * 257 // 2 + 100 * 101 // 2
    assert jamba.prefill_flops(MINI, [256, 100]) == \
        (2 * matmul + extra) * 356 + 4 * 32 * 128 * pairs + 2 * 2 * d * V
    assert jamba.decode_flops(MINI, 3, 600) == \
        (2 * matmul + extra + 2 * d * V) * 3 + 4 * 32 * 128 * 600
    bound = jamba.attention_bound_s(MINI, [256, 100],
                                    bound=lambda o, b: (o, b))
    assert bound == (4 * 32 * 128 * pairs, 356 * 80 * 128 * 2)
    ops, nbytes = jamba.scan_ops_bytes(MINI, [300, 300])
    assert ops == 7 * 600 * di * (7 * n + 3)
    assert nbytes == 7 * 4 * (600 * (3 * di + 2 * n) + 2 * 2 * di * n
                              + di * n + di)


def test_admission_and_what_it_does_not_cover():
    assert jamba.exact_admission(MINI) is False
    assert jamba.unsupported(MINI) is None and jamba.unsupported(TINY) is None
    for change, word in ((dict(router_renorm=True), "router_renorm"),
                         (dict(mamba_inner_norms=False), "inner_norms"),
                         (dict(capacity_factor=1.25), "capacity_factor"),
                         (dict(use_rope=True), "use_rope"),
                         (dict(layer_pattern="g"), "layer_pattern")):
        assert word in jamba.unsupported(dict(MINI, **change))
    with pytest.raises(NotImplementedError, match="jamba2-mini"):
        jamba.inputs(MINI, 1, torch.Generator(), CPU)
    with pytest.raises(NotImplementedError, match="jamba2-mini"):
        jamba.Ref(MINI).row_loss_sum({}, torch.zeros(3))


def test_scan_against_the_step_by_step_recurrence():
    ref = jamba.Ref(TINY)
    g = torch.Generator().manual_seed(3)
    G, L, DI, N = 3, 37, 8, 4
    u, B, C = (torch.randn(s, generator=g) for s in ((G, L, DI), (G, L, N),
                                                     (G, L, N)))
    dt = torch.rand((G, L, DI), generator=g) * 3
    A = -torch.rand((DI, N), generator=g) * 8      # dt A down to -24
    got = ref.scan(u, dt, A, B, C)
    h = torch.zeros(G, DI, N, dtype=torch.float64)
    for t in range(L):
        h = torch.exp(dt[:, t, :, None].double() * A.double()) * h + \
            (dt[:, t] * u[:, t]).double()[..., None] * B[:, t, None].double()
        want = (h * C[:, t, None].double()).sum(-1)
        torch.testing.assert_close(got[:, t].double(), want, rtol=1e-5,
                                   atol=1e-5)


# ---------------------------------------------------------------- the check

def _run(cell, seconds=1.5):
    return cell_mod.run_cell(cell, SEED, seconds, False, CPU,
                             time.monotonic(), log=lambda m: None)


def test_sound_run_is_correct():
    out = _run(tiny_cell())
    assert out["correct"], out["checks"]


@pytest.mark.parametrize("fault", sorted(faults.FAULTS))
def test_planted_faults_are_not_correct(fault, monkeypatch):
    faults.FAULTS[fault](monkeypatch.setattr)
    out = _run(tiny_cell())
    assert not out["correct"]
    assert out["checks"]["served_gap"]["value"] > LIMIT


def test_limit_lies_between_sound_runs_and_faults():
    """Readings on the same window's sample: the program's under the
    limit, the control's (the reference in fp8) and each fault's over
    it (each fault its own set-up, as ``vcbench/tools/faults.py`` makes
    them on the card)."""
    c = tiny_cell()
    rows = [faults.reading(c, SEED, 1.5, CPU, control=True)]
    rows += [faults.reading(c, SEED, 1.5, CPU, f) for f in faults.FAULTS]
    sound, bad = rows[0], rows[1:]
    assert sound["program"] <= LIMIT < sound["control"], rows
    assert sound["moe_pairs_dropped"] == 0 < sound["moe_pairs"]
    assert all(r["program"] > LIMIT for r in bad), rows
    dropped = {r["fault"]: r["moe_pairs_dropped"] for r in bad}
    assert dropped["dropped_pair"] > 0 == dropped["renormalised"]


def test_grouped_sequences_match_each_alone():
    """The reference runs a sample's sequences together (the cell's check
    reads most of a window's requests): zero-padded in a group behind their ends, each
    sequence's hidden states are those it has alone."""
    seqs = [torch.randint(0, 256, (n,)) for n in (60, 5, 33, 33, 1, 17)]
    groups = jamba._groups([len(s) for s in seqs])
    assert sorted(j for g in groups for j in g) == list(range(6))
    assert len(groups) == 1
    from harness.weights import make_weights
    w = make_weights(tiny_cell().config, SEED, CPU, torch.float32)
    hs = jamba.Ref(TINY).hidden(w, seqs)
    one = [jamba.Ref(TINY).hidden(w, [s])[0] for s in seqs]
    for a, b in zip(hs, one):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-5)


def test_scan_roofline_reads_a_slice():
    """``mamba_scan_roofline`` on a hand-made slice: the bound of the
    slice's admit groups at their buckets (the module's ``scan_ops_bytes``
    at the fp32 peak and the bandwidth) over the ``mamba_`` kernels' device
    time; nothing to read without an admit call in the slice."""
    from types import SimpleNamespace

    from harness.flops import counts
    from harness.kineto import DeviceEvent, Slice
    from harness.manifest import metric_reader
    from harness.probe import AdmitSpan

    dev = [DeviceEvent("nvjet_gemm", 110, 140, 1),
           DeviceEvent("mamba_tile_kernel", 220, 230, 4),
           DeviceEvent("mamba_tile_kernel", 300, 310, 5)]
    sl = Slice(dev, [], [], 0, 1000)
    cell = Cell("jamba2-mini.chat", "jamba2-mini", "chat", 1, CONFIG, {}, {})
    run = SimpleNamespace(slice=sl, cell=cell, model=MINI,
                          flops=counts(CONFIG),
                          slice_admits=[AdmitSpan(0, 1, [(1, 512, [300])]),
                                        AdmitSpan(2, 3, [(2, 64, [40, 33])])])
    bound = 0.0
    for lens in ([512], [64, 64]):
        ops, nbytes = jamba.scan_ops_bytes(MINI, lens)
        assert nbytes / 3.35e12 > ops / 67e12      # bound by the bytes
        bound += nbytes / 3.35e12
    assert metric_reader("mamba_scan_roofline")(run) == pytest.approx(
        100 * bound / 20e-9)
    run.slice_admits = []
    assert metric_reader("mamba_scan_roofline")(run) is None
