"""The weights, the counts and the leaves that the three cells read stay
those of the harness before the configurations named their reference
module: values taken from that harness (the dense decoder's leaves and
counts were then in ``harness/weights.py`` and ``harness/flops.py``) and
written here, against what the loader gives now."""
import hashlib
import json
from pathlib import Path

import pytest
import torch

from harness import weights
from harness.flops import counts

BENCH = Path(__file__).resolve().parents[1]
DATA = Path(__file__).resolve().parent / "data"
SEED = 2 ** 31 + 977
LENGTHS = [1500, 256, 100, 17, 1]

LEAVES = {
    "qwen2-7b": [
        (("embed", "table"), (155648, 3584), "matrix", 1.0),
        (("final_norm",), (3584,), "norm", 0.1),
        (("lm_head", "w"), (3584, 155648), "matrix", 0.016703827619526525),
        (("blocks", "sub0", "ln1"), (28, 3584), "norm", 0.1),
        (("blocks", "sub0", "attn", "wq", "w"), (28, 3584, 3584), "matrix",
         0.016703827619526525),
        (("blocks", "sub0", "attn", "wq", "b"), (28, 3584), "bias", 0.05),
        (("blocks", "sub0", "attn", "wk", "w"), (28, 3584, 512), "matrix",
         0.016703827619526525),
        (("blocks", "sub0", "attn", "wk", "b"), (28, 512), "bias", 0.05),
        (("blocks", "sub0", "attn", "wv", "w"), (28, 3584, 512), "matrix",
         0.016703827619526525),
        (("blocks", "sub0", "attn", "wv", "b"), (28, 512), "bias", 0.05),
        (("blocks", "sub0", "attn", "wo", "w"), (28, 3584, 3584), "matrix",
         0.016703827619526525),
        (("blocks", "sub0", "ln2"), (28, 3584), "norm", 0.1),
        (("blocks", "sub0", "ffn", "wi", "w"), (28, 3584, 18944), "matrix",
         0.016703827619526525),
        (("blocks", "sub0", "ffn", "wg", "w"), (28, 3584, 18944), "matrix",
         0.016703827619526525),
        (("blocks", "sub0", "ffn", "wo", "w"), (28, 18944, 3584), "matrix",
         0.007265477421488705),
    ],
    "internvl2-2b": [
        (("embed", "table"), (94208, 2048), "matrix", 1.0),
        (("final_norm",), (2048,), "norm", 0.1),
        (("lm_head", "w"), (2048, 94208), "matrix", 0.02209708691207961),
        (("blocks", "sub0", "ln1"), (24, 2048), "norm", 0.1),
        (("blocks", "sub0", "attn", "wq", "w"), (24, 2048, 2048), "matrix",
         0.02209708691207961),
        (("blocks", "sub0", "attn", "wk", "w"), (24, 2048, 1024), "matrix",
         0.02209708691207961),
        (("blocks", "sub0", "attn", "wv", "w"), (24, 2048, 1024), "matrix",
         0.02209708691207961),
        (("blocks", "sub0", "attn", "wo", "w"), (24, 2048, 2048), "matrix",
         0.02209708691207961),
        (("blocks", "sub0", "ln2"), (24, 2048), "norm", 0.1),
        (("blocks", "sub0", "ffn", "wi", "w"), (24, 2048, 8192), "matrix",
         0.02209708691207961),
        (("blocks", "sub0", "ffn", "wg", "w"), (24, 2048, 8192), "matrix",
         0.02209708691207961),
        (("blocks", "sub0", "ffn", "wo", "w"), (24, 8192, 2048), "matrix",
         0.011048543456039806),
        (("frontend_proj", "w"), (1024, 2048), "matrix", 0.03125),
    ],
}

# num_params, matmul_params, model_flops_for(m, 4096, 4, mode) for train
# (train_4k's), prefill and decode; prefill_flops and attention_bound_s of
# LENGTHS and of [7, 3]; decode_flops and decode_attention_bound_s of 11
# slots over 4,242 positions and of 32 over 30,000
COUNTS = {
    "qwen2-7b": {
        "num_params": 7615283200,
        "matmul_params": 6525288448,
        "model_flops_for.train": 789019852013568.0,
        "model_flops_for.prefill": 263006617337856.0,
        "model_flops_for.decode": 67498934272.0,
        "prefill_flops": 24929409777664.0,
        "decode_flops": 157249060864.0,
        "attention_bound_s": 0.00047237482386248736,
        "attention_bound_s.short": 1.3694089552238807e-06,
        "decode_attention_bound_s": 7.393096597014925e-05,
        "decode_attention_bound_s.many": 0.0005173627032835821,
    },
    "internvl2-2b": {
        "num_params": 1889046528,
        "matmul_params": 1509949440,
        "model_flops_for.train": 205492039188480.0,
        "model_flops_for.prefill": 68497346396160.0,
        "model_flops_for.decode": 18333597696.0,
        "prefill_flops": 5890008207360.0,
        "decode_flops": 38222966784.0,
        "attention_bound_s": 0.00023136726066734075,
        "attention_bound_s.short": 8.803343283582089e-07,
        "decode_attention_bound_s": 0.00012512485253731343,
        "decode_attention_bound_s.many": 0.0008822123749253731,
    },
}

# sha256 of every leaf's bytes in order, bf16 read as int16, at SEED
WEIGHTS_SHA256 = {
    ("tiny-dense", "bfloat16"):
        "2be1ffa46d3825ee219e3b259f595b16c8fe463439b26b612fcc363304da330b",
    ("tiny-dense", "float32"):
        "3f5f750319624986682abfd4585d161246f1c19746d3571b4244311cea9e2c93",
    ("tiny-vlm", "bfloat16"):
        "48a045de9d76ab76775e25fe10a1d0434675d23039b63e2e9f706fca545772b0",
    ("tiny-vlm", "float32"):
        "9db4db36ce1b2e487da2db0bc35229c07f8b774185e86b59fe092b19b2320031",
}


def _config(name):
    path = BENCH / "configs" / f"{name}.json"
    if not path.is_file():
        path = DATA / "configs" / f"{name}.json"
    return json.loads(path.read_text())


@pytest.mark.parametrize("name", sorted(LEAVES))
def test_leaves_are_the_same(name):
    assert weights.leaves(_config(name)) == LEAVES[name]


@pytest.mark.parametrize("name", sorted(COUNTS))
def test_counts_are_the_same(name):
    config = _config(name)
    m, f = config["model"], counts(config)
    got = {"num_params": f.num_params(m),
           "matmul_params": f.matmul_params(m),
           "prefill_flops": f.prefill_flops(m, LENGTHS),
           "decode_flops": f.decode_flops(m, 11, 4242),
           "attention_bound_s": f.attention_bound_s(m, LENGTHS),
           "attention_bound_s.short": f.attention_bound_s(m, [7, 3]),
           "decode_attention_bound_s": f.decode_attention_bound_s(m, 11,
                                                                  4242),
           "decode_attention_bound_s.many": f.decode_attention_bound_s(
               m, 32, 30000)}
    for mode in ("train", "prefill", "decode"):
        got[f"model_flops_for.{mode}"] = f.model_flops_for(m, 4096, 4, mode)
    assert got == COUNTS[name]
    assert (f.PEAK_BF16, f.HBM_BW) == (989e12, 3.35e12)


@pytest.mark.parametrize("name,dtype", sorted(WEIGHTS_SHA256))
def test_weights_are_the_same(name, dtype):
    config = _config(name)
    tree = weights.make_weights(config, SEED, torch.device("cpu"),
                                getattr(torch, dtype))
    h = hashlib.sha256()
    for path, _, _, _ in weights.leaves(config):
        t = weights.get(tree, path)
        if t.dtype == torch.bfloat16:
            t = t.view(torch.int16)
        h.update(t.contiguous().numpy().tobytes())
    assert h.hexdigest() == WEIGHTS_SHA256[(name, dtype)]
