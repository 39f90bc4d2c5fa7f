"""The frozen counts against numbers worked out by hand for qwen2-7b: one
decode step and one admit call, and their kernels' bounds, as the
per-layer metrics read them (``harness.flops.counts``: the peaks beside
the configuration's reference module's counts)."""
import json
from pathlib import Path

import pytest

from harness.flops import counts

CONFIG = json.loads((Path(__file__).resolve().parents[1] / "configs"
                     / "qwen2-7b.json").read_text())
QWEN = CONFIG["model"]
flops = counts(CONFIG)

# per layer: q, k, v (3584 x 128 x (28 + 4 + 4)), o (28 x 128 x 3584),
# the SwiGLU (3 x 3584 x 18944); 28 layers
LAYER = 16_515_072 + 12_845_056 + 203_685_888
MATMUL = 28 * LAYER                       # 6,525,288,448
HEAD = 2 * 3_584 * 152_064                # logits of one position


def test_matmul_params():
    assert LAYER == 233_046_016
    assert flops.matmul_params(QWEN) == MATMUL == 6_525_288_448


def test_decode_step_flops_and_bound():
    # 3 live slots whose contexts (new token in) are 100, 200 and 300
    ops = 3 * (2 * MATMUL + HEAD) + 4 * 28 * 128 * 600 * 28
    assert ops == 3 * 14_140_571_648 + 240_844_800
    assert flops.decode_flops(QWEN, 3, 600) == ops
    # per layer: K and V of 600 positions x 4 heads x 128 x 2 bytes, q and
    # the output of 3 rows x 28 heads x 128 x 2 bytes
    per_layer = 600 * 2 * 4 * 128 * 2 + 3 * 2 * 28 * 128 * 2
    assert per_layer == 1_271_808
    assert flops.decode_attention_bound_s(QWEN, 3, 600) == pytest.approx(
        28 * per_layer / 3.35e12, rel=1e-12)


def test_admit_call_flops_and_bound():
    # two prompts of 256 and 100 true tokens in one call
    pairs = 256 * 257 // 2 + 100 * 101 // 2      # 32,896 + 5,050
    ops = 2 * MATMUL * 356 + 4 * 28 * 128 * pairs * 28 + 2 * HEAD
    assert flops.prefill_flops(QWEN, [256, 100]) == ops
    assert pairs == 37_946
    # causal pairs at the peak against q, k, v, o of 356 tokens: compute
    t_ops = 28 * 4 * 28 * 128 * pairs / 989e12
    t_bytes = 28 * 356 * (2 * 28 + 2 * 4) * 128 * 2 / 3.35e12
    assert flops.attention_bound_s(QWEN, [256, 100]) == pytest.approx(
        max(t_ops, t_bytes), rel=1e-12)


def test_model_flops_for_copy():
    # 6 N D + 3 x attention, N with the embedding and the untied head
    n = 152_064 * 3_584 * 2 + MATMUL
    assert flops.num_params(QWEN) == n
    attn = 28 * 4.0 * 4 * 4096 * 2048 * 28 * 128
    assert flops.model_flops_for(QWEN, 4096, 4, "train") == pytest.approx(
        6.0 * n * 4 * 4096 + 3 * attn, rel=1e-12)
