"""Model substrate of the port: the decoder stack (attention, RWKV6 and
Mamba layers; dense or MoE feed-forwards) and its training loss."""
from .config import SHAPES, ModelConfig, ShapeConfig, reduced
from .transformer import (cache_axes, decode_step, forward, init_cache,
                          init_params, logits_head, loss_fn, param_axes,
                          prefill)

__all__ = ["ModelConfig", "ShapeConfig", "SHAPES", "reduced", "init_params",
           "forward", "prefill", "decode_step", "init_cache", "cache_axes",
           "param_axes",
           "logits_head", "loss_fn"]
