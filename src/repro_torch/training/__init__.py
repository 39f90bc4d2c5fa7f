"""Training substrate of the port: AdamW and the train step."""
from .optimizer import (OptimizerConfig, adamw_update, clip_by_global_norm,
                        global_norm, init_opt_state, lr_schedule,
                        opt_state_axes)
from .step import (compute_grads, make_decode_step, make_opt_state,
                   make_prefill_step, make_train_step)

__all__ = ["OptimizerConfig", "adamw_update", "init_opt_state", "lr_schedule",
           "global_norm", "clip_by_global_norm", "opt_state_axes",
           "make_train_step", "make_opt_state", "make_prefill_step",
           "make_decode_step", "compute_grads"]
