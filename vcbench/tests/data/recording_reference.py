"""A reference module for the harness's tests: the dense one
(``vcbench/reference/model.py``) with every call recorded in ``CALLS``,
so that a test can see that the weights, the check and the counts of a
configuration that names this module came from it."""
from functools import wraps

from reference import model as dense

CALLS = []


def _recorded(fn):
    @wraps(fn)
    def call(*args, **kwargs):
        CALLS.append(fn.__name__)
        return fn(*args, **kwargs)
    return call


unsupported = _recorded(dense.unsupported)
exact_admission = _recorded(dense.exact_admission)
leaves = _recorded(dense.leaves)
inputs = _recorded(dense.inputs)
num_params = _recorded(dense.num_params)
matmul_params = _recorded(dense.matmul_params)
model_flops_for = _recorded(dense.model_flops_for)
prefill_flops = _recorded(dense.prefill_flops)
decode_flops = _recorded(dense.decode_flops)
attention_bound_s = _recorded(dense.attention_bound_s)
decode_attention_bound_s = _recorded(dense.decode_attention_bound_s)


class Ref(dense.Ref):
    def hidden(self, weights, seqs):
        CALLS.append("Ref.hidden")
        return super().hidden(weights, seqs)

    def row_loss_sum(self, w, tokens, patches=None):
        CALLS.append("Ref.row_loss_sum")
        return super().row_loss_sum(w, tokens, patches)
