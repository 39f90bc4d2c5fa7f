"""attn_bwd_share (layer: train step, ``training/step.py``): the device
time of the kernels launched inside ``MhaFunctionBackward`` (the
attention backward: on the card the three launches of the hand-written
``flash_attention_bwd``, its preprocess, dK/dV pass and dQ pass) over
the device time of all the profiled step's kernels, in %."""
from harness.kineto import node_device_ms


def read(run):
    sl = run.slice
    if sl is None:
        return None
    total = sum(e.end_ns - e.start_ns for e in sl.dev) / 1e6
    if total <= 0:
        return None
    ms = node_device_ms(sl.cpu, sl.dev, ["MhaFunctionBackward"])
    return 100.0 * ms["MhaFunctionBackward"] / total
