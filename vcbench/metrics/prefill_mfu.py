"""prefill_mfu (layer: model, ``models/``): the operations of the admitted
prompts' true tokens (``flops.prefill_flops``: no padding to the bucket)
over the admit calls' wall time at the bf16 peak, in %, over the calls
that ended in the window."""


def read(run):
    f = run.flops
    wall = sum(a.t1 - a.t0 for a in run.admits) / 1e9
    if wall <= 0:
        return None
    ops = sum(f.prefill_flops(run.model, lens) for a in run.admits
              for _, _, lens in a.groups)
    return 100.0 * ops / (wall * f.PEAK_BF16)
