"""decode_mfu (layer: model, ``models/``): the operations of the live
slots' tokens in each decode step (``flops.decode_flops``: inactive
slots not counted) over the steps' wall time at the bf16 peak, in %,
over the steps that ended in the window."""


def read(run):
    f = run.flops
    wall = sum(s.t1 - s.t0 for s in run.steps) / 1e9
    if wall <= 0:
        return None
    ops = sum(f.decode_flops(run.model, s.n_active, s.ctx_sum)
              for s in run.steps)
    return 100.0 * ops / (wall * f.PEAK_BF16)
