"""serve_mfu.flood (layer: model, ``models/``, over the whole window): the
operations of every prompt admitted and every token generated in the
window over the window's length at the bf16 peak, in %."""


def read(run):
    f = run.flops
    if not run.steps and not run.admits:
        return None
    ops = (sum(f.prefill_flops(run.model, lens) for a in run.admits
               for _, _, lens in a.groups)
           + sum(f.decode_flops(run.model, s.n_active, s.ctx_sum)
                 for s in run.steps))
    return 100.0 * ops / (run.seconds * f.PEAK_BF16)
