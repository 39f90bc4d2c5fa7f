"""train_mfu (layer: train step, ``training/step.py``): the frozen
``flops.model_flops_for`` count of one step of the mix's batch (6 N D and
3x attention) over the mean wall time of the window's steps (the
profiled one left out) at the bf16 peak, in %."""


def read(run):
    steps = [s for i, s in enumerate(run.train_steps)
             if i != run.train_profiled]
    if not steps:
        return None
    mix = run.cell.mix
    ops = run.flops.model_flops_for(run.model, int(mix["seq"]),
                                    int(mix["batch"]), "train")
    mean_s = sum(b - a for a, b in steps) / len(steps) / 1e9
    return 100.0 * ops / (mean_s * run.flops.PEAK_BF16)
