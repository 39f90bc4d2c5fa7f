"""flash_decode_roofline (layer: kernels, ``kernels/flash_decode``): the
least time of the decode attention of the steps wholly inside the
profiled slice (``flops.decode_attention_bound_s``, from the live slots'
contexts at each step) over the device time of the ``decode_`` kernels
(partials and combine) in the slice, in %."""


def read(run):
    sl = run.slice
    if sl is None or not run.slice_steps:
        return None
    t = sl.kernel_s("decode_")
    if t <= 0:
        return None
    bound = sum(run.flops.decode_attention_bound_s(run.model, s.n_active,
                                                   s.ctx_sum)
                for s in run.slice_steps)
    return 100.0 * bound / t
