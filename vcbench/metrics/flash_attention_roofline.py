"""flash_attention_roofline (layer: kernels, ``kernels/flash_attention``):
the least time of the prefill attention of the admit calls wholly inside
the profiled slice (``flops.attention_bound_s``: live tokens only) over
the device time of the ``attn_fwd`` kernels in the slice, in %. Nothing
to read where the slice holds no admit call."""


def read(run):
    sl = run.slice
    if sl is None or not run.slice_admits:
        return None
    t = sl.kernel_s("attn_fwd")
    if t <= 0:
        return None
    bound = sum(run.flops.attention_bound_s(run.model, lens)
                for a in run.slice_admits for _, _, lens in a.groups)
    return 100.0 * bound / t
