"""mamba_scan_roofline (layer: kernels, ``kernels/mamba_scan``): the least
time of the prefill scans of the admit calls wholly inside the profiled
slice over the device time of the ``mamba_`` scan kernels in the slice, in
%. One launch a Mamba layer and admit group, over the group's rows at
the group's bucket (the padded length the kernel runs over); the fp32
operations and bytes are the configuration's reference module's
``scan_ops_bytes``, the bound the longer of operations at the fp32 peak
and bytes at the bandwidth.
Nothing to read where the module has no such count, the slice holds no
admit call, or no scan kernel ran."""
from harness.manifest import reference

PEAK_FP32 = 67e12       # FLOP/s, H100 SXM, no tensor cores (data sheet)


def read(run):
    sl = run.slice
    count = getattr(reference(run.cell), "scan_ops_bytes", None)
    if sl is None or count is None or not run.slice_admits:
        return None
    t = sl.kernel_s("mamba_")
    if t <= 0:
        return None
    bound = 0.0
    for a in run.slice_admits:
        for rows, bucket, _ in a.groups:
            ops, nbytes = count(run.model, [bucket] * rows)
            bound += max(ops / PEAK_FP32, nbytes / run.flops.HBM_BW)
    return 100.0 * bound / t
