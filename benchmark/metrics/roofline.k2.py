"""roofline.k2: percent of the least time of the shadow atlas raster (K2,
the depth-only launch of csrc/raster.cu) on the stretch frames' inputs
(harness/work.k2_least_s, from the reference's counts) over K2's mean
device time per launch in the stretch's trace."""
from benchmark.harness import work

KERNEL = r"raster_tiles_kernel<false"


def read(run):
    if run.trace is None or not run.work:
        return None
    sec, launches = run.trace.kernel_seconds(KERNEL)
    return work.roofline_pct([work.k2_least_s(w) for w in run.work], sec,
                             launches)
