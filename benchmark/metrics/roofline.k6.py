"""roofline.k6: percent of the least time of the soft PCF (K6,
csrc/pcf.cu) on the stretch frames' inputs (harness/work.k6_least_s,
from the reference's counts) over K6's mean device time per launch in
the stretch's trace; nothing where K6 did not run."""
from benchmark.harness import work

KERNEL = r"soft_pcf_kernel"


def read(run):
    if run.trace is None or not run.work:
        return None
    sec, launches = run.trace.kernel_seconds(KERNEL)
    return work.roofline_pct([work.k6_least_s(w) for w in run.work], sec,
                             launches)
