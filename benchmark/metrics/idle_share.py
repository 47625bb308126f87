"""idle_share: percent of the profiler stretch (first device activity to
the last) in which no kernel, copy or set ran on the card."""


def read(run):
    return None if run.trace is None else run.trace.idle_share
