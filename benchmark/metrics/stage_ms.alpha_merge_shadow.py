"""stage_ms.alpha_merge_shadow: ms of the alpha_merge_shadow stage (the
alpha-tested layer's depth peel inside each cascade's punch window and
its min-merge into the cascade maps), as app/profiler.profile_frame
times it after the window."""


def read(run):
    return (None if run.stages is None
            else run.stages.get("alpha_merge_shadow"))
