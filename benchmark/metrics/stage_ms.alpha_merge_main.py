"""stage_ms.alpha_merge_main: ms of the alpha_merge_main stage (the
alpha-tested layer's vertex stage, its depth peel over every pixel of
the main view and the merge into the visibility buffer), as
app/profiler.profile_frame times it (its own CUDA graph, replayed after
the window at the last frame's pose)."""


def read(run):
    return None if run.stages is None else run.stages.get("alpha_merge_main")
