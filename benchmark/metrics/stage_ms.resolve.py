"""stage_ms.resolve: ms of the compacted resolve_gbuffer stage, as
app/profiler.profile_frame times it (its own CUDA graph, replayed after
the window at the last frame's pose)."""


def read(run):
    return None if run.stages is None else run.stages.get("resolve_gbuffer")
