"""stage_ms.shadow_factor: ms of the shadow_factor stage (light 0's
cascade PCF factor, passes/frame.shadow_factor_pass: the zero-radius
compare, or K6 with the soft disk), as app/profiler.profile_frame times
it (its own CUDA graph, replayed after the window at the last frame's
pose). A program without the stage reports nothing."""


def read(run):
    return None if run.stages is None else run.stages.get("shadow_factor")
