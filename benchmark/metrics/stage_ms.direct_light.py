"""stage_ms.direct_light: ms of the direct_light stage (the light loops of
passes/frame.direct_light: the Blinn-Phong ComputeLighting over the
point lights, or PBRShading over the directional lights), as
app/profiler.profile_frame times it (its own CUDA graph, replayed after
the window at the last frame's pose). A program without the stage
reports nothing."""


def read(run):
    return None if run.stages is None else run.stages.get("direct_light")
