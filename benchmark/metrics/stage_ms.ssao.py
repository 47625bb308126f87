"""stage_ms.ssao: ms of the ssao stage (ssao_pass with its blurs), as
app/profiler.profile_frame times it after the window."""


def read(run):
    return None if run.stages is None else run.stages.get("ssao")
