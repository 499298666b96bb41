"""Device-to-host reads a frame (StepStats.syncs: System.host calls):
each one drains the device queue, so each costs the host loop a gap."""

SOURCE = "program_counter"
UNIT = "syncs/frame"


def read(ctx):
    return sum(f["syncs"] for f in ctx.frame_stats) / ctx.frames
