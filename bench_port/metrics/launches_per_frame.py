"""Device kernels a frame in the profile (the markers left out): what the
host loop has to launch."""

SOURCE = "device_trace"
UNIT = "launches/frame"


def read(ctx):
    return ctx.trace.kernels / ctx.frames
