"""Milliseconds a frame: the window's wall time (host clock, from the
start of its first frame to the end of its last, lap resets included)
over the frames it completed."""

SOURCE = "host_clock"
UNIT = "ms"


def read(ctx):
    return ctx.wall * 1e3 / ctx.frames
