"""Share of the traced window in which nothing ran on the device:
1 - (the union of device activity) / (the window's length)."""

SOURCE = "device_trace"
UNIT = "%"


def read(ctx):
    return 100.0 * (1.0 - ctx.trace.busy_s / ctx.trace.window_s)
