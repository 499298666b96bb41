"""The 95th percentile of every frame's host-clock time in the window
(statistics.quantiles, n = 20, exclusive): stalls and the lap's hardest
frames."""

import statistics

SOURCE = "host_clock"
UNIT = "ms"


def read(ctx):
    if len(ctx.frame_times) < 2:
        return None
    return statistics.quantiles(ctx.frame_times, n=20)[18] * 1e3
