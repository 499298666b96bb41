"""Quasi-Newton iterations a frame (StepStats.inner_iters of the traced
frames): the stepper's count. A kernel change must leave it within f32
noise; a preconditioner change moves it."""

SOURCE = "program_counter"
UNIT = "iter/frame"


def read(ctx):
    return sum(f["iters"] for f in ctx.frame_stats) / ctx.frames
