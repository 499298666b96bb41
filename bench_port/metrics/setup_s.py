"""Seconds from the process's start to the window's: imports, the kernel
libraries (built at a checkout's first run, loaded after), the mesh file,
the Simulator (mesh, partition and plan, System, the first H0) and the
warm-up frame."""

SOURCE = "host_clock"
UNIT = "s"


def read(ctx):
    return ctx.setup_s
