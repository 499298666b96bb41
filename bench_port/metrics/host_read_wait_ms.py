"""Host time a frame blocked in the program's device-to-host reads: the
wait counter of every `host_read` span (System.host, dot_tpu_torch.tracing)
over the traced frames. The lap has to show one host_read span for each
read StepStats.syncs counts."""

from bench_port import host_spans

SOURCE = "program_counter"
UNIT = "ms/frame"
NEEDS = ("host_read",)
needs = host_spans.needs


def read(ctx):
    recs = host_spans.records(ctx, NEEDS)
    if recs is None:
        return None
    wait = sum(r["wait_ns"] for r in recs if r["name"] == "host_read")
    return wait * 1e-6 / ctx.frames
