"""The port's ``bsw`` stage span (planning, packing, the kernel's blocks,
the results table), in ms a thousand reads."""


def read(ctx):
    t = ctx.time_s("bsw")
    return ctx.ms_per_kread(t) if t else None
