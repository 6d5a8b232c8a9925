"""The port's ``sal`` and ``chain`` spans, in ms a thousand reads."""


def read(ctx):
    t = ctx.time_s("sal") + ctx.time_s("chain")
    return ctx.ms_per_kread(t) if t else None
