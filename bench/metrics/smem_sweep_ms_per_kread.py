"""The backward phase's per-slot sweep of SMEM, once a round: the
port's ``smem.sweep`` span, in ms a thousand reads."""


def read(ctx):
    t = ctx.time_s("smem.sweep")
    return ctx.ms_per_kread(t) if t else None
