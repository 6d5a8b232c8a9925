"""The port's ``smem`` span (the host lockstep loop and its device
rounds), in ms a thousand reads."""


def read(ctx):
    t = ctx.time_s("smem")
    return ctx.ms_per_kread(t) if t else None
