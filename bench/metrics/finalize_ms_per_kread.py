"""The port's ``finalize`` span (decision replay, galign, CIGARs) and
its ``sam_format`` span, in ms a thousand reads."""


def read(ctx):
    t = ctx.time_s("finalize") + ctx.time_s("sam_format")
    return ctx.ms_per_kread(t) if t else None
