"""Each SMEM round's device round trip (the copy in, the fmocc launch,
the readback that waits for it): the port's ``smem.round`` span, in ms a
thousand reads."""


def read(ctx):
    t = ctx.time_s("smem.round")
    return ctx.ms_per_kread(t) if t else None
