"""The host's gather of each SMEM round's live entries and its scatter
of the results into dense arrays: the port's ``smem.pack`` and
``smem.unpack`` spans, in ms a thousand reads."""


def read(ctx):
    t = ctx.time_s("smem.pack") + ctx.time_s("smem.unpack")
    return ctx.ms_per_kread(t) if t else None
