"""Mate rescue's planning: the port's ``pe_rescue.plan`` span (every
candidate window of a chunk, its anchor-seed search, the tasks), in ms a
thousand reads.  A port without the span reports nothing."""


def read(ctx):
    t = ctx.time_s("pe_rescue.plan")
    return ctx.ms_per_kread(t) if t else None
