"""The port's paired-end tail: ``pe_stat``, ``pe_rescue`` and
``pe_pair`` spans, in ms a thousand reads."""


def read(ctx):
    t = sum(ctx.time_s(s) for s in ("pe_stat", "pe_rescue", "pe_pair"))
    return ctx.ms_per_kread(t) if t else None
