"""Window time that no stage span of the port covers (``io``, ``smem``,
``sal``, ``chain``, ``bsw``, ``finalize``, ``pe_stat``, ``pe_rescue``,
``pe_pair``: they do not nest in one another), in ms a thousand reads."""

STAGES = ("io", "smem", "sal", "chain", "bsw", "finalize", "pe_stat",
          "pe_rescue", "pe_pair")


def read(ctx):
    covered = sum(ctx.time_s(s) for s in STAGES)
    return ctx.ms_per_kread(ctx.window_s - covered) if covered else None
