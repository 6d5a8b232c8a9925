"""Share of the dense slots the SMEM rounds scan that are live (sent to
the device): the port's ``smem_live_entries`` over its
``smem_round_slots``, in %."""


def read(ctx):
    live = ctx.stats.get("smem_live_entries")
    slots = ctx.stats.get("smem_round_slots")
    return 100.0 * live / slots if live and slots else None
