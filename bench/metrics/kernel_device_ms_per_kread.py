"""Device time of the port's kernel launches, timed by the port's own
CUDA events (``time_device_fmocc_s``, ``time_device_bsw_s``,
``time_device_galign_s``), in ms a thousand reads."""


def read(ctx):
    t = sum(ctx.time_s(f"device_{k}") for k in ("fmocc", "bsw", "galign"))
    return ctx.ms_per_kread(t) if t else None
