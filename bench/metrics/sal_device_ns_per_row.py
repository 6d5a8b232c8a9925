"""Device time of the SAL gather (``sal_direct``), timed by the port's
own CUDA events (``time_device_sal_s``), in ns a suffix-array row it
looked up (``sal_rows``)."""


def read(ctx):
    t = ctx.stats.get("time_device_sal_s")
    rows = ctx.stats.get("sal_rows")
    return 1e9 * t / rows if t and rows else None
