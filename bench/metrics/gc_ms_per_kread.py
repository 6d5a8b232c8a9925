"""The garbage collector's seconds in the window (the port's
``time_gc_s``, summed by a ``gc.callbacks`` hook that a traced
``stream_sam`` holds), in ms a thousand reads; none where the port has
no such counter."""


def read(ctx):
    t = ctx.stats.get("time_gc_s")
    return None if t is None else ctx.ms_per_kread(t)
