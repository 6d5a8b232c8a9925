"""Share of its roofline that the galign kernel reached over the window:
the least time of its launches (``frozen.work``, from the inputs
recorded at the port's entry) over its device time (the profiler's
events of its kernels), in %."""


def read(ctx):
    work = ctx.work_s.get("galign")
    dev = ctx.device.get("kernel_s", {}).get("galign")
    return 100.0 * work / dev if work and dev else None
