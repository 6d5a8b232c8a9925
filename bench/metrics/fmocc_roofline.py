"""Share of its roofline that the fmocc kernel reached over the window:
the least time of its launches (``frozen.work``, from the inputs
recorded at the port's entry) over its device time (the profiler's
events of its kernels), in %."""


def read(ctx):
    work = ctx.work_s.get("fmocc")
    dev = ctx.device.get("kernel_s", {}).get("fmocc")
    return 100.0 * work / dev if work and dev else None
