"""Share of the traced window in which no operation ran on the device
(100 - the union of the profiler's device events over the window), in
%."""


def read(ctx):
    busy, window = ctx.device.get("busy_s"), ctx.device.get("window_s")
    return 100.0 * (1.0 - busy / window) if busy and window else None
