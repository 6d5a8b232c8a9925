"""Self time of the port's ``io`` span (FASTQ reading, batch packing,
SAM writing), without its nested ``sam_format``, in ms a thousand reads."""


def read(ctx):
    io = ctx.time_s("io")
    return ctx.ms_per_kread(io - ctx.time_s("sam_format")) if io else None
