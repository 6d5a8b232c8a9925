"""Set-up: the benchmark's span around the index bundle's load
(``Aligner.from_bundle``) and its device view (``FMIndex.device``), in
s."""


def read(ctx):
    return ctx.setup.get("index_load_s")
