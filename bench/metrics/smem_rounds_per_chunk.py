"""SMEM extension rounds a ``-K`` chunk: the port's ``smem_rounds``
counter over its ``io_batches``."""


def read(ctx):
    rounds, chunks = ctx.stats.get("smem_rounds"), ctx.stats.get("io_batches")
    return rounds / chunks if rounds and chunks else None
