from .ops import galign_call, global_align_batch  # noqa: F401
