from .ops import bsw_call, bsw_extend_kernel  # noqa: F401
