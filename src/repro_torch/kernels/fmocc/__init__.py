from .ops import LAYOUTS, make_occ_fn, occ  # noqa: F401
