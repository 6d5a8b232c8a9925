from .ops import LAYOUTS, ext_round, make_occ_fn, occ  # noqa: F401
