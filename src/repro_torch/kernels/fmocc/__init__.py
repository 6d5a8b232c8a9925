from .ops import (DEFAULT_CANDIDATE, LAYOUTS, OccConfig,  # noqa: F401
                  ext_round, occ)
