from .ops import diag_seed_batch, diagseed_call  # noqa: F401
