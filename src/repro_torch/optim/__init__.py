"""The optimizer of the LM training path (``repro.optim``' counterpart)."""
from .adamw import AdamWConfig, adamw_init, adamw_update  # noqa: F401
