"""Launchers of the LM scaffolding (``repro.launch``' counterpart):
``steps`` and ``serve``."""
