"""Launchers of the LM scaffolding (``repro.launch``' counterpart):
``steps``, ``serve`` and ``train``."""
