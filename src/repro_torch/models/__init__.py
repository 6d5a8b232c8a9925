"""The LM scaffolding's model code (``repro.models``' counterpart):
``layers``, ``attention``, ``moe``, ``ssm``, ``lm`` and ``convert``."""
