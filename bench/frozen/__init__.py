"""Frozen parts of the yardstick: genome and index bundle (``genome``),
the read simulator (``reads``) and the kernels' work counts (``work``)."""
