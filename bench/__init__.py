"""The benchmark of the port (``repro_torch``): one command runs one cell
of ``BENCHMARK.json`` once (``python3 bench/run.py --workload ...``).

Everything a cell needs is found by name: its configuration in
``configs/<config>.json``, its traffic mix in ``traffic/<traffic>.json``,
each per-layer metric's reader in ``metrics/<metric>.py``.  The
yardstick (read simulator, index builder, kernel work counts, the plain
reference) lives in ``frozen/`` and ``reference/``.
"""
