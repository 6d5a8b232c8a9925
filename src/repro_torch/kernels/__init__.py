"""Hand-written CUDA kernels of the port and their plain PyTorch versions.

* ``fmocc`` — one SMEM extension round (every Occ(c, i) lookup of it) in
  the eta32 and eta128 bucket layouts;
* ``bsw``   — banded Smith-Waterman seed extension (ksw_extend2);
* ``galign`` — finalize's banded global alignment with traceback (the
  score and CIGAR of every emitted region);
* ``diagseed`` — mate rescue's anchor search (the longest exact diagonal
  match of a mate in each rescue window);
* ``engine`` — the "cuda" engine: the occ-layout sweep and the SE and PE
  drivers with the configuration it picked.

The CUDA sources live in ``csrc/`` and are built at first use into one
shared library (``build.py``).  Each wrapper runs its plain PyTorch
version for a tensor on the CPU and launches its kernel for a tensor on
a CUDA device; any other device raises.
"""

from .build import LAUNCH_LOCK, LAUNCHES


def launch_counts() -> dict:
    """Kernel launches since the last ``reset_launch_counts``, by kernel."""
    with LAUNCH_LOCK:
        return dict(LAUNCHES)


def reset_launch_counts() -> None:
    with LAUNCH_LOCK:
        for k in LAUNCHES:
            LAUNCHES[k] = 0
