"""Hand-written CUDA kernels of the port and their plain PyTorch versions.

* ``fmocc`` — one SMEM extension round (every Occ(c, i) lookup of it) in
  the eta32 and eta128 bucket layouts;
* ``bsw``   — banded Smith-Waterman seed extension (ksw_extend2);
* ``engine`` — the "cuda" engine: the occ-layout sweep and the SE driver.

The CUDA sources live in ``csrc/`` and are built at first use into one
shared library (``build.py``).  Each wrapper runs its plain PyTorch
version for a tensor on the CPU and launches its kernel for a tensor on
a CUDA device; any other device raises.
"""

from .bsw import ops as _bsw_ops
from .fmocc import ops as _fmocc_ops


def launch_counts() -> dict:
    """Kernel launches since the last ``reset_launch_counts``, by kernel."""
    return {**_fmocc_ops.LAUNCHES, **_bsw_ops.LAUNCHES}


def reset_launch_counts() -> None:
    for d in (_fmocc_ops.LAUNCHES, _bsw_ops.LAUNCHES):
        for k in d:
            d[k] = 0
