"""The plain reference of the mapper: BWA-MEM with bwa's defaults, in
plain NumPy and PyTorch.

A frozen copy of the port's stage-major host pipeline (SMEM lockstep
loop, SAL, chaining, the BSW executor with bwa's decision replay,
finalize, the paired-end tail of insert-size estimation, mate rescue and
pairing) with the three kernels replaced by their plain PyTorch versions
(``kernels``).  Copied from ``src/repro_torch/core``, ``pe``,
``options.py`` and ``kernels/*/ref.py``; the port's CPU tests hold those
sources byte-identical to the JAX package's SAM, and this copy stays as
it is whatever the port becomes.  It imports nothing of the port.

It reads the benchmark's index bundle itself and derives its own device
view; it is handed the same reads as the program and returns SAM lines.
"""

from __future__ import annotations

import json
import pathlib

import numpy as np
import torch

from .contig import sam_header as _sam_header, with_contigs
from .fmindex import PERSIST_ARRAYS, PERSIST_SCALARS, FMIndex
from .options import AlignOptions
from .pipeline import run_pe_batched, run_se_batched
from .sam import format_sam

#: BSW tasks a block of the plain version (the result of a task does not
#: depend on its block; large blocks keep the row steps few)
REF_BSW_BLOCK = 8192


def load_index(prefix) -> FMIndex:
    """The index bundle at ``prefix`` (``.ri.json`` + ``.ri.npz``), read
    with NumPy; the host occ oracle is not built (no stage here reads
    it)."""
    prefix = str(prefix)
    with open(prefix + ".ri.json") as f:
        meta = json.load(f)
    with np.load(pathlib.Path(prefix + ".ri.npz")) as z:
        arrays = {k: z[k] for k in PERSIST_ARRAYS}
    idx = FMIndex(**{k: int(meta[k]) for k in PERSIST_SCALARS}, **arrays)
    ct = meta["contigs"]
    return with_contigs(idx, ct["names"], ct["offsets"], ct["lengths"])


def options(flags: dict, device, *, control: bool = False) -> AlignOptions:
    """bwa flags -> options on ``device``; ``control`` drops the BSW's
    end-to-end score (the control of the comparison)."""
    return AlignOptions.from_flags(flags, device=str(torch.device(device)),
                                   bsw_block=REF_BSW_BLOCK,
                                   local_only=control)


def sam_header(idx) -> list[str]:
    return _sam_header(idx)


def align_se(idx, reads: np.ndarray, names: list, flags: dict, device, *,
             control: bool = False) -> list[str]:
    """SAM lines of the single-end reads (R, L) uint8 codes, in order."""
    opt = options(flags, device, control=control)
    results, _ = run_se_batched(idx, reads, opt.pipeline_options())
    lines = []
    for name, read, alns in zip(names, reads, results):
        lines.extend([format_sam(name, read, a, idx) for a in alns]
                     if alns else [format_sam(name, read, None, idx)])
    return lines


def align_pe(idx, reads1: np.ndarray, reads2: np.ndarray, names: list,
             flags: dict, device, *, control: bool = False) -> list[str]:
    """SAM lines of the pairs, both ends, in order; the insert-size
    stats are estimated on these pairs (one ``-K`` chunk)."""
    opt = options(flags, device, control=control)
    lines, _ = run_pe_batched(idx, reads1, reads2, opt.pipeline_options(),
                              opt.pe_options(), names=list(names))
    return lines
