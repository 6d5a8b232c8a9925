"""On-disk FM-index bundle — the ``bwa index`` equivalent.

Bundle format (``INDEX_VERSION = 1``): two files sharing a prefix, the
way bwa hangs ``.bwt``/``.sa``/``.ann`` off the FASTA path.

* ``{prefix}.ri.json`` — human-readable metadata::

      {
        "format":  "repro-fm-index",
        "version": 1,                     # bumped on any layout change
        "n_ref":   ..., "N": ..., "primary": ...,
        "contigs": {"names": [...], "offsets": [...], "lengths": [...]}
                   | null                 # null = plain single-seq FMIndex
      }

* ``{prefix}.ri.npz`` — the numpy arrays (``np.savez_compressed``), one
  entry per name in ``core.fmindex.PERSIST_ARRAYS``: the packed sequence
  ``seq``, the UNCOMPRESSED suffix array ``sa`` (paper §4.5) plus the
  value-sampled ``sa_sampled``, the BWT bytes, cumulative counts ``C``
  and BOTH occupancy layouts (``occ32_*`` optimized, ``occ128_*``
  baseline) — i.e. everything the two pipeline variants need, exactly as
  built, so nothing is recomputed except derived caches.

``load_index(prefix)`` round-trips byte-identically to the in-memory
build: every persisted array is stored losslessly (dtype-preserving) and
the only reconstructed state — the host occ-prefix oracle and the lazy
device view — is rebuilt by the same code the builder uses
(``occ_prefix_from_bwt``; ``with_contigs`` re-derives ``edges``).
A version mismatch or foreign JSON fails loudly rather than
misinterpreting arrays.
"""

from __future__ import annotations

import json
import pathlib

import numpy as np

from ..core.contig import contig_table, with_contigs
from ..core.fmindex import (FMIndex, PERSIST_ARRAYS, PERSIST_SCALARS,
                            index_from_arrays)

INDEX_FORMAT = "repro-fm-index"
INDEX_VERSION = 1

JSON_SUFFIX = ".ri.json"
NPZ_SUFFIX = ".ri.npz"


def index_paths(prefix) -> tuple[pathlib.Path, pathlib.Path]:
    """(json_path, npz_path) of the bundle hung off ``prefix``."""
    prefix = str(prefix)
    return (pathlib.Path(prefix + JSON_SUFFIX),
            pathlib.Path(prefix + NPZ_SUFFIX))


def have_index(prefix) -> bool:
    """True iff both bundle files exist."""
    jp, np_ = index_paths(prefix)
    return jp.exists() and np_.exists()


def save_index(prefix, idx: FMIndex) -> tuple[pathlib.Path, pathlib.Path]:
    """Persist ``idx`` (FMIndex or ContigIndex) as the versioned bundle.

    Returns the (json_path, npz_path) written.
    """
    jp, npzp = index_paths(prefix)
    meta = {
        "format": INDEX_FORMAT,
        "version": INDEX_VERSION,
        **{k: int(getattr(idx, k)) for k in PERSIST_SCALARS},
        "contigs": contig_table(idx),
    }
    np.savez_compressed(npzp, **{k: getattr(idx, k) for k in PERSIST_ARRAYS})
    with open(jp, "w") as f:
        json.dump(meta, f, indent=1)
        f.write("\n")
    return jp, npzp


def load_index(prefix) -> FMIndex:
    """Load a bundle -> ``FMIndex`` (or ``ContigIndex`` when the metadata
    carries a contig table), byte-identical to the in-memory build."""
    jp, npzp = index_paths(prefix)
    if not have_index(prefix):
        raise FileNotFoundError(
            f"no index bundle at prefix {prefix!r} (expected {jp.name} + "
            f"{npzp.name}; run `python -m repro_torch.cli index <ref.fa>`)")
    with open(jp) as f:
        meta = json.load(f)
    if meta.get("format") != INDEX_FORMAT:
        raise ValueError(f"{jp}: not a {INDEX_FORMAT} bundle "
                         f"(format={meta.get('format')!r})")
    if meta.get("version") != INDEX_VERSION:
        raise ValueError(
            f"{jp}: index bundle version {meta.get('version')} != supported "
            f"{INDEX_VERSION}; re-run `python -m repro_torch.cli index`")
    with np.load(npzp) as z:
        missing = set(PERSIST_ARRAYS) - set(z.files)
        if missing:
            raise ValueError(f"{npzp}: bundle missing arrays {sorted(missing)}")
        arrays = {k: z[k] for k in PERSIST_ARRAYS}
    idx = index_from_arrays(arrays, meta)
    ct = meta.get("contigs")
    if ct is None:
        return idx
    return with_contigs(idx, ct["names"], ct["offsets"], ct["lengths"])
