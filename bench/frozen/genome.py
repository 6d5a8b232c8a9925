"""The synthetic genome of a configuration and its index bundle.

The genome is made from the configuration's seed at its published contig
lengths: uniform random bases with planted repeats (``repeat_frac`` of
each contig re-pasted from earlier segments of ``repeat_len`` bases at
about 1% divergence), as ``repro_torch.data.make_reference`` makes them.

The bundle is the port's on-disk format (``<prefix>.ri.json`` +
``<prefix>.ri.npz``, format ``repro-fm-index`` version 1), built by
``index_build`` (prefix doubling in torch, on the card when there is
one; byte for byte the reference's ``build_contig_index``) in a process
of its own, and written uncompressed.  It is cached under
``build/bench/index/`` of the checkout, at a fixed path named by a hash
of the genome's parameters and of the builder's sources, so that only
the first run of a checkout builds it.
"""

from __future__ import annotations

import hashlib
import json
import os
import pathlib
import shutil
import subprocess
import sys

import numpy as np

BUILDER = ("reference/bwa_mem/fmindex.py", "reference/bwa_mem/contig.py",
           "frozen/genome.py", "frozen/index_build.py")


def make_contig(rng, n: int, repeat_frac: float, repeat_len: int
                ) -> np.ndarray:
    """(n,) uint8 codes 0..3 with planted repeats (a copy of
    ``repro_torch.data.make_reference`` drawing from ``rng``)."""
    ref = rng.integers(0, 4, size=n, dtype=np.uint8)
    for _ in range(int(n * repeat_frac / repeat_len)):
        if n <= 2 * repeat_len:
            break
        src = int(rng.integers(0, n - repeat_len))
        dst = int(rng.integers(0, n - repeat_len))
        seg = ref[src:src + repeat_len].copy()
        mut = rng.random(repeat_len) < 0.01
        seg[mut] = rng.integers(0, 4, size=int(mut.sum()), dtype=np.uint8)
        ref[dst:dst + repeat_len] = seg
    return ref


def make_genome(genome: dict) -> list[tuple[str, np.ndarray]]:
    """The configuration's ``genome`` section -> [(contig name, codes)]."""
    rng = np.random.default_rng(int(genome["seed"]))
    return [(name, make_contig(rng, int(n), float(genome["repeat_frac"]),
                               int(genome["repeat_len"])))
            for name, n in genome["contigs"]]


def bundle_key(genome: dict) -> str:
    h = hashlib.sha256(json.dumps(genome, sort_keys=True).encode())
    here = pathlib.Path(__file__).resolve().parents[1]
    for rel in BUILDER:
        h.update((here / rel).read_bytes())
    return h.hexdigest()[:16]


def write_bundle(prefix: pathlib.Path, idx) -> None:
    """The port's bundle format, written uncompressed (``np.savez``)."""
    from ..reference.bwa_mem.contig import contig_table
    from ..reference.bwa_mem.fmindex import PERSIST_ARRAYS, PERSIST_SCALARS
    meta = {"format": "repro-fm-index", "version": 1,
            **{k: int(getattr(idx, k)) for k in PERSIST_SCALARS},
            "contigs": contig_table(idx)}
    np.savez(str(prefix) + ".ri.npz",
             **{k: getattr(idx, k) for k in PERSIST_ARRAYS})
    with open(str(prefix) + ".ri.json", "w") as f:
        json.dump(meta, f, indent=1)
        f.write("\n")


def bundle(genome: dict, cache: pathlib.Path) -> pathlib.Path:
    """The bundle prefix of ``genome``, built into ``cache`` if absent.

    The build runs in a child process, so that neither the caller's
    device peak (``max_memory_allocated``) nor its ``ru_maxrss`` counts
    it, and its host and device memory are gone before the caller loads
    the bundle."""
    final = cache / bundle_key(genome)
    prefix = final / "ref"
    if (final / "ref.ri.json").exists():
        return prefix
    work = cache / (final.name + ".partial")
    shutil.rmtree(work, ignore_errors=True)
    work.mkdir(parents=True)
    subprocess.run([sys.executable, "-m", "bench.frozen.index_build",
                    json.dumps(genome), str(work / "ref")],
                   cwd=pathlib.Path(__file__).resolve().parents[2],
                   stdin=subprocess.DEVNULL, check=True)
    os.replace(work, final)
    return prefix
