"""bwa-mem-shaped command line of the port, over its ``Aligner`` facade.

    python -m repro_torch.cli index ref.fa[.gz] [-p PREFIX]
    python -m repro_torch.cli mem  ref.fa reads_1.fq[.gz] [reads_2.fq[.gz]]
                                   [-o out.sam] [--interleaved]
                                   [--device cuda|cpu] [--batch-size B]
                                   [-K BASES] [--pe-bootstrap]
                                   [--no-pg] [--profile prof.json]
                                   [-k -w -r -c -A -B -O -E -L -d -T -U -a -Y]
                                   [-R '@RG\\tID:...']

``index`` ingests a (gzipped) multi-contig FASTA (IUPAC ambiguity ->
seeded random base, as bwa does), builds the concatenated-contig FM-index
and persists it as the bundle of ``io.store`` next to the FASTA — the
same bundle ``repro.cli index`` writes, so either loads in the other.

``mem`` aligns single-end reads, split R1/R2 pairs or interleaved pairs
(``-p``) on ``--device`` (default ``cuda``: the hand-written kernels on
the card; without a CUDA device it exits with an error rather than run
on the CPU; ``cpu`` runs their plain PyTorch versions).  ``-K`` cuts the
input into fixed-base chunks (bwa ``-K``); ``--pe-bootstrap`` estimates
the insert-size stats once, on the leading chunk, and freezes them for
the whole run.  Its SAM is byte-identical to ``repro.cli mem --engine
pallas`` on the same input.

``--profile out.json`` turns on telemetry and writes the paper-style
kernel-breakdown profile.
"""

from __future__ import annotations

import argparse
import sys
import time


def _log(msg: str) -> None:
    print(f"[repro_torch.cli] {msg}", file=sys.stderr, flush=True)


def _load_or_build(ref: str):
    """Index bundle at the FASTA prefix if present, else an in-memory
    build (one-off runs; `index` persists it for every run after)."""
    from .core.contig import build_contig_index
    from .io.fasta import load_reference
    from .io.store import have_index, load_index
    if have_index(ref):
        t0 = time.time()
        idx = load_index(ref)
        _log(f"loaded index bundle {ref}.ri.* "
             f"(N={int(idx.N)}) in {time.time() - t0:.1f}s")
        return idx
    _log(f"no index bundle at {ref!r}; building in-memory "
         f"(run `repro_torch.cli index {ref}` to persist it)")
    t0 = time.time()
    idx = build_contig_index(load_reference(ref))
    _log(f"built index (N={int(idx.N)}) in {time.time() - t0:.1f}s")
    return idx


def cmd_index(args, argv) -> int:
    from .core.contig import build_contig_index
    from .io.fasta import load_reference
    from .io.store import save_index
    t0 = time.time()
    seed_kw = {} if args.ambig_seed is None else {"seed": args.ambig_seed}
    contigs = load_reference(args.fasta, **seed_kw)
    total = sum(len(a) for _, a in contigs)
    _log(f"read {len(contigs)} contig(s), {total} bp from {args.fasta}")
    idx = build_contig_index(contigs)
    _log(f"built FM-index (N={int(idx.N)}) in {time.time() - t0:.1f}s")
    prefix = args.prefix or args.fasta
    jp, npzp = save_index(prefix, idx)
    _log(f"wrote {jp} + {npzp}")
    return 0


def _options_from_args(args):
    """Fold the bwa-flag namespace entries into one AlignOptions (the
    flag list is BWA_FLAGS itself)."""
    from .options import AlignOptions, BWA_FLAGS
    flags = {f: getattr(args, "read_group" if f == "-R" else f.lstrip("-"))
             for f in BWA_FLAGS}
    return AlignOptions.from_flags(flags, device=args.device)


def cmd_mem(args, argv) -> int:
    from .api import Aligner, resolve_device
    from .io.stream import open_batches

    try:
        options = _options_from_args(args)
        resolve_device(options.device)
    except (ValueError, RuntimeError) as e:
        _log(f"error: {e}")
        return 2
    telemetry = None
    if args.profile:
        from . import obs
        telemetry = obs.Telemetry()
    paired = args.reads2 is not None or args.interleaved
    if args.pe_bootstrap and (not paired or not args.chunk_bases):
        _log("error: --pe-bootstrap needs paired input and -K")
        return 2
    aligner = Aligner.from_index(_load_or_build(args.ref), options,
                                 telemetry=telemetry)
    if args.pe_bootstrap:
        lead = next(iter(open_batches(args.reads1, args.reads2,
                                      interleaved=args.interleaved,
                                      chunk_bases=args.chunk_bases,
                                      chunk_range=(0, 1))))
        aligner.pe_stats = aligner.estimate_pe_stats(lead)
        _log("froze insert-size stats from the leading chunk "
             "(--pe-bootstrap)")
    batches = open_batches(args.reads1, args.reads2,
                           batch_size=args.batch_size,
                           interleaved=args.interleaved,
                           chunk_bases=args.chunk_bases)
    out = None if args.output in (None, "-") else args.output
    t0 = time.time()
    cl = None if args.no_pg else " ".join(["repro_torch.cli"] + list(argv))
    summary = aligner.stream_sam(batches, out, cl=cl)
    dt = max(time.time() - t0, 1e-9)
    _log(f"aligned {summary['n_reads']} reads "
         f"({summary['n_records']} SAM records, "
         f"{summary['n_batches']} batches, engine={aligner.options.engine}, "
         f"device={aligner.options.device}) "
         f"in {dt:.1f}s ({summary['n_reads'] / dt:.1f} reads/s)")
    if args.profile:
        from . import obs
        meta = {"engine": aligner.options.engine,
                "device": aligner.options.device,
                "reads": summary["n_reads"],
                "batches": summary["n_batches"],
                "paired": paired}
        obs.write_profile(args.profile, summary["stats"], wall_s=dt,
                          meta=meta)
        _log(f"wrote profile {args.profile}")
    return 0


def _add_align_flags(p) -> None:
    """Device selection, fixed-base chunking, @PG suppression, and the bwa
    alignment flags of ``repro_torch.options.BWA_FLAGS``."""
    p.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                   help="cuda: the hand-written kernels on the card (an "
                        "error without one); cpu: their plain PyTorch "
                        "versions [cuda]")
    p.add_argument("-K", "--chunk-bases", type=int, default=None,
                   metavar="INT",
                   help="process INT input bases per chunk (bwa -K): "
                        "batch decomposition — and output — becomes "
                        "batch-size-invariant")
    p.add_argument("--pe-bootstrap", action="store_true",
                   help="estimate PE insert-size stats ONCE on the "
                        "leading chunk and freeze them for the whole run "
                        "(needs -K and paired input)")
    p.add_argument("--no-pg", action="store_true",
                   help="omit the @PG header line (whose CL differs per "
                        "invocation) — for byte-comparing runs")
    p.add_argument("-k", type=int, default=None, metavar="INT",
                   help="minimum seed length [19]")
    p.add_argument("-w", type=int, default=None, metavar="INT",
                   help="band width [100]")
    p.add_argument("-r", type=float, default=None, metavar="FLOAT",
                   help="reseed trigger: split SMEMs longer than "
                        "FLOAT*k [1.5]")
    p.add_argument("-c", type=int, default=None, metavar="INT",
                   help="skip seeds with more than INT occurrences [500]")
    p.add_argument("-A", type=int, default=None, metavar="INT",
                   help="match score [1]")
    p.add_argument("-B", type=int, default=None, metavar="INT",
                   help="mismatch penalty [4]")
    p.add_argument("-O", default=None, metavar="INT[,INT]",
                   help="gap open penalty (deletion,insertion) [6,6]")
    p.add_argument("-E", default=None, metavar="INT[,INT]",
                   help="gap extension penalty [1,1]")
    p.add_argument("-L", default=None, metavar="INT[,INT]",
                   help="5'- and 3'-end clipping penalty [5,5]")
    p.add_argument("-d", type=int, default=None, metavar="INT",
                   help="Z-drop [100]")
    p.add_argument("-T", type=int, default=None, metavar="INT",
                   help="minimum output alignment score [30]")
    p.add_argument("-U", type=int, default=None, metavar="INT",
                   help="unpaired read-pair penalty [17]")
    p.add_argument("-a", action="store_true", default=None,
                   help="output all alignments for SE reads (secondary "
                        "0x100 records; MAPQ 0)")
    p.add_argument("-Y", action="store_true", default=None,
                   help="use soft clipping for supplementary alignments "
                        "(default: hard clipping)")
    p.add_argument("-R", "--read-group", default=None, metavar="STR",
                   help=r"read group header line, e.g. '@RG\tID:sample' "
                        "(emits the @RG header and an RG:Z: tag on every "
                        "record)")


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="repro_torch.cli",
        description="bwa-mem-shaped front-end of the PyTorch/CUDA port")
    sub = ap.add_subparsers(dest="cmd", required=True)

    ix = sub.add_parser("index", help="build + persist the FM-index bundle")
    ix.add_argument("fasta", help="reference FASTA (plain or .gz)")
    ix.add_argument("-p", "--prefix", default=None,
                    help="bundle prefix (default: the FASTA path)")
    ix.add_argument("--ambig-seed", type=int, default=None,
                    help="RNG seed for IUPAC-ambiguity replacement "
                         "(default: io.fasta.REFERENCE_AMBIG_SEED, 11 — "
                         "bwa's srand48 seed)")
    ix.set_defaults(fn=cmd_index)

    mm = sub.add_parser("mem", help="align FASTQ reads, emit SAM")
    mm.add_argument("ref", help="index bundle prefix (or FASTA to build "
                                "in-memory)")
    mm.add_argument("reads1", help="FASTQ (plain or .gz)")
    mm.add_argument("reads2", nargs="?", default=None,
                    help="mate FASTQ for split paired-end input")
    mm.add_argument("-o", "--output", default=None,
                    help="output SAM path (default: stdout)")
    mm.add_argument("-b", "--batch-size", type=int, default=512,
                    help="reads (pairs) per pipeline batch; PE insert-size "
                         "stats are per-batch, as in bwa (default 512)")
    mm.add_argument("-p", "--interleaved", action="store_true",
                    help="reads1 is interleaved R1/R2 (bwa mem -p)")
    _add_align_flags(mm)
    mm.add_argument("--profile", default=None, metavar="JSON",
                    help="enable telemetry and write the kernel-breakdown "
                         "profile here")
    mm.set_defaults(fn=cmd_mem)
    return ap


def main(argv: list[str] | None = None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    args = build_parser().parse_args(argv)
    return args.fn(args, argv)


if __name__ == "__main__":
    sys.exit(main())
