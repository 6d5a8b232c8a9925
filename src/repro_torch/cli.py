"""bwa-mem-shaped command line of the port, over its ``Aligner`` facade.

    python -m repro_torch.cli index ref.fa[.gz] [-p PREFIX]
    python -m repro_torch.cli mem  ref.fa reads_1.fq[.gz] [reads_2.fq[.gz]]
                                   [-o out.sam] [--interleaved]
                                   [--engine cuda|baseline]
                                   [--device cuda|cpu] [--batch-size B]
                                   [-K BASES] [--pe-bootstrap] [--no-pg]
                                   [--shard i/n] [--profile prof.json]
                                   [--trace trace.json] [--runlog run.jsonl]
                                   [--live PREFIX] [--live-interval SECS]
                                   [-k -w -r -c -A -B -O -E -L -d -T -U -a -Y]
                                   [-R '@RG\\tID:...']
    python -m repro_torch.cli memdist ref.fa reads_1.fq [reads_2.fq]
                                   [-o out.sam] [-n WORKERS] [-K BASES]
                                   [--device cuda|cpu] [--workdir DIR]
                                   [--max-retries N] [--runlog run.jsonl]
                                   [--no-pg] [...mem alignment flags]
    python -m repro_torch.cli serve ref.fa [--host H] [--port P]
                                   [--device cuda|cpu] [--max-batch-reads N]
                                   [--max-queue N] [--max-read-len BP]
                                   [--ready-file PATH] [--runlog run.jsonl]
                                   [--live PREFIX] [...mem alignment flags]
    python -m repro_torch.cli report prof.json              # one profile
    python -m repro_torch.cli report --merge 'shard*.json'  # cross-shard

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
the whole run.  ``--shard i/n`` keeps only every n-th read (pair), the
``repro_torch.dist`` worker partition (by default this process's
``torch.distributed`` rank, else everything).  Its SAM is
byte-identical to ``repro.cli mem --engine pallas`` on the same input.
``--engine baseline`` runs the original BWA-MEM organisation instead
(read by read, the scalar oracles, on the host whatever ``--device``
says): the same SAM, byte for byte, as ``--engine cuda`` and as
``repro.cli mem --engine baseline``.

``memdist`` is the resilient multi-shard form of ``mem``
(``repro_torch.dist.run``): the input is cut into ``-K`` fixed-base
chunks, contiguous chunk ranges run on a pool of worker threads over one
``Aligner`` with a checkpoint after every chunk (a crashed or straggling
shard is retried and RESUMES), the insert-size estimate is bootstrapped
once from the leading chunk, and the per-shard SAMs merge in shard order
— byte-identical to ``mem -K <same> --pe-bootstrap`` on the same input
(compare with ``--no-pg``).  Fault injection for drills:
``REPRO_FT_INJECT="shard:chunk[:fail|fatal]"``.  A workdir either
package leaves behind resumes under the other.

``serve`` is the persistent alignment server (``repro_torch.serve``):
the index is loaded once, queued client requests of one option cohort are
coalesced into full-width batches on ``--device``, and each request's
SAM comes back byte-identical to an offline ``mem`` of its reads.  It
speaks the reference's wire protocol, so ``repro.serve.ServeClient``
talks to it.  SIGINT drains the queued requests and exits 0.

``--profile out.json`` turns on telemetry and writes the paper-style
kernel-breakdown profile; ``--trace out.trace.json`` also collects
Chrome trace events.  A profiled run also writes a structured JSONL run
log (``--runlog``; manifest, per-batch progress, captured warnings,
crash bundle) and live metrics files rewritten atomically during the run
(``--live``; snapshot JSON + Prometheus textfile).  ``report``
pretty-prints one saved profile, or merges several per-shard profiles
into one breakdown plus a per-shard wall-time table with straggler
flags.  Profiles of either package merge.
"""

from __future__ import annotations

import argparse
import os
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
    return AlignOptions.from_flags(flags, device=args.device,
                                   engine=args.engine)


def _obs_paths(args) -> tuple:
    """Resolve the run-log path and live-export prefix.

    Explicit ``--runlog``/``--live`` win ('off' disables); otherwise a
    ``--profile prof.json`` run defaults to ``prof.runlog.jsonl`` +
    ``prof.live.{json,prom}``.
    """
    stem = os.path.splitext(args.profile)[0] if args.profile else None
    runlog = args.runlog
    if runlog is None and stem:
        runlog = f"{stem}.runlog.jsonl"
    live = args.live
    if live is None and stem:
        live = f"{stem}.live"
    off = ("off", "-")
    return (None if runlog in off else runlog,
            None if live in off else live)


def _aligner_options(args):
    """The AlignOptions of ``args``, on a device there is; None (the
    reason logged) when they cannot run."""
    from .api import resolve_device
    try:
        options = _options_from_args(args)
        resolve_device(options.device)
    except (ValueError, RuntimeError) as e:
        _log(f"error: {e}")
        return None
    return options


def cmd_mem(args, argv) -> int:
    from . import obs
    from .api import Aligner
    from .dist.api import read_shard
    from .io.stream import open_batches

    options = _aligner_options(args)
    if options is None:
        return 2
    shard = read_shard(args.shard)
    if shard != (0, 1):
        _log(f"streaming shard {shard[0]}/{shard[1]}")
    telemetry = None
    if args.profile or args.trace:
        telemetry = obs.Telemetry(trace=bool(args.trace))
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
                           interleaved=args.interleaved, shard=shard,
                           chunk_bases=args.chunk_bases)
    out = None if args.output in (None, "-") else args.output
    runlog_path, live_prefix = _obs_paths(args)
    runlog = exporter = None
    if runlog_path:
        runlog = obs.RunLog(runlog_path)
        runlog.manifest("repro_torch.cli mem", argv=argv,
                        engine=options.engine, options=options,
                        index=aligner.index,
                        shard=f"{shard[0]}/{shard[1]}",
                        reads1=args.reads1, reads2=args.reads2,
                        interleaved=args.interleaved,
                        batch_size=args.batch_size)
        _log(f"run {runlog.run_id}: logging events to {runlog_path}")
    if live_prefix:
        exporter = obs.LiveExporter(
            live_prefix, interval=args.live_interval,
            meta={"run": runlog.run_id if runlog else "",
                  "engine": options.engine,
                  "shard": f"{shard[0]}/{shard[1]}"})
        _log(f"live metrics at {exporter.json_path} + "
             f"{exporter.prom_path} (every {args.live_interval:g}s)")
    t0 = time.time()
    cl = None if args.no_pg else " ".join(["repro_torch.cli"] + list(argv))
    try:
        summary = aligner.stream_sam(batches, out, cl=cl,
                                     runlog=runlog, export=exporter)
    except BaseException:
        if runlog is not None:       # the crash bundle is already logged
            runlog.end(status="error")
            runlog.close()
        raise
    dt = max(time.time() - t0, 1e-9)
    _log(f"aligned {summary['n_reads']} reads "
         f"({summary['n_records']} SAM records, "
         f"{summary['n_batches']} batches, engine={aligner.options.engine}, "
         f"device={aligner.options.device}) "
         f"in {dt:.1f}s ({summary['n_reads'] / dt:.1f} reads/s)")
    if args.profile:
        meta = {"engine": aligner.options.engine,
                "device": aligner.options.device,
                "reads": summary["n_reads"],
                "batches": summary["n_batches"],
                "shard": f"{shard[0]}/{shard[1]}",
                "paired": paired}
        if runlog is not None:
            meta["run"] = runlog.run_id
        obs.write_profile(args.profile, summary["stats"], wall_s=dt,
                          meta=meta)
        _log(f"wrote profile {args.profile} "
             f"(render it with: repro_torch.cli report {args.profile})")
    if args.trace:
        telemetry.tracer.save(args.trace)
        _log(f"wrote {len(telemetry.tracer)} trace events to {args.trace} "
             f"(load in Perfetto / chrome://tracing)")
    if runlog is not None:
        runlog.end(status="ok", n_reads=summary["n_reads"],
                   n_records=summary["n_records"],
                   n_batches=summary["n_batches"], wall_s=round(dt, 6))
        runlog.close()
    return 0


def cmd_memdist(args, argv) -> int:
    from .api import Aligner
    from .dist.run import FatalShardFailure, JobAbandoned, run_job

    options = _aligner_options(args)
    if options is None:
        return 2
    out = None if args.output in (None, "-") else args.output
    workdir = args.workdir
    if workdir is None:
        if out is None:
            _log("error: memdist needs --workdir when writing to stdout")
            return 2
        workdir = str(out) + ".work"
    aligner = Aligner.from_index(_load_or_build(args.ref), options)
    runlog = None
    if args.runlog not in (None, "off", "-"):
        from . import obs
        runlog = obs.RunLog(args.runlog)
        runlog.manifest("repro_torch.cli memdist", argv=argv,
                        engine=options.engine, options=options,
                        index=aligner.index, reads1=args.reads1,
                        reads2=args.reads2, interleaved=args.interleaved,
                        workers=args.workers, chunk_bases=args.chunk_bases,
                        workdir=str(workdir))
        _log(f"run {runlog.run_id}: logging events to {args.runlog}")
    # the @PG CL records the decomposition, not this invocation's argv:
    # a resumed run (different argv) must produce identical bytes
    cl = None if args.no_pg else (
        f"repro_torch.cli memdist -K {args.chunk_bases} -n {args.workers}")
    t0 = time.time()
    try:
        summary = run_job(
            aligner, args.reads1, args.reads2, out, workdir=workdir,
            workers=args.workers, chunk_bases=args.chunk_bases,
            interleaved=args.interleaved, cl=cl,
            max_retries=args.max_retries,
            retry_backoff_s=args.retry_backoff,
            runlog=runlog, keep_workdir=args.keep_workdir)
    except JobAbandoned as e:
        _log(f"error: {e}")
        if runlog is not None:
            runlog.end(status="abandoned")
            runlog.close()
        return 1
    except FatalShardFailure as e:
        _log(f"fatal shard failure: {e}")
        _log(f"completed work is checkpointed under {workdir}; "
             f"rerun the same command to resume")
        if runlog is not None:
            runlog.end(status="fatal")
            runlog.close()
        return 3
    except BaseException:
        if runlog is not None:
            runlog.end(status="error")
            runlog.close()
        raise
    dt = max(time.time() - t0, 1e-9)
    retries = summary["retries"]
    _log(f"aligned {summary['n_reads']} reads across "
         f"{summary['n_shards']} shard(s) ({summary['n_chunks']} chunks, "
         f"{retries} retr{'y' if retries == 1 else 'ies'}"
         f", engine={options.engine}, device={options.device}) in "
         f"{dt:.1f}s ({summary['n_reads'] / dt:.1f} reads/s, merge "
         f"{summary['merge_s'] * 1e3:.0f}ms)")
    if runlog is not None:
        runlog.end(status="ok", n_reads=summary["n_reads"],
                   n_records=summary["n_records"],
                   retries=summary["retries"], wall_s=round(dt, 6))
        runlog.close()
    return 0


def cmd_serve(args, argv) -> int:
    from .serve import AlignmentServer

    options = _aligner_options(args)
    if options is None:
        return 2
    index = _load_or_build(args.ref)
    runlog = exporter = None
    if args.runlog not in (None, "off", "-"):
        from . import obs
        runlog = obs.RunLog(args.runlog)
        runlog.manifest("repro_torch.cli serve", argv=argv,
                        engine=options.engine, options=options, index=index)
        _log(f"run {runlog.run_id}: logging events to {args.runlog}")
    if args.live not in (None, "off", "-"):
        from . import obs
        exporter = obs.LiveExporter(
            args.live, interval=args.live_interval,
            meta={"run": runlog.run_id if runlog else "",
                  "engine": options.engine,
                  "source": "repro_torch.cli serve"})
        _log(f"live metrics at {exporter.json_path} + {exporter.prom_path} "
             f"(every {args.live_interval:g}s)")
    server = AlignmentServer(index, options,
                             host=args.host, port=args.port,
                             max_batch_reads=args.max_batch_reads,
                             max_queue=args.max_queue,
                             max_read_len=args.max_read_len,
                             runlog=runlog, exporter=exporter)
    host, port = server.start()
    _log(f"serving on {host}:{port} (engine={options.engine}, "
         f"device={server.options.device}, "
         f"max_batch_reads={args.max_batch_reads}, "
         f"max_queue={args.max_queue})")
    if args.ready_file:
        with open(args.ready_file, "w") as f:
            f.write(f"{host} {port}\n")
        _log(f"wrote address to {args.ready_file}")
    try:
        while True:
            time.sleep(3600)
    except KeyboardInterrupt:
        _log("shutting down (draining queued requests)")
    finally:
        server.shutdown(drain=True)
    return 0


def cmd_report(args, argv) -> int:
    import glob as _glob
    from . import obs
    paths: list[str] = []
    for pat in args.profiles:
        hits = sorted(_glob.glob(pat))
        # a non-matching glob falls through as a literal path so the
        # read error below names exactly what the user typed
        for p in (hits or [pat]):
            if p not in paths:
                paths.append(p)
    payloads = []
    for p in paths:
        try:
            payloads.append(obs.read_profile(p))
        except (OSError, ValueError, KeyError) as e:
            _log(f"error reading {p}: {e}")
            return 2
    if len(payloads) == 1 and not args.merge and not args.out:
        payload = payloads[0]
        print(obs.render(payload["snapshot"], wall_s=payload.get("wall_s"),
                         meta=payload.get("meta")))
        return 0
    merged = obs.merge_profiles(payloads, paths=paths)
    print(obs.render(merged["snapshot"], wall_s=merged["wall_s"],
                     meta=merged["meta"]))
    if len(payloads) > 1:
        print()
        print(obs.shard_wall_table(merged["shards"]))
    if args.out:
        obs.write_merged_profile(args.out, merged)
        _log(f"wrote merged profile {args.out} "
             f"({len(payloads)} part(s))")
    return 0


def _add_align_flags(p) -> None:
    """Flags shared by every aligning subcommand (mem, memdist, serve):
    engine and device selection, fixed-base chunking, @PG suppression,
    and the bwa alignment flags of ``repro_torch.options.BWA_FLAGS``."""
    p.add_argument("--engine", default="cuda", choices=("cuda", "baseline"),
                   help="cuda: the paper's organisation through the "
                        "kernels; baseline: the original BWA-MEM, read by "
                        "read through the scalar oracles on the host "
                        "[cuda]")
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
                        "(needs -K and paired input; memdist always does "
                        "this)")
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
    mm.add_argument("--shard", default=None, metavar="i/n",
                    help="stream only shard i of n (default: this "
                         "process's torch.distributed rank, else "
                         "everything)")
    _add_align_flags(mm)
    mm.add_argument("--profile", default=None, metavar="JSON",
                    help="enable telemetry and write the kernel-breakdown "
                         "profile here (render with `repro_torch.cli "
                         "report`)")
    mm.add_argument("--trace", default=None, metavar="JSON",
                    help="also collect Chrome trace events (Perfetto / "
                         "chrome://tracing) and write them here")
    mm.add_argument("--runlog", default=None, metavar="JSONL",
                    help="structured run-log path: one JSON event per "
                         "line (manifest, per-batch progress, warnings, "
                         "crash bundle). Defaults to <profile>.runlog"
                         ".jsonl when --profile is set; 'off' disables")
    mm.add_argument("--live", default=None, metavar="PREFIX",
                    help="live metrics export: atomically rewrite "
                         "PREFIX.json (snapshot) + PREFIX.prom "
                         "(Prometheus textfile) during the run. Defaults "
                         "to <profile-stem>.live when --profile is set; "
                         "'off' disables")
    mm.add_argument("--live-interval", type=float, default=1.0,
                    metavar="SECS",
                    help="live-export rewrite interval [1.0]")
    mm.set_defaults(fn=cmd_mem)

    md = sub.add_parser(
        "memdist",
        help="resilient multi-shard mem: checkpointed shard execution, "
             "auto-retry, deterministic SAM merge")
    md.add_argument("ref", help="index bundle prefix (or FASTA to build "
                                "in-memory)")
    md.add_argument("reads1", help="FASTQ (plain or .gz)")
    md.add_argument("reads2", nargs="?", default=None,
                    help="mate FASTQ for split paired-end input")
    md.add_argument("-o", "--output", default=None,
                    help="merged SAM path (default: stdout; byte-identical "
                         "to `mem -K ... --pe-bootstrap` on the same input)")
    md.add_argument("-p", "--interleaved", action="store_true",
                    help="reads1 is interleaved R1/R2 (bwa mem -p)")
    md.add_argument("-n", "--workers", type=int, default=3, metavar="N",
                    help="worker shards; output bytes do NOT depend on "
                         "this (fixed-base chunking) [3]")
    md.add_argument("--workdir", default=None, metavar="DIR",
                    help="durable job scratch (plan, per-shard SAMs + "
                         "checkpoints); rerunning with the same workdir "
                         "RESUMES [<output>.work]")
    md.add_argument("--max-retries", type=int, default=2, metavar="N",
                    help="per-shard retry cap before the job is "
                         "abandoned [2]")
    md.add_argument("--retry-backoff", type=float, default=0.05,
                    metavar="SECS",
                    help="base of the exponential retry backoff [0.05]")
    md.add_argument("--keep-workdir", action="store_true",
                    help="keep the workdir after a successful merge")
    md.add_argument("--runlog", default=None, metavar="JSONL",
                    help="structured run-log path (job_plan, shard_batch, "
                         "shard_retry/shard_abandoned, merge events); "
                         "'off' disables")
    _add_align_flags(md)
    md.set_defaults(fn=cmd_memdist, chunk_bases=100_000)

    sv = sub.add_parser(
        "serve",
        help="persistent alignment server: index loaded once, queued "
             "client requests coalesced into full-width engine batches "
             "(see repro_torch.serve)")
    sv.add_argument("ref", help="index bundle prefix (or FASTA to build "
                                "in-memory)")
    sv.add_argument("--host", default="127.0.0.1",
                    help="bind address [127.0.0.1]")
    sv.add_argument("--port", type=int, default=0,
                    help="TCP port; 0 picks a free one (printed, and "
                         "written to --ready-file) [0]")
    sv.add_argument("--max-batch-reads", type=int, default=512,
                    metavar="N",
                    help="read budget of one coalesced engine batch "
                         "(throughput knob: larger batches saturate the "
                         "kernels, at some per-request latency) [512]")
    sv.add_argument("--max-queue", type=int, default=64, metavar="N",
                    help="bounded request queue; a full queue returns "
                         "structured 'overloaded' errors (backpressure) "
                         "[64]")
    sv.add_argument("--max-read-len", type=int, default=4096,
                    metavar="BP",
                    help="reject reads above BP with 'read_too_long' "
                         "(one huge read would poison its cohort's "
                         "padding) [4096]")
    sv.add_argument("--ready-file", default=None, metavar="PATH",
                    help="write 'host port' here once listening (for "
                         "scripts that need the picked port)")
    sv.add_argument("--runlog", default=None, metavar="JSONL",
                    help="structured run-log path (request, "
                         "batch_coalesced, request_done/request_error "
                         "events); 'off' disables")
    sv.add_argument("--live", default=None, metavar="PREFIX",
                    help="live metrics export: atomically rewrite "
                         "PREFIX.json + PREFIX.prom (Prometheus "
                         "textfile) while serving; 'off' disables")
    sv.add_argument("--live-interval", type=float, default=1.0,
                    metavar="SECS",
                    help="live-export rewrite interval [1.0]")
    _add_align_flags(sv)
    sv.set_defaults(fn=cmd_serve)

    rp = sub.add_parser("report", help="pretty-print saved --profile "
                                       "JSON(s); multiple files (or globs) "
                                       "merge into one cross-shard report")
    rp.add_argument("profiles", nargs="+", metavar="profile",
                    help="profile JSON(s) written by mem --profile (of "
                         "either package); multiple paths or globs (e.g. "
                         "'shard*.json') are Snapshot-merged into one "
                         "breakdown plus a per-shard wall-time/straggler "
                         "table")
    rp.add_argument("--merge", action="store_true",
                    help="force merged rendering even for one file "
                         "(merging is automatic for several)")
    rp.add_argument("-o", "--out", default=None, metavar="JSON",
                    help="also write the merged profile (re-loadable by "
                         "report / read_profile) here")
    rp.set_defaults(fn=cmd_report)
    return ap


def main(argv: list[str] | None = None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    args = build_parser().parse_args(argv)
    return args.fn(args, argv)


if __name__ == "__main__":
    sys.exit(main())
