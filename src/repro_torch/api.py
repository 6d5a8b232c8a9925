"""The mapper API of the port: one ``Aligner`` facade over pluggable engines.

The counterpart of ``repro.api``::

    from repro_torch.api import Aligner, AlignOptions

    al = Aligner.from_fasta("ref.fa")            # or .from_bundle/.from_index
    result = al.align(batch)                     # BatchResult
    pairs = al.align_pairs(batch1, batch2)
    al.stream_sam(open_batches("r_1.fq", "r_2.fq"), "out.sam")

* Device: ``device="cuda"`` (the default, from ``AlignOptions.device``)
  runs SMEM, SAL and BSW on the card through the hand-written kernels.
  Without a CUDA device the constructor raises ``RuntimeError``; it never
  carries on on the CPU.  ``device="cpu"`` runs the kernels' plain
  PyTorch versions — what the tests use.
* Engines: ``AlignOptions.engine`` selects a driver pair through a
  registry (``register_engine``).  An engine is two callables with the
  driver signatures of ``repro_torch.core.pipeline`` (SE) and
  ``repro_torch.pe`` (PE):

      se(idx, reads, PipelineOptions)                  -> (results, stats)
      pe(idx, r1, r2, PipelineOptions, PEOptions, names) -> (lines, stats)

  "cuda" (the default) is the paper's organisation through the CUDA
  kernels; "baseline" is the original BWA-MEM organisation (read by
  read, the scalar oracles), which runs on the host whatever the device
  and launches no kernel: the yardstick of the paper's speedups.  An
  engine is chosen by name only; none stands in for another.
* Results: a structured ``BatchResult`` (SAM body + per-stage stats +
  names + lens + parsed ``AlignmentRecord`` views).

``Aligner.align`` honors per-read true lengths: a length-padded
``ReadBatch`` is regrouped by true length and each group is aligned at
its own width, so pad bases never reach the kernels.
"""

from __future__ import annotations

import contextlib
import dataclasses
import sys
import threading
import time
from typing import Callable, Iterable

import numpy as np
import torch

from . import obs
from .core.contig import sam_header as _contig_header
from .core.pipeline import run_se_baseline
from .core.sam import format_sam
from .kernels.engine import run_pe_cuda, run_se_cuda
from .options import AlignOptions, parse_read_group
from .pe import run_pe_baseline

VERSION = "0.2.0"                 # keep in sync with pyproject.toml

__all__ = ["Aligner", "AlignOptions", "AlignmentRecord", "BatchResult",
           "Engine", "engines", "get_engine", "register_engine",
           "resolve_device", "VERSION"]


# ---------------------------------------------------------------------
# Engine registry
# ---------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class Engine:
    """A pluggable driver pair (see module docstring for signatures)."""
    name: str
    se: Callable
    pe: Callable | None = None


_ENGINES: dict[str, Engine] = {}


def register_engine(name: str, se: Callable, pe: Callable | None = None,
                    *, replace: bool = False) -> Engine:
    """Register a driver pair under ``name`` (usable as
    ``AlignOptions(engine=name)``).  Registering an existing name raises
    unless ``replace=True``."""
    if name in _ENGINES and not replace:
        raise ValueError(f"engine {name!r} already registered "
                         f"(pass replace=True to shadow it)")
    eng = Engine(name, se, pe)
    _ENGINES[name] = eng
    return eng


def get_engine(name: str) -> Engine:
    try:
        return _ENGINES[name]
    except KeyError:
        raise ValueError(f"unknown engine {name!r} "
                         f"(registered: {', '.join(sorted(_ENGINES))})")


def engines() -> list[str]:
    """Names of all registered engines."""
    return sorted(_ENGINES)


# the original organisation, read by read through the scalar oracles on
# the host; byte-identical to the reference's "baseline" engine (tested)
register_engine("baseline", run_se_baseline, run_pe_baseline)
# the stage-major pipeline with its hot kernels (SMEM occ lookups, BSW
# blocks, PE mate-rescue blocks) through the CUDA kernels; byte-identical
# to the reference's "batched" and "pallas" engines (tested on the CPU
# path)
register_engine("cuda", run_se_cuda, run_pe_cuda)


def resolve_device(device) -> torch.device:
    """``device`` as a torch.device the pipeline can run on: a CUDA
    device that exists, or the CPU.  Raises RuntimeError when CUDA is
    asked for and there is none — the port never falls back to the CPU."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"device {str(device)!r} asked for, but no CUDA device is "
                f"available (pass device='cpu' to run the plain PyTorch "
                f"versions of the kernels)")
        if dev.index is not None and dev.index >= torch.cuda.device_count():
            raise RuntimeError(f"no CUDA device {dev.index}")
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {str(device)!r} "
                         f"(use 'cuda[:n]' or 'cpu')")
    return dev


# ---------------------------------------------------------------------
# Structured results
# ---------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class AlignmentRecord:
    """One SAM record, parsed into typed fields (POS is 0-based here;
    the SAM text keeps its 1-based convention).  Unmapped placeholder
    records (SAM POS 0) therefore carry the sentinel ``pos == -1`` —
    check ``is_unmapped`` before using ``pos``/``pnext``."""
    qname: str
    flag: int
    rname: str
    pos: int
    mapq: int
    cigar: str
    rnext: str
    pnext: int
    tlen: int
    tags: dict

    @property
    def is_unmapped(self) -> bool:
        return bool(self.flag & 0x4)

    @property
    def is_rev(self) -> bool:
        return bool(self.flag & 0x10)

    @property
    def is_secondary(self) -> bool:
        return bool(self.flag & 0x100)

    @property
    def is_paired(self) -> bool:
        return bool(self.flag & 0x1)

    @property
    def is_proper(self) -> bool:
        return bool(self.flag & 0x2)

    @property
    def score(self) -> int | None:
        v = self.tags.get("AS")
        return None if v is None else int(v)

    @property
    def nm(self) -> int | None:
        v = self.tags.get("NM")
        return None if v is None else int(v)

    @property
    def read_group(self) -> str | None:
        return self.tags.get("RG")

    @classmethod
    def from_sam(cls, line: str) -> "AlignmentRecord":
        f = line.rstrip("\n").split("\t")
        tags = {}
        for t in f[11:]:
            tag, _typ, val = t.split(":", 2)
            tags[tag] = val
        return cls(qname=f[0], flag=int(f[1]), rname=f[2], pos=int(f[3]) - 1,
                   mapq=int(f[4]), cigar=f[5], rnext=f[6],
                   pnext=int(f[7]) - 1, tlen=int(f[8]), tags=tags)


@dataclasses.dataclass
class BatchResult:
    """Everything one ``align`` call produced.

    ``alignments`` holds the raw per-read ``Alignment`` lists;
    ``sam()`` / ``records()`` are the emitted records.
    """
    names: list
    lens: np.ndarray                  # (B,) SE; (2, B) PE
    stats: dict
    paired: bool
    alignments: list | None = None
    _sam_body: list = dataclasses.field(default_factory=list, repr=False)
    _records: list | None = dataclasses.field(default=None, repr=False)

    def __len__(self) -> int:
        return len(self.names)

    def sam(self) -> list[str]:
        """SAM body lines (headerless; see ``Aligner.sam_header``)."""
        return list(self._sam_body)

    def records(self) -> list[AlignmentRecord]:
        """Parsed views of the SAM body (parsed once, then cached —
        treat the returned list as read-only)."""
        if self._records is None:
            self._records = [AlignmentRecord.from_sam(ln)
                             for ln in self._sam_body]
        return self._records

    @property
    def n_records(self) -> int:
        return len(self._sam_body)

    @property
    def n_mapped(self) -> int:
        return sum(1 for r in self.records()
                   if not r.is_unmapped and not r.is_secondary)


# ---------------------------------------------------------------------
# Batch coercion helpers
# ---------------------------------------------------------------------

def _coerce_se(batch, names, lens):
    """Accept a ReadBatch, a (B, L) uint8 array, or a list of read
    strings; return (reads, names, lens) with lens always materialised."""
    if hasattr(batch, "reads") and hasattr(batch, "names"):
        reads = batch.reads
        names = list(batch.names) if names is None else list(names)
        lens = batch.lens if lens is None else lens
    elif isinstance(batch, (list, tuple)) and batch and \
            isinstance(batch[0], str):
        from .io.stream import pack_reads
        reads, packed_lens = pack_reads(list(batch))
        lens = packed_lens if lens is None else lens
    else:
        reads = np.asarray(batch)
    if reads.ndim != 2:
        raise ValueError(f"expected a (B, L) read batch, got shape "
                         f"{reads.shape}")
    B = len(reads)
    if names is None:
        names = [f"read{r}" for r in range(B)]
    lens = (np.full(B, reads.shape[1], np.int64) if lens is None
            else np.asarray(lens, dtype=np.int64))
    if len(names) != B or len(lens) != B:
        raise ValueError("names/lens length mismatch with the batch")
    if B and int(lens.max()) > reads.shape[1]:
        raise ValueError(f"lens (max {int(lens.max())}) exceed the batch "
                         f"width {reads.shape[1]}")
    return reads, list(names), lens


def _coerce_pe(batch1, batch2, names):
    if hasattr(batch1, "reads1") and hasattr(batch1, "reads2"):
        if batch2 is not None:
            raise ValueError("pass a PairBatch alone, or two read arrays")
        r1, r2 = batch1.reads1, batch1.reads2
        names = list(batch1.names) if names is None else list(names)
        lens = np.stack([batch1.lens1, batch1.lens2])
    else:
        if batch2 is None:
            raise ValueError("align_pairs needs a PairBatch or both ends")
        r1, r2 = np.asarray(batch1), np.asarray(batch2)
        B = len(r1)
        lens = np.stack([np.full(B, r1.shape[1], np.int64),
                         np.full(B, r2.shape[1], np.int64)])
    if r1.shape[1] != r2.shape[1]:
        raise ValueError("paired ends must share one padded width "
                         "(io.stream.stream_pair_batches guarantees this)")
    if names is None:
        names = [f"pair{p}" for p in range(len(r1))]
    if len(names) != len(r1) or len(r1) != len(r2):
        raise ValueError("names/ends length mismatch")
    return r1, r2, list(names), lens


# ---------------------------------------------------------------------
# The facade
# ---------------------------------------------------------------------

class Aligner:
    """One mapper object: an FM-index + one ``AlignOptions``.

    Construct via ``from_fasta`` (build in memory), ``from_bundle``
    (load a persisted index bundle) or ``from_index``
    (wrap an existing FMIndex/ContigIndex).

    ``device`` overrides ``options.device`` ("cuda" by default; see
    ``resolve_device``).

    ``telemetry`` opts into pipeline observability (``repro_torch.obs``):
    ``True`` for stage timers/counters, or a configured
    ``obs.Telemetry(trace=True)`` to additionally collect Chrome trace
    events for the whole run.  Off (``None``) by default — the
    instrumented hot path then costs one thread-local read per stage.

    ``pe_stats`` freezes the insert-size stats (``PairStat[4]``, e.g. from
    ``estimate_pe_stats``) that ``align_pairs`` uses instead of per-batch
    estimation.
    """

    def __init__(self, index, options: AlignOptions | None = None, *,
                 device=None,
                 telemetry: "obs.Telemetry | bool | None" = None,
                 pe_stats=None):
        self.index = index
        options = options or AlignOptions()
        dev = resolve_device(options.device if device is None else device)
        self.options = options.replace(device=str(dev))
        get_engine(self.options.engine)        # fail fast on a bad name
        if telemetry is True:
            telemetry = obs.Telemetry()
        elif telemetry is False:
            telemetry = None
        self.telemetry: obs.Telemetry | None = telemetry
        self.pe_stats = None if pe_stats is None else list(pe_stats)
        self._rg: tuple[str, str] | None = None
        if self.options.read_group:
            self._rg = parse_read_group(self.options.read_group)

    # -- constructors --

    @classmethod
    def from_index(cls, index, options: AlignOptions | None = None,
                   **kw) -> "Aligner":
        return cls(index, options, **kw)

    @classmethod
    def from_fasta(cls, path, options: AlignOptions | None = None,
                   device=None, telemetry=None, **load_kw) -> "Aligner":
        """Build the FM-index in memory from a (gzipped) FASTA."""
        from .core.contig import build_contig_index
        from .io.fasta import load_reference
        return cls(build_contig_index(load_reference(path, **load_kw)),
                   options, device=device, telemetry=telemetry)

    @classmethod
    def from_bundle(cls, prefix, options: AlignOptions | None = None,
                    **kw) -> "Aligner":
        """Load a persisted index bundle (``repro_torch.cli index`` or
        ``repro.cli index`` output)."""
        from .io.store import load_index
        return cls(load_index(prefix), options, **kw)

    # -- internals --

    def _engine(self, override: str | None) -> Engine:
        return get_engine(override or self.options.engine)

    @contextlib.contextmanager
    def _scope(self):
        """Ambient telemetry scope for one facade call: a FRESH registry
        (so the captured numbers are per-call and merge associatively
        across batches/shards), sharing the run-long trace collector.
        Yields the registry, or None when telemetry is off."""
        if self.telemetry is None:
            yield None
            return
        reg = obs.MetricsRegistry()
        with self.telemetry.activate(reg):
            yield reg

    def _tag(self, lines: list[str]) -> list[str]:
        if self._rg is None:
            return lines
        rg = f"\tRG:Z:{self._rg[1]}"
        return [ln + rg for ln in lines]

    def _read_lines(self, name, read, alns) -> list[str]:
        if not alns:
            return [format_sam(name, read, None, self.index)]
        return [format_sam(name, read, a, self.index) for a in alns]

    # -- alignment --

    def align(self, batch, *, names=None, lens=None,
              engine: str | None = None) -> BatchResult:
        """Single-end alignment of one batch -> ``BatchResult``.

        ``batch`` is a ``repro_torch.io.stream.ReadBatch``, a (B, L) uint8
        array, or a list of read strings.  Per-read true lengths are
        honored: reads are regrouped by length and each group runs at its
        own width, so the pad bases of a length-padded batch are masked
        rather than fed to the kernels.
        """
        reads, names, lens = _coerce_se(batch, names, lens)
        eng = self._engine(engine)
        popt = self.options.pipeline_options()
        B = len(reads)
        stats = obs.Snapshot()
        groups = np.unique(lens)
        with self._scope() as reg:
            if len(groups) == 1 and int(groups[0]) == reads.shape[1]:
                # uniform full-width batch (the streaming case): no copy
                results, st = eng.se(self.index, reads, popt)
                stats.merge_in(st)
                body = [self._read_lines(names[r], reads[r], results[r])
                        for r in range(B)]
            else:
                results = [None] * B
                body = [None] * B
                for L in groups:
                    rows = np.nonzero(lens == L)[0]
                    sub = reads[rows][:, :int(L)]
                    res, st = eng.se(self.index, sub, popt)
                    stats.merge_in(st)
                    for row, alns in zip(rows, res):
                        results[row] = alns
                        body[row] = self._read_lines(names[row],
                                                     reads[row][:int(L)],
                                                     alns)
        if reg is not None:
            stats.merge_in(reg.snapshot())
        # a Gauge merges by MAX: summing group counts across batches would
        # be meaningless, the worst per-batch count is the useful summary
        stats["n_length_groups"] = obs.Gauge(len(groups))
        flat = self._tag([ln for rl in body for ln in rl])
        return BatchResult(names=names, lens=lens, stats=stats,
                           paired=False, alignments=results, _sam_body=flat)

    def align_pairs(self, batch1, batch2=None, *, names=None,
                    engine: str | None = None) -> BatchResult:
        """Paired-end alignment -> ``BatchResult`` whose records carry
        mate fields, proper-pair flags and the pair-aware MAPQ blend.

        ``batch1`` is a ``PairBatch`` (alone) or end-1 reads with
        ``batch2`` as end-2.  Unlike :meth:`align`, per-read lens are
        recorded on the result but NOT masked: pair batches run at one
        padded width, because regrouping pairs by length would change the
        per-batch insert-size estimates.
        """
        r1, r2, names, lens = _coerce_pe(batch1, batch2, names)
        eng = self._engine(engine)
        if eng.pe is None:
            raise ValueError(f"engine {eng.name!r} has no paired-end driver")
        peopt = self.options.pe_options()
        if self.pe_stats is not None:
            peopt = dataclasses.replace(peopt,
                                        frozen_pes=tuple(self.pe_stats))
        with self._scope() as reg:
            lines, st = eng.pe(self.index, r1, r2,
                               self.options.pipeline_options(),
                               peopt, names)
        stats = obs.Snapshot(st)
        if reg is not None:
            stats.merge_in(reg.snapshot())
        return BatchResult(names=names, lens=lens, stats=stats,
                           paired=True, alignments=None,
                           _sam_body=self._tag(lines))

    def estimate_pe_stats(self, batch1, batch2=None, *,
                          engine: str | None = None) -> list:
        """Bootstrap insert-size stats from one leading pair batch.

        SE-aligns both ends and runs the exact ``mem_pestat`` estimator
        the PE driver uses, so freezing the result (``self.pe_stats`` /
        ``PEOptions.frozen_pes``) reproduces byte-for-byte what a plain
        ``align_pairs`` of that same batch would have estimated.  This is
        how ``repro_torch.dist.run`` gives every shard one shared estimate.

        Returns ``PairStat[4]`` (does NOT mutate ``self.pe_stats``).
        """
        from .pe import estimate_pestat
        r1, r2, _names, _lens = _coerce_pe(batch1, batch2, None)
        eng = self._engine(engine)
        popt = self.options.pipeline_options()
        n = len(r1)
        both = np.concatenate([r1, r2], axis=0)
        with self._scope():
            res, _ = eng.se(self.index, both, popt)
        return estimate_pestat(res[:n], res[n:], self.index,
                               max_ins=self.options.pe_options().max_ins)

    # -- SAM emission --

    def sam_header(self, cl: str | None = None) -> list[str]:
        """``@SQ`` lines (+ ``@RG`` when configured, + ``@PG`` when a
        command line is given)."""
        extra = []
        if self._rg is not None:
            extra.append(self._rg[0])
        if cl is not None:
            extra.append(f"@PG\tID:repro\tPN:repro_torch\tVN:{VERSION}"
                         f"\tCL:{cl}")
        return _contig_header(self.index, extra=extra)

    def _trace_tail(self) -> list | None:
        """Last trace events (for a crash bundle), if tracing is on."""
        if self.telemetry is None or self.telemetry.tracer is None:
            return None
        return self.telemetry.tracer.to_dict()["traceEvents"][-32:]

    def stream_sam(self, batches: Iterable, out=None, *, header: bool = True,
                   cl: str | None = None, engine: str | None = None,
                   runlog: "obs.RunLog | None" = None,
                   export: "obs.LiveExporter | None" = None,
                   total_reads: int | None = None) -> dict:
        """Drive an iterable of ``ReadBatch``/``PairBatch`` (e.g. from
        ``repro_torch.io.stream.open_batches``) through the engine and
        write SAM to ``out`` (a path, a file object, or None for stdout).

        Returns a summary: n_reads/n_records/n_batches plus the merged
        per-stage stats (an ``obs.Snapshot``).  With telemetry enabled the
        summary also carries the run-level I/O accounting (``time_io_s``,
        batch fill/pad-waste) captured around the batch iterator pulls;
        with tracing, the garbage collector's ``time_gc_s``,
        ``gc_collections`` and ``gc_full`` over the stream.

        Run-scoped observability (all optional, none touches the SAM
        bytes):

        * ``runlog`` — an ``obs.RunLog``: the call emits
          ``stream_start``, one ``batch`` progress event per batch
          (reads/s, ETA when ``total_reads`` is given), captures any
          Python warnings raised while streaming as structured events,
          emits a ``crash`` diagnostic bundle (partial stats Snapshot,
          last-batch context, trace tail) if the loop dies, and
          ``stream_end`` on success.
        * ``export`` — an ``obs.LiveExporter``: started on a live
          thread-safe view of the accumulating stats, stopped (with a
          final flush) when the stream finishes or fails.
        """
        close = False
        if out is None:
            fh = sys.stdout
        elif hasattr(out, "write"):
            fh = out
        else:
            fh = open(out, "w")
            close = True
        n_reads = n_records = n_batches = 0
        stats = obs.Snapshot()
        stats_lock = threading.Lock()
        t_start = time.perf_counter()
        last_batch: dict | None = None
        it = iter(batches)
        _end = object()
        if runlog is not None:
            runlog.emit("stream_start",
                        engine=engine or self.options.engine,
                        out=(None if out is None or hasattr(out, "write")
                             else str(out)),
                        total_reads=total_reads)
        try:
            if header:
                for ln in self.sam_header(cl=cl):
                    print(ln, file=fh)
            traced = (self.telemetry is not None
                      and self.telemetry.tracer is not None)
            with self._scope() as run_reg, (
                    obs.GcClock().running(run_reg) if traced
                    else contextlib.nullcontext()):
                def live_stats() -> obs.Snapshot:
                    # thread-safe view for the exporter: copy under the
                    # lock, then fold in the run registry's current state
                    with stats_lock:
                        merged = obs.Snapshot().merge_in(stats)
                    if run_reg is not None:
                        merged.merge_in(run_reg.snapshot())
                    return merged

                if export is not None:
                    export.start(live_stats)
                warn_ctx = (runlog.capture_warnings() if runlog is not None
                            else contextlib.nullcontext())
                try:
                    with warn_ctx:
                        # the run-level scope catches the generator-side
                        # io instrumentation: batch packing executes
                        # inside next()
                        while True:
                            with obs.span("io"):
                                b = next(it, _end)
                            if b is _end:
                                break
                            bt0 = time.perf_counter()
                            paired = hasattr(b, "reads1")
                            # the chunk's index is the run log's batch
                            with obs.chunk(n_batches):
                                if paired:
                                    res = self.align_pairs(b, engine=engine)
                                    n_reads += 2 * len(b)
                                else:
                                    res = self.align(b, engine=engine)
                                    n_reads += len(b)
                                with obs.span("io"), \
                                        obs.span("sam_format"):
                                    for ln in res.sam():
                                        print(ln, file=fh)
                            n_records += res.n_records
                            n_batches += 1
                            with stats_lock:
                                stats.merge_in(res.stats)
                            last_batch = {
                                "i": n_batches - 1, "size": len(b),
                                "paired": paired,
                                "first_name": (str(b.names[0])
                                               if len(b.names) else None),
                                "last_name": (str(b.names[-1])
                                              if len(b.names) else None)}
                            if runlog is not None:
                                runlog.batch(
                                    n_batches - 1,
                                    reads=2 * len(b) if paired else len(b),
                                    records=res.n_records,
                                    batch_s=time.perf_counter() - bt0,
                                    reads_total=n_reads,
                                    records_total=n_records,
                                    elapsed_s=(time.perf_counter()
                                               - t_start),
                                    total_reads=total_reads)
                except BaseException as e:
                    if runlog is not None:
                        runlog.crash(e, snapshot=live_stats(),
                                     batch=last_batch,
                                     trace_tail=self._trace_tail())
                    raise
                finally:
                    if export is not None:
                        export.stop()
            if run_reg is not None:
                stats.merge_in(run_reg.snapshot())
            fh.flush()
        finally:
            if close:
                fh.close()
        wall = time.perf_counter() - t_start
        if runlog is not None:
            runlog.emit("stream_end", n_reads=n_reads, n_records=n_records,
                        n_batches=n_batches, wall_s=round(wall, 6),
                        reads_per_s=round(n_reads / wall, 3) if wall > 0
                        else 0.0)
        return dict(n_reads=n_reads, n_records=n_records,
                    n_batches=n_batches, stats=stats)
