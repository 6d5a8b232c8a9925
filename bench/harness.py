"""One run of one cell: set-up, the measured window, the comparison with
the plain reference, and the result line.

Everything is found by name from ``BENCHMARK.json`` at the root of the
checkout: the cell (``workloads``), its configuration
(``bench/configs/<config>.json``), its traffic mix
(``bench/traffic/<traffic>.json``), its metrics (``end_to_end`` and
``per_layer``, each per-layer metric read by ``bench/metrics/<name>.py``).

The window drives ``repro_torch.api.Aligner(engine="cuda").stream_sam``
over ``repro_torch.io.stream.open_batches(fq1[, fq2], chunk_bases=K)``,
the path of ``cli mem -K``, in a closed loop: the next chunk is read when
the last one is written.  The reads come from a producer process
(``bench.producer``) that writes them as FASTQ files ahead of the mapper,
a few ``-K`` chunks to a file; the window reads the files in order.  The
set-up ends with a full garbage collection, and what is alive then is
frozen (``gc.freeze``), so that the window collects only its own
garbage.  The window ends when the last chunk started inside it
finishes; the SAM goes to a sink in memory.

Then, with the program's state freed, the reference (``bench.reference.
<name>``, the configuration's ``reference``) maps a sample of the
window's reads drawn from the seed (single-end: ``SE_SAMPLE`` reads;
paired-end: one whole ``-K`` chunk, whose insert-size stats it estimates
again) on the same device, and every one of their SAM records has to
equal the program's byte for byte.  Every read of the window has to have
its records, and the header has to equal the reference's.
"""

from __future__ import annotations

import contextlib
import dataclasses
import gc
import importlib
import importlib.util
import io
import json
import os
import pathlib
import resource
import shutil
import subprocess
import sys
import tempfile
import time

import numpy as np

BENCH = pathlib.Path(__file__).resolve().parent
#: single-end reads compared with the reference, drawn from the seed
SE_SAMPLE = 2048
#: reads and pairs of one warm-up batch (the cell's read shape)
WARM_READS = 512
#: ``-K`` chunks a file of reads, and files the producer keeps written
#: ahead of the mapper
SEGMENT_CHUNKS = 2
LEAD = 3
#: seconds to wait for a file of reads, and for the producer to end
PRODUCER_WAIT_S = 60.0
#: module names a run must not have loaded, compared as whole top-level
#: names: the JAX package and JAX itself
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


# ---------------------------------------------------------------------
# Discovery by name
# ---------------------------------------------------------------------

@dataclasses.dataclass
class Cell:
    name: str
    entry: dict          # the cell's entry in BENCHMARK.json
    config: dict         # configs/<config>.json
    traffic: dict        # traffic/<traffic>.json
    end_to_end: list     # metric entries that this cell reports
    per_layer: list
    root: pathlib.Path   # the checkout

    @property
    def index_cache(self) -> pathlib.Path:
        return self.root / "build" / "bench" / "index"

    @property
    def paired(self) -> bool:
        return self.config["reads"]["layout"] == "pe"

    @property
    def read_len(self) -> int:
        return int(self.config["reads"]["length"])

    @property
    def chunk_bases(self) -> int:
        return int(self.config["chunk_bases"])

    @property
    def chunk_items(self) -> int:
        """Reads (pairs) a ``-K`` chunk: a chunk closes once its bases
        reach ``chunk_bases``, and every read has ``read_len`` bases."""
        per = self.read_len * (2 if self.paired else 1)
        return -(-self.chunk_bases // per)


def applies(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def load_cell(name: str, root: pathlib.Path) -> Cell:
    """The cell ``name`` of ``root/BENCHMARK.json`` with its files (from
    ``root/bench``)."""
    spec = json.loads((root / "BENCHMARK.json").read_text())
    entry = next((w for w in spec["workloads"] if w["name"] == name), None)
    if entry is None:
        raise SystemExit(f"no workload {name!r} in BENCHMARK.json")
    bench = root / "bench"
    config = json.loads((bench / "configs" / f"{entry['config']}.json")
                        .read_text())
    traffic = json.loads((bench / "traffic" / f"{entry['traffic']}.json")
                         .read_text())
    return Cell(name, entry, config, traffic,
                [m for m in spec["end_to_end"] if applies(m, name)],
                [m for m in spec["per_layer"] if applies(m, name)], root)


def reader(metric: str, root: pathlib.Path):
    """The ``read(ctx)`` function of ``root/bench/metrics/<metric>.py``."""
    path = root / "bench" / "metrics" / f"{metric}.py"
    spec = importlib.util.spec_from_file_location(
        f"bench_metric_{metric.replace('.', '_').replace('-', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def reference(cell: Cell):
    return importlib.import_module(
        f"bench.reference.{cell.config['reference']}")


def forbidden_modules() -> list[str]:
    return sorted(m for m in sys.modules if m.split(".")[0] in FORBIDDEN)


# ---------------------------------------------------------------------
# The reads: a producer process writing files ahead of the mapper
# ---------------------------------------------------------------------

class Reads:
    """A fresh directory under ``TMPDIR`` and the producer writing the
    run's reads into it, ``SEGMENT_CHUNKS`` chunks a file and ``LEAD``
    files ahead."""

    def __init__(self, cell: Cell, seed: int, root: pathlib.Path):
        self.dir = pathlib.Path(tempfile.mkdtemp(prefix="bench-reads-"))
        self.ends = 2 if cell.paired else 1
        args = {"genome": cell.config["genome"], "traffic": cell.traffic,
                "seed": seed, "read_len": cell.read_len,
                "paired": cell.paired, "dir": str(self.dir),
                "segment": SEGMENT_CHUNKS * cell.chunk_items, "lead": LEAD}
        self.proc = subprocess.Popen(
            [sys.executable, "-m", "bench.producer", json.dumps(args)],
            cwd=root, stdin=subprocess.DEVNULL, stdout=subprocess.DEVNULL)

    def segment(self, j: int) -> list[str]:
        """The paths of file ``j`` (each end), once the producer has
        written it."""
        from .producer import segment_path
        paths = [segment_path(self.dir, j, e) for e in range(self.ends)]
        t0 = time.perf_counter()
        while not paths[-1].exists():
            if self.proc.poll() is not None:
                raise RunDry(f"the producer ended ({self.proc.returncode})")
            if time.perf_counter() - t0 > PRODUCER_WAIT_S:
                raise RunDry(f"no file of reads {j} after "
                             f"{PRODUCER_WAIT_S:.0f} s")
            time.sleep(0.0005)
        return [str(p) for p in paths]

    def ahead(self) -> None:
        """Wait until the producer has written its first ``LEAD`` files."""
        self.segment(LEAD - 1)

    def batches(self, chunk_bases: int):
        """The ``-K`` chunks of every file in order, each file read by
        the port's ``open_batches`` and deleted once read.  A file holds
        whole chunks, so the chunks are those of one stream."""
        from repro_torch.io.stream import open_batches
        j = 0
        while True:
            paths = self.segment(j)
            yield from open_batches(*paths, chunk_bases=chunk_bases)
            for p in paths:
                os.unlink(p)
            j += 1

    def close(self) -> None:
        """End the producer, wait for it, and remove the files."""
        if self.proc.poll() is None:
            self.proc.terminate()
            try:
                self.proc.wait(PRODUCER_WAIT_S)
            except subprocess.TimeoutExpired:
                self.proc.kill()
                self.proc.wait()
        shutil.rmtree(self.dir, ignore_errors=True)


class GcClock:
    """Seconds the garbage collector ran, and its full collections,
    while ``running``."""

    def __init__(self):
        self.seconds = 0.0
        self.full = 0
        self._t = 0.0

    def _tick(self, phase, info) -> None:
        if phase == "start":
            self._t = time.perf_counter()
        else:
            self.seconds += time.perf_counter() - self._t
            self.full += info["generation"] == 2

    @contextlib.contextmanager
    def running(self):
        gc.callbacks.append(self._tick)
        try:
            yield self
        finally:
            gc.callbacks.remove(self._tick)


class RunDry(RuntimeError):
    pass


class Gate:
    """The window's batch iterator: hands on chunks until the window
    closes (at least one), and counts what it handed on."""

    def __init__(self, batches, t_end: float):
        self.batches = batches
        self.t_end = t_end
        self.sizes: list[int] = []
        self.starts: list[float] = []

    def __iter__(self):
        while not self.sizes or time.perf_counter() < self.t_end:
            self.starts.append(time.perf_counter())
            b = next(self.batches, None)
            if b is None:
                raise RunDry("the read stream ended inside the window")
            self.sizes.append(len(b))
            yield b


# ---------------------------------------------------------------------
# The comparison
# ---------------------------------------------------------------------

def records_by_name(lines) -> dict:
    """qname -> its SAM records, in order."""
    out: dict = {}
    for ln in lines:
        out.setdefault(ln.split("\t", 1)[0], []).append(ln)
    return out


def sample(cell: Cell, seed: int, n_items: int) -> np.ndarray:
    """Numbers of the reads (pairs) of a window of ``n_items`` that the
    reference maps: single-end, ``SE_SAMPLE`` reads drawn from the seed;
    paired-end, the pairs of one ``-K`` chunk drawn from the seed."""
    rng = np.random.default_rng([seed & (2 ** 64 - 1), 2])
    if cell.paired:
        c = int(rng.integers(-(-n_items // cell.chunk_items)))
        return np.arange(c * cell.chunk_items,
                         min((c + 1) * cell.chunk_items, n_items))
    return np.sort(rng.choice(n_items, min(SE_SAMPLE, n_items),
                              replace=False))


def expected(cell: Cell, seed: int, pick: np.ndarray, device, *,
             control: bool = False) -> tuple[list, list, list]:
    """(names, SAM header, SAM records) of the reads ``pick`` of the run
    of ``seed``, made again and mapped by the reference (by its control,
    with ``control``) on ``device``."""
    from .frozen.genome import bundle, make_genome
    from .frozen.reads import Simulator, Traffic
    ref = reference(cell)
    flags = cell.config["options"]
    idx = ref.load_index(bundle(cell.config["genome"], cell.index_cache))
    sim = Simulator(make_genome(cell.config["genome"]),
                    Traffic.from_json(cell.traffic), seed,
                    read_len=cell.read_len, paired=cell.paired)
    if cell.paired:
        names, r1, r2 = sim.reads(pick)
        lines = ref.align_pe(idx, r1, r2, names, flags, device,
                             control=control)
    else:
        names, reads = sim.reads(pick)
        lines = ref.align_se(idx, reads, names, flags, device,
                             control=control)
    return names, ref.sam_header(idx), lines


def compare(cell: Cell, seed: int, sam: str, n_items: int,
            device) -> dict:
    """The checks of one run of ``n_items`` reads (pairs) whose SAM is
    ``sam``: each number and its limit."""
    lines = sam.splitlines()
    head = [ln for ln in lines if ln.startswith("@")]
    recs = records_by_name(ln for ln in lines if not ln.startswith("@"))
    names = [f"{'p' if cell.paired else 'r'}{i}" for i in range(n_items)]
    missing = sum(1 for n in names if n not in recs)
    extra = len(recs) - (n_items - missing)
    pick = sample(cell, seed, n_items)
    want_names, want_head, want = expected(cell, seed, pick, device)
    want_by = records_by_name(want)
    differ = sum(1 for n in want_names if recs.get(n) != want_by.get(n))
    unit = 2 if cell.paired else 1
    return {"reads_compared": {"value": unit * len(want_names),
                               "limit": unit * len(pick), "at_least": True},
            "reads_differing": {"value": unit * differ, "limit": 0},
            "reads_missing": {"value": unit * missing, "limit": 0},
            "reads_unexpected": {"value": unit * max(extra, 0), "limit": 0},
            "header_differs": {"value": int(head != want_head), "limit": 0}}


def passed(checks: dict) -> bool:
    return all(c["value"] >= c["limit"] if c.get("at_least")
               else c["value"] <= c["limit"] for c in checks.values())


# ---------------------------------------------------------------------
# One run
# ---------------------------------------------------------------------

@dataclasses.dataclass
class Context:
    """What a per-layer metric's reader reads."""
    cell: Cell
    n_reads: int         # reads of the window (a pair's ends count two)
    n_chunks: int
    window_s: float
    stats: dict          # the port's summed spans and counters
    setup: dict          # the benchmark's set-up spans
    device: dict         # device numbers of the traced window, if any
    work_s: dict         # least seconds of each kernel's launches

    def ms_per_kread(self, seconds: float) -> float:
        return 1e6 * seconds / self.n_reads

    def time_s(self, span: str) -> float:
        return float(self.stats.get(f"time_{span}_s", 0.0))


def run_cell(name: str, seed: int, seconds: float, trace: bool, *,
             device: str = "cuda", root: pathlib.Path | None = None,
             t_process: float | None = None) -> dict:
    """Run cell ``name`` once; return the result line's object."""
    t_process = time.perf_counter() if t_process is None else t_process
    root = pathlib.Path(root or BENCH.parent)
    cell = load_cell(name, root)
    readers = {m["name"]: reader(m["name"], root) for m in cell.per_layer}
    reads = Reads(cell, seed, root)
    try:
        return _run(cell, seed, seconds, trace, device, root, t_process,
                    reads, readers)
    finally:
        reads.close()


def _run(cell, seed, seconds, trace, device, root, t_process, reads,
         readers) -> dict:
    sys.path.insert(0, str(root / "src"))
    import torch
    from repro_torch import obs
    from repro_torch.api import Aligner
    from repro_torch.io.stream import ReadBatch, PairBatch
    from repro_torch.options import AlignOptions

    from .frozen.genome import bundle
    from .trace import DeviceTrace, KernelInputs, host_spans

    dev = torch.device(device)
    setup = {"import_s": time.perf_counter() - t_process}
    # the checkout's first run builds the kernel library and the bundle
    t0 = time.perf_counter()
    if dev.type == "cuda":
        from repro_torch.kernels import build
        build.library()
    prefix = bundle(cell.config["genome"], cell.index_cache)
    setup["build_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    telemetry = obs.Telemetry(trace=True) if trace else None
    opts = AlignOptions.from_flags(cell.config["options"])
    aligner = Aligner.from_bundle(prefix, opts, device=device,
                                  telemetry=telemetry)
    aligner.index.device(dev)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    setup["index_load_s"] = time.perf_counter() - t0
    # warm-up on reads of the cell's shape, from the reference's own
    # sequence (no haplotype) and a seed of its own
    warm = _warm_batch(cell, prefix, seed, ReadBatch, PairBatch)
    t0 = time.perf_counter()
    (aligner.align_pairs if cell.paired else aligner.align)(warm)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    setup["warm_up_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    reads.ahead()
    setup["reads_s"] = time.perf_counter() - t0

    batches = reads.batches(cell.chunk_bases)
    sink = io.StringIO()          # the window's SAM, kept in memory
    kernels = KernelInputs()
    dtrace = DeviceTrace(dev) if trace and dev.type == "cuda" else None
    gc_clock = GcClock()
    gc.collect()
    gc.freeze()
    try:
        with contextlib.ExitStack() as stack:
            stack.enter_context(gc_clock.running())
            if trace:
                stack.enter_context(kernels.recording())
            if dtrace is not None:
                stack.enter_context(dtrace)
            t_start = time.perf_counter()
            use0 = resource.getrusage(resource.RUSAGE_SELF)
            gate = Gate(batches, t_start + seconds)
            summary = aligner.stream_sam(gate, sink)
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
            t_stop = time.perf_counter()
            use1 = resource.getrusage(resource.RUSAGE_SELF)
    finally:
        batches.close()
        gc.unfreeze()
    setup_s = t_start - t_process
    window_s = t_stop - t_start
    unit = 2 if cell.paired else 1
    n_items = sum(gate.sizes)
    peak = (torch.cuda.max_memory_allocated(dev) if dev.type == "cuda"
            else 0)
    reads.close()
    dev_numbers = {}
    if dtrace is not None:
        dev_numbers = dtrace.read(t_start, t_stop,
                                  host_spans(telemetry.tracer))
    stats = {k: v for k, v in dict(summary["stats"]).items()
             if isinstance(v, (int, float))}
    sam = sink.getvalue()
    del aligner, summary, sink, telemetry, dtrace
    gc.collect()
    work_s = kernels.work_s(dev) if trace else {}
    del kernels
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    t_check = time.perf_counter()
    checks = compare(cell, seed, sam, n_items, dev)
    print("bench: set-up " + ", ".join(f"{k} {v:.3f}" for k, v in
                                      setup.items()), file=sys.stderr)
    chunk_s = np.diff(gate.starts + [t_stop])
    print(f"bench: window cpu user {use1.ru_utime - use0.ru_utime:.3f} s, "
          f"system {use1.ru_stime - use0.ru_stime:.3f} s, context switches "
          f"{use1.ru_nvcsw - use0.ru_nvcsw} voluntary, "
          f"{use1.ru_nivcsw - use0.ru_nivcsw} involuntary, load "
          f"{os.getloadavg()[0]:.2f}, threads {torch.get_num_threads()}, "
          f"gc {gc_clock.seconds:.3f} s ({gc_clock.full} full), "
          f"chunks " + " ".join(f"{c:.3f}" for c in chunk_s),
          file=sys.stderr)
    print(f"bench: {cell.name} seed {seed}: setup {setup_s:.3f} s, window "
          f"{window_s:.3f} s ({len(gate.sizes)} chunks), after the window "
          f"{t_check - t_stop:.3f} s, reference {time.perf_counter() - t_check:.3f} s",
          file=sys.stderr)
    ctx = Context(cell, unit * n_items, len(gate.sizes), window_s, stats,
                  setup, dev_numbers, work_s)
    if trace:
        metrics = {}
        for m in cell.per_layer:
            v = readers[m["name"]](ctx)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    else:
        values = {"reads_per_s": unit * n_items / window_s,
                  "setup_s": setup_s}
        metrics = {m["name"]: {"value": values[m["name"]], "unit": m["unit"]}
                   for m in cell.end_to_end}
    out = {"correct": passed(checks), "attempted": unit * n_items,
           "failed": checks["reads_missing"]["value"], "metrics": metrics,
           "device": _device(dev, peak, dev_numbers)}
    if dev_numbers:
        out["breakdown"] = {"device_ops": dev_numbers["device_ops"],
                            "idle_gaps": dev_numbers["idle_gaps"]}
    # set-up's parts; ``build_s`` is the checkout's first run's builds
    out["setup_parts"] = setup
    out["checks"] = checks
    return out


def _warm_batch(cell: Cell, prefix, seed: int, ReadBatch, PairBatch):
    """A batch of ``WARM_READS`` reads (pairs) of the cell's shape drawn
    from the bundle's forward sequence."""
    from .frozen.reads import Simulator, Traffic
    meta = json.loads(pathlib.Path(str(prefix) + ".ri.json").read_text())
    with np.load(str(prefix) + ".ri.npz") as z:
        seq = z["seq"][:meta["n_ref"]]
    ct = meta["contigs"]
    contigs = [(n, seq[o:o + ln]) for n, o, ln in
               zip(ct["names"], ct["offsets"], ct["lengths"])]
    sim = Simulator(contigs, Traffic.from_json(cell.traffic), seed,
                    read_len=cell.read_len, paired=cell.paired,
                    haplotype=False)
    blk = sim.block(0)
    n = WARM_READS
    L = np.full(n, cell.read_len, np.int64)
    if cell.paired:
        return PairBatch(blk[0][:n], blk[1][:n], blk[2][:n], L, L)
    return ReadBatch(blk[0][:n], blk[1][:n], L)


def _device(dev, peak: int, numbers: dict) -> dict:
    import torch
    if dev.type == "cuda":
        kind, count = torch.cuda.get_device_name(dev), 1
    else:
        kind, count = "cpu", 1
    out = {"platform": "gpu" if dev.type == "cuda" else "cpu",
           "kind": kind, "count": count, "memory_peak_bytes": int(peak)}
    if numbers:
        out["busy_s"] = numbers["busy_s"]
        out["window_s"] = numbers["window_s"]
    return out


def check_lines(checks: dict) -> list[str]:
    """One line a compared number, with its limit."""
    return [f"check {k} = {c['value']} "
            f"({'at least' if c.get('at_least') else 'at most'} "
            f"{c['limit']})" for k, c in checks.items()]
