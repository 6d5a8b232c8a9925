"""Paper-style profile report: the Table-1 kernel breakdown from a Snapshot.

The source paper motivates every optimization with a profile — SMEM,
SAL and BSW together are >85% of BWA-MEM runtime (Table 1), cell
efficiency drives the BSW batching (Table 8), and the SAL fix is
justified purely by lookup counts (Table 5).  ``render`` reproduces
that presentation from a merged ``Snapshot``:

* % wall time per pipeline stage (SMEM / SAL / chain / BSW / finalize,
  plus the PE stages and I/O batching), with an explicit
  ``unattributed`` row when total wall time is known — no silent gaps;
* cell efficiency (``cells_useful / cells_total``) for the main BSW
  stage and the PE-rescue fan-out;
* the Table-5-style operation counters (SA lookups, BSW tasks, batched
  occ rounds, kernel dispatch counts) and the batch fill ratio.

``write_profile`` / ``read_profile`` define the ``--profile`` JSON
artifact (``repro.cli mem --profile out.json`` writes it,
``repro.cli report out.json`` renders it).
"""

from __future__ import annotations

import json

from .metrics import Hist, Snapshot

PROFILE_VERSION = 1

#: pipeline stages, in pipeline order: (key, label).  A stage's wall
#: time lives in the Snapshot under ``time_<key>_s`` (written by
#: ``obs.span(key)``).  The report prints EVERY stage, observed or not,
#: so a reader (or CI assert) always sees the full pipeline shape.
STAGES = (
    ("io", "I/O batching"),
    ("smem", "SMEM seeding"),
    ("sal", "SAL lookup"),
    ("chain", "chaining"),
    ("bsw", "BSW extension"),
    ("finalize", "finalize/SAM"),
    ("pe_stat", "PE insert-size"),
    ("pe_rescue", "PE mate rescue"),
    ("pe_pair", "PE pairing"),
)

#: operation counters rendered in the counters section (key, label)
COUNTERS = (
    ("sa_lookups", "SA lookups"),
    ("bsw_tasks", "BSW extension tasks"),
    ("bsw_dispatches", "BSW batch dispatches"),
    ("smem_rounds", "SMEM lockstep rounds"),
    ("smem_h2d_bytes", "SMEM host-to-device bytes"),
    ("smem_d2h_bytes", "SMEM device-to-host bytes"),
    ("sal_dispatches", "SAL gather dispatches"),
    ("chains_built", "chains built"),
    ("chains_kept", "chains kept"),
    ("rescue_tasks", "PE rescue tasks"),
    ("rescue_bsw", "PE rescue extensions"),
    ("n_rescued", "PE mates rescued"),
    ("n_proper", "proper pairs"),
    ("kernel_bsw_dispatches", "BSW kernel dispatches"),
    ("kernel_fmocc_dispatches", "fmocc kernel dispatches"),
    ("io_bases", "bases streamed (io)"),
)

#: counters that are sums of PER-READ quantities, so a sharded run's
#: merged Snapshot must match the unsharded run EXACTLY (the shard
#: filter only re-partitions reads; it never changes what one read
#: costs).  Batch-shaped counters (dispatch counts, lockstep rounds,
#: padded cells_total) and PE counters (insert-size stats are
#: per-batch, so sharding legitimately perturbs rescue/pairing) are
#: deliberately excluded.  ``repro.cli report --merge`` and the CI
#: obs-smoke job assert identity on this set.
SHARD_INVARIANT_COUNTERS = (
    "io_reads", "io_bases", "sa_lookups", "bsw_tasks",
    "chains_built", "chains_kept", "cells_useful",
)


def stage_times(snap: dict) -> dict:
    """{stage key: seconds} for every known stage (0.0 when unobserved)."""
    return {k: float(snap.get(f"time_{k}_s", 0.0) or 0.0)
            for k, _ in STAGES}


def _num(v):
    from .metrics import NUMERIC
    return float(v) if isinstance(v, NUMERIC) else None


def breakdown(snap: dict, wall_s: float | None = None) -> dict:
    """JSON-able kernel breakdown (the machine-readable report).

    ``wall_s`` is the run's total wall time when the caller measured one
    (the CLI does); stage percentages are reported against both the
    measured stage total and — when given — the full wall clock, with
    the difference surfaced as ``unattributed_s``.
    """
    times = stage_times(snap)
    measured = sum(times.values())
    denom_wall = wall_s if wall_s else None
    rows = []
    for key, label in STAGES:
        t = times[key]
        rows.append({
            "stage": key,
            "label": label,
            "time_s": round(t, 6),
            "pct_measured": round(100.0 * t / measured, 2) if measured else 0.0,
            "pct_wall": (round(100.0 * t / denom_wall, 2)
                         if denom_wall else None),
        })
    out = {
        "version": PROFILE_VERSION,
        "wall_s": round(wall_s, 6) if wall_s is not None else None,
        "measured_s": round(measured, 6),
        "unattributed_s": (round(max(wall_s - measured, 0.0), 6)
                           if wall_s is not None else None),
        "stages": rows,
        "counters": {},
        "efficiency": {},
    }
    for key, _ in COUNTERS:
        v = _num(snap.get(key))
        if v is not None:
            out["counters"][key] = int(v) if float(v).is_integer() else v
    # kernel-level spans (cat="kernel": Pallas BSW blocks, fmocc rounds,
    # the occ-layout sweep) — nested inside the stage rows above, so
    # reported separately rather than summed into ``measured_s``
    kernels = {}
    for key, v in snap.items():
        if (isinstance(key, str) and key.startswith("time_kernel.")
                and key.endswith("_s") and _num(v) is not None):
            kernels[key[len("time_"):-len("_s")]] = round(float(v), 6)
    if kernels:
        out["kernels"] = kernels
    for prefix, label in (("", "bsw"), ("rescue_", "pe_rescue")):
        useful = _num(snap.get(f"{prefix}cells_useful"))
        total = _num(snap.get(f"{prefix}cells_total"))
        if useful is not None and total:
            out["efficiency"][label] = {
                "cells_useful": int(useful), "cells_total": int(total),
                "ratio": round(useful / total, 4)}
    pad = snap.get("io_pad_frac")
    if isinstance(pad, Hist) and pad.count:
        out["io_pad_frac"] = {"mean": round(pad.mean, 4),
                              "min": round(pad.vmin, 4),
                              "max": round(pad.vmax, 4),
                              "n_batches": pad.count}
    return out


def render(snap: dict, wall_s: float | None = None,
           meta: dict | None = None) -> str:
    """Human-readable report (the ``repro.cli report`` pretty-printer)."""
    b = breakdown(snap, wall_s)
    lines = []
    title = "repro profile — kernel breakdown (paper Table 1 style)"
    lines.append(title)
    lines.append("=" * len(title))
    if meta:
        for k in sorted(meta):
            lines.append(f"  {k}: {meta[k]}")
    if b["wall_s"] is not None:
        lines.append(f"  wall time: {b['wall_s']:.3f}s  "
                     f"(instrumented stages: {b['measured_s']:.3f}s)")
    else:
        lines.append(f"  instrumented stage time: {b['measured_s']:.3f}s")
    lines.append("")
    hdr = f"  {'stage':<16} {'time_s':>10} {'% stages':>9}"
    if b["wall_s"] is not None:
        hdr += f" {'% wall':>8}"
    lines.append(hdr)
    lines.append("  " + "-" * (len(hdr) - 2))
    for row in b["stages"]:
        ln = (f"  {row['label']:<16} {row['time_s']:>10.4f} "
              f"{row['pct_measured']:>8.1f}%")
        if b["wall_s"] is not None:
            ln += f" {row['pct_wall']:>7.1f}%"
        lines.append(ln)
    if b["unattributed_s"] is not None:
        pct = (100.0 * b["unattributed_s"] / b["wall_s"]
               if b["wall_s"] else 0.0)
        lines.append(f"  {'unattributed':<16} {b['unattributed_s']:>10.4f} "
                     f"{'':>9} {pct:>7.1f}%")
    if b["efficiency"]:
        lines.append("")
        lines.append("  cell efficiency (useful / computed DP cells, "
                     "paper Table 8):")
        for label, eff in b["efficiency"].items():
            lines.append(f"    {label:<10} {eff['cells_useful']:>12,} / "
                         f"{eff['cells_total']:>12,}  = "
                         f"{100.0 * eff['ratio']:.1f}%")
    if b.get("kernels"):
        lines.append("")
        lines.append("  kernel time (inside the stages above):")
        for key in sorted(b["kernels"]):
            lines.append(f"    {key:<22} {b['kernels'][key]:>10.4f}s")
    if b["counters"]:
        lines.append("")
        lines.append("  operation counters (paper Table 5 style):")
        labels = dict(COUNTERS)
        for key, v in b["counters"].items():
            lines.append(f"    {labels[key]:<28} {v:>14,}")
    if "io_pad_frac" in b:
        p = b["io_pad_frac"]
        lines.append("")
        lines.append(f"  batch pad waste: mean {100 * p['mean']:.1f}% "
                     f"(min {100 * p['min']:.1f}%, max {100 * p['max']:.1f}%"
                     f", {p['n_batches']} batches)")
    return "\n".join(lines)


def write_profile(path, snap: dict, *, wall_s: float | None = None,
                  meta: dict | None = None) -> None:
    """Persist the ``--profile`` artifact: raw Snapshot + breakdown."""
    if not isinstance(snap, Snapshot):
        snap = Snapshot(snap)
    payload = {
        "version": PROFILE_VERSION,
        "wall_s": wall_s,
        "meta": meta or {},
        "snapshot": snap.to_jsonable(),
        "breakdown": breakdown(snap, wall_s),
    }
    with open(path, "w") as f:
        json.dump(payload, f, indent=1)


def read_profile(path) -> dict:
    """Load a ``--profile`` artifact; ``snapshot`` comes back as a live
    ``Snapshot`` (mergeable across shard profiles)."""
    with open(path) as f:
        payload = json.load(f)
    if payload.get("version") != PROFILE_VERSION:
        raise ValueError(f"unsupported profile version "
                         f"{payload.get('version')!r} in {path}")
    payload["snapshot"] = Snapshot.from_jsonable(payload["snapshot"])
    return payload


# ---------------------------------------------------------------------
# Cross-shard aggregation (repro.cli report --merge)
# ---------------------------------------------------------------------

def merge_profiles(payloads: list[dict], paths=None) -> dict:
    """Merge N per-shard ``--profile`` payloads into ONE profile.

    The merge is just ``Snapshot.merge_all`` — the associativity PR 6
    built in is what makes the result independent of merge grouping —
    so counters sum, stage timers sum to aggregate CPU-seconds, gauges
    keep the worst shard, and per-batch payloads collect.  Wall time is
    reported as the MAX across shards (shards run concurrently; the
    slowest one is the run's wall clock), with the sum kept alongside;
    stage percentages over 100% of wall are therefore real parallelism,
    not an error.  A ``shards`` table (one row per input payload, in
    input order) carries each part's wall time and read count for the
    straggler rendering.
    """
    if not payloads:
        raise ValueError("merge_profiles needs at least one profile")
    snap = Snapshot.merge_all([p["snapshot"] for p in payloads])
    walls = [p.get("wall_s") for p in payloads]
    known = [w for w in walls if w is not None]
    wall = max(known) if known else None
    shards = []
    for i, p in enumerate(payloads):
        pmeta = p.get("meta") or {}
        psnap = p.get("snapshot") or {}
        shards.append({
            "path": (paths[i] if paths is not None else None),
            "shard": pmeta.get("shard"),
            "wall_s": p.get("wall_s"),
            "reads": (pmeta.get("reads")
                      if pmeta.get("reads") is not None
                      else psnap.get("io_reads")),
            "engine": pmeta.get("engine"),
        })
    meta = {"merged_from": len(payloads),
            "wall_max_s": round(wall, 6) if wall is not None else None,
            "wall_sum_s": round(sum(known), 6) if known else None}
    return {"version": PROFILE_VERSION, "wall_s": wall, "meta": meta,
            "snapshot": snap, "breakdown": breakdown(snap, wall),
            "shards": shards}


def shard_wall_table(shards: list[dict], *, threshold: float = 1.5) -> str:
    """Per-shard wall-time table with straggler flags.

    Every shard's wall time is fed through
    ``ft.straggler.StragglerMonitor.observe`` (the same detector the
    distributed loop uses, with ``min_samples`` lowered so small merges
    still judge), and a shard is additionally flagged against the
    final median so early-arriving stragglers aren't grandfathered in
    by an immature rolling window.
    """
    import statistics

    from ..ft.straggler import StragglerMonitor   # lazy: obs stays ft-free

    rows = [s for s in shards if s.get("wall_s") is not None]
    lines = ["per-shard wall time (straggler threshold "
             f"{threshold:g}x median):"]
    if not rows:
        lines.append("  (no shard wall times recorded)")
        return "\n".join(lines)
    walls = [float(s["wall_s"]) for s in rows]
    med = statistics.median(walls)
    mon = StragglerMonitor(window=max(len(walls), 2), threshold=threshold,
                           persist=2, min_samples=2)
    events = [mon.observe(step=i, host=i, step_time=w)
              for i, w in enumerate(walls)]
    hdr = (f"  {'shard':<10} {'wall_s':>9} {'x median':>9} "
           f"{'reads':>8}  flag")
    lines.append(hdr)
    lines.append("  " + "-" * (len(hdr) - 2))
    for s, w, ev in zip(rows, walls, events):
        ratio = w / med if med > 0 else 1.0
        flag = ""
        if ratio > threshold or ev is not None:
            flag = "STRAGGLER"
            if ev is not None:
                flag += f" ({ev.action})"
        shard_id = s.get("shard") or s.get("path") or "?"
        reads = s.get("reads")
        lines.append(f"  {str(shard_id):<10} {w:>9.3f} {ratio:>8.2f}x "
                     f"{(str(reads) if reads is not None else '-'):>8}  "
                     f"{flag}".rstrip())
    lines.append(f"  median {med:.3f}s over {len(walls)} shard(s)")
    return "\n".join(lines)


def write_merged_profile(path, merged: dict) -> None:
    """Persist a ``merge_profiles`` result.  The file is a superset of
    the ``--profile`` artifact (``read_profile`` loads it back, shards
    table included), so merged profiles re-merge and re-render."""
    payload = dict(merged)
    payload["snapshot"] = merged["snapshot"].to_jsonable()
    with open(path, "w") as f:
        json.dump(payload, f, indent=1)
