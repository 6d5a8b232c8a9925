"""Insert-size distribution estimation (mem_pestat port).

Works in bwa's doubled-reference coordinate space: an alignment start
``rb >= l_pac`` lies on the reverse strand.  ``infer_dir`` projects the
mate onto the anchor's strand and classifies the pair into one of four
orientations; high-confidence unique pairs vote into per-orientation
insert-size histograms, from which percentile-clipped mean/std and
mapping bounds are derived exactly like ``mem_pestat``:

  * quartiles -> outlier fence (p25/p75 +- 2 IQR) -> clipped avg/std;
  * low/high mapping window from p25/p75 +- 3 IQR, widened to at least
    avg +- 4 std;
  * an orientation with < MIN_DIR_CNT votes (or < 5% of all votes) FAILS
    and is excluded from rescue and pair scoring.
"""

from __future__ import annotations

import dataclasses
import math

from ..core.contig import same_contig

MIN_DIR_CNT = 10
MIN_DIR_RATIO = 0.05
OUTLIER_BOUND = 2.0
MAPPING_BOUND = 3.0
MAX_STDDEV = 4.0
MIN_RATIO = 0.8          # sub/score uniqueness cutoff for voting pairs


@dataclasses.dataclass
class PairStat:
    """Insert-size stats for one orientation (failed => unusable)."""
    low: int = 0
    high: int = 0
    avg: float = 0.0
    std: float = 0.0
    failed: bool = True


def pestat_to_jsonable(pes) -> list[dict]:
    """PairStat[4] -> plain dicts (for job manifests / run logs).

    JSON round-trips Python floats exactly (repr-based), so freezing an
    estimate through a manifest cannot perturb downstream output.
    """
    return [dataclasses.asdict(s) for s in pes]


def pestat_from_jsonable(rows) -> list[PairStat]:
    """Inverse of :func:`pestat_to_jsonable`."""
    return [PairStat(**row) for row in rows]


def infer_dir(l_pac: int, b1: int, b2: int) -> tuple[int, int]:
    """bwa mem_infer_dir: (orientation r in 0..3, projected distance).

    r=0: same strand, mate downstream (FF); r=1: opposite strands, mate
    downstream (FR); r=2: opposite strands, mate upstream (RF); r=3: same
    strand, mate upstream (RR).
    """
    r1, r2 = b1 >= l_pac, b2 >= l_pac
    p2 = b2 if r1 == r2 else (l_pac << 1) - 1 - b2
    dist = p2 - b1 if p2 > b1 else b1 - p2
    return (0 if r1 == r2 else 1) ^ (0 if p2 > b1 else 3), int(dist)


def _percentile(v: list, frac: float) -> float:
    """bwa-style percentile: sorted[int(frac * n + .499)]."""
    return v[min(int(frac * len(v) + 0.499), len(v) - 1)]


def estimate_pestat(results1, results2, idx, *,
                    max_ins: int = 10000) -> list[PairStat]:
    """Per-orientation PairStat[4] from per-pair alignment lists.

    Only pairs where BOTH ends map uniquely (best alignment's runner-up
    score below MIN_RATIO of the best) vote, mirroring mem_pestat's
    cal_sub gate.  ``idx`` is the reference index; pairs whose ends land
    on different contigs have no defined insert size and never vote.
    """
    l_pac = int(idx.n_ref)
    isize: list[list[int]] = [[], [], [], []]
    for a1s, a2s in zip(results1, results2):
        if not a1s or not a2s:
            continue
        b1, b2 = a1s[0], a2s[0]
        if b1.sub > MIN_RATIO * b1.score or b2.sub > MIN_RATIO * b2.score:
            continue
        if not same_contig(idx, b1.rb, b2.rb):
            continue
        r, d = infer_dir(l_pac, b1.rb, b2.rb)
        if 0 < d <= max_ins:
            isize[r].append(d)
    tot = sum(len(v) for v in isize)
    pes = [PairStat() for _ in range(4)]
    for r in range(4):
        v = sorted(isize[r])
        if len(v) < MIN_DIR_CNT or len(v) < tot * MIN_DIR_RATIO:
            continue                      # stays failed
        p25 = _percentile(v, 0.25)
        p75 = _percentile(v, 0.75)
        iqr = p75 - p25
        lo = int(p25 - OUTLIER_BOUND * iqr + 0.499)
        hi = int(p75 + OUTLIER_BOUND * iqr + 0.499)
        core = [x for x in v if lo <= x <= hi]
        if not core:
            continue
        avg = sum(core) / len(core)
        std = math.sqrt(sum((x - avg) ** 2 for x in core) / len(core))
        std = max(std, 1.0)               # guard degenerate distributions
        low = int(p25 - MAPPING_BOUND * iqr + 0.499)
        high = int(p75 + MAPPING_BOUND * iqr + 0.499)
        low = min(low, int(avg - MAX_STDDEV * std + 0.499))
        high = max(high, int(avg + MAX_STDDEV * std + 0.499))
        pes[r] = PairStat(low=max(low, 1), high=high, avg=avg, std=std,
                          failed=False)
    return pes
