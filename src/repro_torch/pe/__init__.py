"""Paired-end alignment (bwa-mem's mem_sam_pe path), a copy of
``repro.pe`` over the port's pipeline, and the two PE drivers.

Stages:

1. insert-size estimation from high-confidence unique pairs (pestat.py);
2. mate rescue — insert-window banded SW for unmapped/inconsistent mates,
   scalar per-pair baseline (``rescue_scalar``) vs. every window's anchor
   search in one diagseed call and length-sorted inter-task batches
   through the pipeline's BSW executor, so through the diagseed and bsw
   kernels on the pipeline's device, the accepted mates finalized in one
   galign call (``rescue_batched``; rescue.py);
3. pair scoring/selection and pair-aware SAM emission with proper-pair
   FLAG/RNEXT/PNEXT/TLEN fields (pairing.py).

The drivers are ``run_pe_batched`` (the ``cuda`` engine's, through
``kernels.engine.run_pe_cuda``) and ``run_pe_baseline`` (the
``baseline`` engine's).
"""

import numpy as np

from .. import obs
from ..core.pipeline import PipelineOptions, run_se_baseline, run_se_batched
from ..kernels.fmocc.ops import OccConfig
from .pestat import (PairStat, estimate_pestat, infer_dir,  # noqa: F401
                     pestat_from_jsonable, pestat_to_jsonable)
from .rescue import (PEOptions, RescueTask, best_diag_seed,  # noqa: F401
                     host_diag_seeds, merge_rescues, plan_rescues,
                     rescue_batched, rescue_scalar, rescue_window,
                     run_rescues_batched, run_rescues_scalar)
from .pairing import (blend_mapq, emit_pair, pair_score,  # noqa: F401
                      raw_mapq, select_pair)


def pair_pipeline(idx, reads1, reads2, res1, res2, opt, peopt=None, *,
                  rescue, names=None):
    """Shared PE tail: pestat -> ``rescue`` (``rescue_scalar`` or
    ``rescue_batched``) -> pairing -> SAM.
    ``res1``/``res2`` are the per-end alignment lists from the SE stage
    and are extended IN PLACE with rescued alignments.

    ``idx`` may be a multi-contig ``ContigIndex``: insert sizes, rescue
    windows and proper pairs are all confined to single contigs, and SAM
    mate fields translate through the contig table (RNEXT ``=`` only for
    same-contig mates, TLEN=0 across contigs).

    Returns (sam_lines, stats).
    """
    peopt = peopt or PEOptions()
    p = opt.bsw
    with obs.span("pe_stat"):
        if peopt.frozen_pes is not None:
            pes = list(peopt.frozen_pes)
        else:
            pes = estimate_pestat(res1, res2, idx, max_ins=peopt.max_ins)
    with obs.span("pe_rescue"):
        n_rescued, rstats = rescue((res1, res2), (reads1, reads2), pes, idx,
                                   opt, peopt)
    lines: list[str] = []
    n_proper = 0
    with obs.span("pe_pair"):
        for pid in range(len(reads1)):
            qname = names[pid] if names else f"pair{pid}"
            two, proper = emit_pair(qname, reads1[pid], reads2[pid],
                                    res1[pid], res2[pid], pes, idx,
                                    p.a, peopt.pen_unpaired,
                                    mapq_blend=peopt.mapq_blend)
            lines.extend(two)
            n_proper += int(proper)
    stats = dict(rstats)
    stats.update(n_rescued=n_rescued, n_proper=n_proper,
                 pes_failed=[s.failed for s in pes],
                 pes_avg=[s.avg for s in pes],
                 pes_std=[s.std for s in pes])
    return lines, stats


def run_pe_baseline(idx, reads1: np.ndarray, reads2: np.ndarray,
                    opt: PipelineOptions = PipelineOptions(),
                    pe_opt=None, names=None):
    """Paired-end baseline: per-read scalar SE alignment of both ends,
    then insert-size estimation, SCALAR mate rescue and pair-aware SAM
    emission.  Returns (sam_lines, stats)."""
    res1, s1 = run_se_baseline(idx, reads1, opt)
    res2, s2 = run_se_baseline(idx, reads2, opt)
    lines, pstats = pair_pipeline(idx, reads1, reads2, res1, res2, opt,
                                  pe_opt, rescue=rescue_scalar, names=names)
    stats = obs.Snapshot.merge_all([s1, s2])
    stats.update(pstats)
    return lines, stats


def run_pe_batched(idx, reads1: np.ndarray, reads2: np.ndarray,
                   opt: PipelineOptions = PipelineOptions(),
                   pe_opt=None, names=None, *, occ: OccConfig | None = None):
    """Paired-end driver (paper's organisation extended to PE):
    stage-major batched SE alignment over BOTH ends at once — one lockstep
    SMEM loop (through ``occ``, as ``run_se_batched``) and shared BSW
    blocks — then the whole batch's mate-rescue work pooled on
    ``opt.device`` (``rescue_batched``).  Returns (sam_lines, stats)."""
    n = len(reads1)
    both = np.concatenate([reads1, reads2], axis=0)
    res, s = run_se_batched(idx, both, opt, occ=occ)
    res1, res2 = res[:n], res[n:]
    lines, pstats = pair_pipeline(idx, reads1, reads2, res1, res2, opt,
                                  pe_opt, rescue=rescue_batched, names=names)
    stats = obs.Snapshot(s)
    stats.update(pstats)
    return lines, stats
