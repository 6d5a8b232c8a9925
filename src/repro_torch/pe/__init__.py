"""Paired-end alignment (bwa-mem's mem_sam_pe path), a copy of
``repro.pe`` over the port's pipeline.

Stages:

1. insert-size estimation from high-confidence unique pairs (pestat.py);
2. mate rescue — insert-window banded SW for unmapped/inconsistent mates,
   scalar per-pair baseline vs. length-sorted inter-task batches through
   the pipeline's BSW executor, so through the bsw kernel on the
   pipeline's device (rescue.py);
3. pair scoring/selection and pair-aware SAM emission with proper-pair
   FLAG/RNEXT/PNEXT/TLEN fields (pairing.py).

The entry points are ``run_pe_batched`` and ``run_pe_baseline`` in
``repro_torch.core.pipeline``.
"""

from .. import obs
from ..core.pipeline import bsw_batch_fn
from .pestat import (PairStat, estimate_pestat, infer_dir,  # noqa: F401
                     pestat_from_jsonable, pestat_to_jsonable)
from .rescue import (PEOptions, RescueTask, best_diag_seed,  # noqa: F401
                     merge_rescues, plan_rescues, rescue_window,
                     run_rescues_batched, run_rescues_scalar)
from .pairing import (blend_mapq, emit_pair, pair_score,  # noqa: F401
                      raw_mapq, select_pair)


def pair_pipeline(idx, reads1, reads2, res1, res2, opt, peopt=None, *,
                  batched: bool, names=None):
    """Shared PE tail: pestat -> rescue (scalar or batched) -> pairing ->
    SAM.
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
        tasks = plan_rescues((res1, res2), (reads1, reads2), pes, idx, peopt)
        if batched:
            outs, rstats = run_rescues_batched(tasks, idx, p,
                                               batch_fn=bsw_batch_fn(opt),
                                               block=opt.bsw_block,
                                               sort=opt.bsw_sort)
        else:
            outs, rstats = run_rescues_scalar(tasks, idx, p)
        n_rescued = merge_rescues((res1, res2), tasks, outs, idx, p,
                                  opt.mem.min_seed_len, peopt)
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
