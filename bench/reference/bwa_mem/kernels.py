"""The three kernels of the pipeline as their plain PyTorch versions, on
whatever device the reference runs: the SMEM round (``fmocc_ref``), a
block of BSW extensions (``bsw_ref``) and finalize's banded global
alignments (``galign_ref``).  Each keeps the interface of the program's
wrapper, so the copied pipeline calls it where the program launches."""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .bsw import BSWParams, ExtResult, pack_tasks
from .bsw_ref import bsw_ref
from .galign_ref import galign_ref
from .sam import _OPS


@dataclasses.dataclass(frozen=True)
class OccFn:
    """The occ configuration the SMEM rounds read: the eta32 layout (every
    layout gives the same values) on ``device``."""
    device: torch.device
    layout: str = "eta32"
    block: int = 256


def bsw_block(queries, targets, h0s, p: BSWParams, ws=None,
              qmax: int | None = None, tmax: int | None = None, *,
              device, local_only: bool = False) -> list[ExtResult]:
    """One block of extension tasks through ``bsw_ref`` on ``device``;
    ``local_only`` (the control) reports no end-to-end score."""
    packed = pack_tasks(queries, targets, h0s, p, ws, qmax, tmax)
    out = bsw_ref(*[torch.from_numpy(a).to(device) for a in packed], p)
    if local_only:
        out[4] = -1
    return [ExtResult(*(int(v) for v in col))
            for col in out.cpu().numpy().T]


def galign_pack(tasks) -> list[np.ndarray]:
    """``(q, t, w)`` tasks -> qs (T, nmax), ts (T, mmax) uint8 codes
    (clipped to 0..4, padded with 4) and ns, ms, ws (T,) int32."""
    T = len(tasks)
    ns = np.array([len(q) for q, _, _ in tasks], np.int32)
    ms = np.array([len(t) for _, t, _ in tasks], np.int32)
    ws = np.array([w for _, _, w in tasks], np.int32)
    qs = np.full((T, max(int(ns.max()) if T else 0, 1)), 4, np.uint8)
    ts = np.full((T, max(int(ms.max()) if T else 0, 1)), 4, np.uint8)
    for k, (q, t, _) in enumerate(tasks):
        qs[k, :len(q)] = np.clip(q, 0, 4)
        ts[k, :len(t)] = np.clip(t, 0, 4)
    return [qs, ts, ns, ms, ws]


def galign_batch(tasks, p: BSWParams, *, device):
    """``sam.global_align_cigar(q, t, w, p)`` of every ``(q, t, w)`` task
    through ``galign_ref`` on ``device``: ``[(score, cigar), ...]``."""
    if not tasks:
        return []
    args = [torch.from_numpy(a).to(device) for a in galign_pack(tasks)]
    score, nruns, runs = (x.cpu().numpy() for x in galign_ref(*args, p))
    if (nruns < 0).any():
        raise RuntimeError("galign_ref: a traceback leaves the band")
    return [(int(s), [(int(r) >> 2, _OPS[int(r) & 3]) for r in rr[:k]])
            for s, k, rr in zip(score, nruns, runs)]
