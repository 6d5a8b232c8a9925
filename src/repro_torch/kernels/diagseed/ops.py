"""Mate rescue's anchor search through the diagseed CUDA kernel
(``csrc/diagseed.cu``).

``diagseed_call`` is the wrapper over the packed candidate arrays.  For
tensors on the CPU it runs the plain PyTorch version
(``ref.diagseed_ref``); for tensors on a CUDA device it reads the lengths
once to the host, sizes the launch's shared memory there and launches
(``diagseed_launch``); any other device raises.

``diag_seed_batch`` is the pipeline's entry, the batched ``seed_fn`` of
``pe.rescue.plan_rescues``: it answers the candidates whose window or mate
is shorter than ``min_len`` on the host, gathers the other windows from
the reference in one indexed gather, packs them and the mates ragged into
flat byte buffers, and runs them on ``device`` in one call, with one
readback of (C, 3) int32.  Each row is ``pe.rescue.best_diag_seed``'s
answer as ``(d, j_end, len)``, len 0 where no run reaches ``min_len``.
It replaces that host function on the ``cuda`` engine's mate rescue (no
Pallas counterpart).
"""

from __future__ import annotations

import numpy as np
import torch

from ... import obs
from .. import build
from ..galign.ops import to_device
from .ref import diagseed_ref

#: dynamic shared memory a CTA may take on the H100 (227 KB), less 1 KB
#: for the kernel's static reduction array
SMEM_CTA_MAX = 232448 - 1024

#: kernel launches by kernel name (reset by kernels.reset_launch_counts)
LAUNCHES = {"diagseed": 0}


def stage_bytes(wlen, mlen) -> np.ndarray:
    """Shared memory a candidate's CTA stages: the mate rounded up to 16
    bytes, then the window."""
    return (np.asarray(mlen, np.int64) + 15) // 16 * 16 + np.asarray(
        wlen, np.int64)


def smem_bytes(wlen, mlen) -> int:
    """The launch's dynamic shared memory: the most any candidate stages
    within ``SMEM_CTA_MAX`` (a larger one reads device memory)."""
    need = stage_bytes(wlen, mlen)
    return int(need[need <= SMEM_CTA_MAX].max(initial=0))


def diagseed_call(win, woff, wlen, mates, moff, mlen, min_len: int):
    """win / mates flat uint8 codes; woff, moff (C,) int64; wlen, mlen
    (C,) int32, each at least 1 -> (C, 3) int32 (d, j_end, len)."""
    dev = win.device
    if dev.type not in ("cpu", "cuda"):
        raise RuntimeError(f"diagseed has no kernel for device {dev}")
    if dev.type == "cpu":
        return diagseed_ref(win, woff, wlen, mates, moff, mlen, min_len)
    lens = torch.stack([wlen, mlen]).cpu().numpy()     # the one host read
    return diagseed_launch(win, woff, wlen, mates, moff, mlen, min_len,
                           smem_bytes(*lens))


def diagseed_launch(win, woff, wlen, mates, moff, mlen, min_len: int,
                    smem: int):
    """``diagseed_call`` on CUDA tensors whose shared memory the caller
    sized (``smem_bytes``) from the same lengths on the host: no
    device-to-host read.  One launch."""
    dev = win.device
    if dev.type != "cuda":
        raise RuntimeError(f"diagseed_launch takes CUDA tensors, not {dev}")
    C = wlen.shape[0]
    for name, x, dt in (("win", win, torch.uint8), ("woff", woff, torch.int64),
                        ("wlen", wlen, torch.int32),
                        ("mates", mates, torch.uint8),
                        ("moff", moff, torch.int64),
                        ("mlen", mlen, torch.int32)):
        if x.device != dev or x.dtype != dt or not x.is_contiguous():
            raise ValueError(f"diagseed: {name} must be contiguous {dt} on "
                             f"{dev}")
    if any(x.shape != (C,) for x in (woff, mlen, moff)):
        raise ValueError("diagseed: candidate arrays disagree on C")
    if not 0 <= smem <= SMEM_CTA_MAX:
        raise ValueError(f"diagseed: {smem} bytes of shared memory a CTA")
    out = torch.empty((C, 3), dtype=torch.int32, device=dev)
    if C == 0:
        return out
    args = (win.data_ptr(), woff.data_ptr(), wlen.data_ptr(),
            mates.data_ptr(), moff.data_ptr(), mlen.data_ptr(), C, min_len,
            smem, out.data_ptr(), torch.cuda.current_stream(dev).cuda_stream)
    entry = build.library().diagseed
    with obs.device_span("diagseed", dev, build.GATE):
        err = entry(*args)
    build.check(err, "diagseed")
    build.count_launch(LAUNCHES, "diagseed")
    return out


def pack(queries, S: np.ndarray, wlos, whis) -> list[np.ndarray]:
    """Candidates -> win (the windows ``S[wlo:whi)`` end to end, one
    indexed gather), woff, wlen, mates (each run of candidates sharing a
    mate array holds its bytes once), moff, mlen."""
    wlo = np.asarray(wlos, np.int64)
    wlen = np.asarray(whis, np.int64) - wlo
    woff = np.cumsum(wlen) - wlen
    win = S[np.arange(int(wlen.sum())) + np.repeat(wlo - woff, wlen)]
    uniq, moff, at, prev = [], np.empty(len(queries), np.int64), 0, None
    for k, q in enumerate(queries):
        if q is not prev:
            uniq.append(q)
            prev, start, at = q, at, at + len(q)
        moff[k] = start
    mlen = np.array([len(q) for q in queries], np.int32)
    mates = np.concatenate(uniq).astype(np.uint8, copy=False)
    return [win.astype(np.uint8, copy=False), woff, wlen.astype(np.int32),
            mates, moff, mlen]


def diag_seed_batch(queries, S: np.ndarray, wlos, whis, min_len: int, *,
                    device) -> np.ndarray:
    """``pe.rescue.best_diag_seed(q, S, wlo, whi, min_len)`` of every
    candidate, in one call on ``device``: (C, 3) int64 rows (d, j_end,
    len), len 0 where no run reaches ``min_len``."""
    wlos, whis = np.asarray(wlos, np.int64), np.asarray(whis, np.int64)
    out = np.zeros((len(queries), 3), np.int64)
    mlen = np.array([len(q) for q in queries], np.int64)
    least = max(min_len, 1)        # the kernel takes no empty window or mate
    live = np.flatnonzero((whis - wlos >= least) & (mlen >= least))
    if not live.size:
        return out
    with obs.span("kernel.diagseed", cat="kernel", windows=int(live.size)):
        arrays = pack([queries[k] for k in live], S, wlos[live], whis[live])
        args = [to_device(a, device) for a in arrays]
        if args[0].device.type != "cuda":
            got = diagseed_call(*args, min_len)
        else:
            got = diagseed_launch(*args, min_len, smem_bytes(arrays[2],
                                                             arrays[5]))
        out[live] = got.cpu().numpy()
    return out
