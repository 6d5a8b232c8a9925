"""Plain PyTorch version of the diagseed kernel: ``pe.rescue.
best_diag_seed`` (the longest exact diagonal match of a mate inside its
rescue window) for a batch of candidates, with the kernel's ragged array
interface.

It runs the kernel's walk, vectorised over candidates and diagonals: one
step a mate position j, in which every diagonal's run grows on a match
and breaks on a mismatch, and a strict ``>`` keeps each diagonal's first
longest run.  The candidates go in slices of at most ``SLICE_CELLS``
(candidate, diagonal) cells, each padded to its widest window and mate,
so that memory stays bounded whatever the windows' widths.
"""

from __future__ import annotations

import torch

#: (candidate, diagonal) cells of one slice at most (a single wider
#: candidate takes a slice of its own)
SLICE_CELLS = 1 << 22
#: a window byte past its end: never equal to a mate's nucleotide
PAD_W = 5
#: a mate byte past its end: not a nucleotide, so it never matches
PAD_Q = 4


def _slices(wlen, mlen):
    """[start, stop) runs of candidates whose padded cells fit
    ``SLICE_CELLS``."""
    out, start, wide, long_ = [], 0, 0, 0
    for c, (n, L) in enumerate(zip(wlen, mlen)):
        w2, l2 = max(wide, n), max(long_, L)
        if c > start and (c + 1 - start) * (w2 + l2) > SLICE_CELLS:
            out.append((start, c))
            start, w2, l2 = c, n, L
        wide, long_ = w2, l2
    if start < len(wlen):
        out.append((start, len(wlen)))
    return out


def _padded(flat, off, lens, width, pad):
    """(c, width) rows ``flat[off[k]:off[k] + lens[k]]``, padded."""
    col = torch.arange(width, device=flat.device)
    inside = col[None, :] < lens[:, None]
    at = torch.where(inside, off[:, None] + col[None, :], 0)
    return torch.where(inside, flat[at], pad)


def diagseed_ref(win, woff, wlen, mates, moff, mlen, min_len: int):
    """win / mates flat uint8 codes; woff, moff (C,) int64 offsets; wlen,
    mlen (C,) int32 lengths, each at least 1 -> (C, 3) int32 (d, j_end,
    len): the best run of each candidate, on the smallest diagonal among
    the longest and at its first end there; (0, 0, 0) where no run
    reaches ``min_len``."""
    C, dev = wlen.shape[0], wlen.device
    out = torch.zeros((C, 3), dtype=torch.int32, device=dev)
    for a, b in _slices(wlen.tolist(), mlen.tolist()):
        n, L = wlen[a:b].long(), mlen[a:b].long()
        nmax, lmax = int(n.max()), int(L.max())
        W = _padded(win, woff[a:b], n, nmax + lmax, PAD_W)
        Q = _padded(mates, moff[a:b], L, lmax, PAD_Q)
        run = torch.zeros((b - a, nmax), dtype=torch.int32, device=dev)
        best = torch.zeros_like(run)
        end = torch.zeros_like(run)
        for j in range(lmax):
            q = Q[:, j:j + 1]
            hit = (W[:, j:j + nmax] == q) & (q < 4)
            run = torch.where(hit, run + 1, 0)
            longer = run > best
            best = torch.where(longer, run, best)
            end = torch.where(longer, j, end)
        d = best.argmax(dim=1)[:, None]        # the first longest
        length, j_end = best.gather(1, d)[:, 0], end.gather(1, d)[:, 0]
        d = d[:, 0]
        hit = length >= min_len
        out[a:b] = torch.stack([torch.where(hit, d, 0),
                                torch.where(hit, j_end, 0),
                                torch.where(hit, length, 0)], 1).int()
    return out
